"""Plan the limits of chip_smoke.py phase 9 with the reference package on
the CPU: the same recipe (chip_smoke's phase 9 helpers) through the
reference's programs, at a reduced size.

Movie: phantom_movie -size S S 40 --seed (ice, dose and barrel distortion
at the program's defaults) -> movie_alignment_correlation with its
defaults (local alignment on 7 x 7 patches, --patchesAvg 3) and --oavg
--oavgInitial; the global positions against the _gt.xmd truth (gauge:
mean 0) and the aligned average's power in chip_smoke.MOVIE_BAND over
the initial one's. Gain: phantom_movie at chip_smoke.MOVIE_GAIN_DOSE with
chip_smoke.MOVIE_GAIN_FRAMES frames, chip_smoke.movie_gain planted on it
-> movie_estimate_gain --frameStep chip_smoke.MOVIE_GAIN_STEP; the
correlation of the estimated inverse gain with 1 / the planted one.

Volumes: chip_smoke.mono_halves at n^3 (the same digital frequencies and
relative zone radii as the phase's 256^3 at 1 A/px, so n = 128 is 2 A/px)
-> resolution_monogenic_signal --vol --vol2 --mask: the median local
resolution of each zone over its planted value; resolution_fso on
chip_smoke.fso_pairs (isotropic and anisotropic): the width in cycles/px
of the shells with 0.1 < FSO < 0.9; resolution_monotomo on the central
slab of the halves: its median in
the mask; resolution_directional at --dir-n^3: its mean resolution in the
inner and the outer zone.

The defaults are a 1024^2 movie of 40 frames (a quarter of the phase's
frame side: the same patch grid, patches of 256 px, and a correlation
grid of 512, so a quarter of the frame per patch) and 128^3 maps; the
run takes a few minutes and a few GB.

Run from the repo root on a CPU host with jax:

    JAX_PLATFORMS=cpu python tools/plan_movie_monores.py [--size 1024]
        [--n 128] [--dir-n 64] [--seed 0]

Prints one JSON line of the readings and the limits that twice the
reference's shortfall gives (errors x 2; ratios and correlations with
twice the distance to their ideal). Position errors are also read in
samples of the alignment's correlation grid (min(512, S) a side, so
S / 512 px a sample): a peak's sub-sample error is what the grid leaves,
and the phase's limits in px are twice the per-sample errors times
chip_smoke.MOVIE_SIZE / 512.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=cs.MOVIE_FRAMES)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--dir-n", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    from xmipp3_tpu.core.image import Image, save_image
    from xmipp3_tpu.core.metadata import MetaData
    from xmipp3_tpu.programs import get_program

    out = {"size": args.size, "frames": args.frames, "n": args.n,
           "dir_n": args.dir_n, "seed": args.seed, "seconds": {}}
    load = lambda fn: np.squeeze(Image(str(fn)).data)

    def run(label, name, argv):
        t0 = time.perf_counter()
        prog = get_program(name)
        assert prog.run_with_args([str(a) for a in argv] + ["-v", "0"]) == 0
        out["seconds"][label] = time.perf_counter() - t0
        return prog

    def shifts(fn):
        md = MetaData(str(fn))
        return np.stack([md.getColumn("shiftX"), md.getColumn("shiftY")], 1)

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        S, F = args.size, args.frames
        run("phantom_movie", "phantom_movie",
            ["-o", d / "movie.mrcs", "-size", S, S, F, "--seed", args.seed])
        run("align", "movie_alignment_correlation",
            ["-i", d / "movie.mrcs", "-o", d / "sh.xmd", "--oavg",
             d / "avg.mrc", "--oavgInitial", d / "avg0.mrc"])
        med, worst = cs.position_errors(shifts(d / "sh.xmd"),
                                        shifts(d / "movie_gt.xmd"))
        sharpen = cs.band_power(load(d / "avg.mrc")) / \
            cs.band_power(load(d / "avg0.mrc"))
        scale = S / min(512, S)                  # px a correlation sample
        out["movie"] = {"pos_median_px": med, "pos_worst_px": worst,
                        "pos_median_samples": med / scale,
                        "pos_worst_samples": worst / scale,
                        "band_power_ratio": sharpen}
        run("phantom_movie_gain", "phantom_movie",
            ["-o", d / "gm.mrcs", "-size", S, S, cs.MOVIE_GAIN_FRAMES,
             "--seed", args.seed, "--dose", cs.MOVIE_GAIN_DOSE])
        gain = cs.movie_gain(S, S, args.seed)
        save_image(str(d / "gained.mrcs"),
                   Image.read_stack(str(d / "gm.mrcs")) * gain[None])
        prog = run("gain", "movie_estimate_gain",
                   ["-i", d / "gained.mrcs", "--oroot", d / "g",
                    "--frameStep", cs.MOVIE_GAIN_STEP])
        out["movie"]["gain_corr"] = float(np.corrcoef(
            prog.gain.ravel(), (1.0 / gain).ravel())[0, 1])

        n = args.n
        halves, mask, zones, Ts = cs.mono_halves(n, args.seed)
        for k, h in enumerate(halves):
            save_image(str(d / f"h{k + 1}.vol"), h)
        save_image(str(d / "mask.vol"), mask.astype(np.float32))
        run("monores", "resolution_monogenic_signal",
            ["--vol", d / "h1.vol", "--vol2", d / "h2.vol", "--mask",
             d / "mask.vol", "-o", d / "mr.vol", "--sampling_rate", Ts])
        out["monores"] = cs.zone_medians(load(d / "mr.vol"), zones, Ts)
        spans = {}
        for key, pair in cs.fso_pairs(n, args.seed).items():
            for k, h in enumerate(pair):
                save_image(str(d / f"{key}{k + 1}.vol"), h)
            run(f"fso_{key}", "resolution_fso",
                ["--half1", d / f"{key}1.vol", "--half2", d / f"{key}2.vol",
                 "-o", d / f"fso_{key}.xmd", "--sampling", Ts])
            spans[key] = cs.fso_span(MetaData(str(d / f"fso_{key}.xmd"))
                                     .getColumn("resolutionFRC"))
        out["fso_span"] = spans
        k = cs.MONO_TOMO_SLAB * n // cs.MONO_N
        sl = slice(n // 2 - k // 2, n // 2 + k // 2)
        for name, v in (("t1", halves[0][sl]), ("t2", halves[1][sl]),
                        ("tmask", mask[sl].astype(np.float32))):
            save_image(str(d / f"{name}.vol"), v)
        prog = run("monotomo", "resolution_monotomo",
                   ["--vol", d / "t1.vol", "--vol2", d / "t2.vol", "--mask",
                    d / "tmask.vol", "-o", d / "mt.vol", "--sampling_rate",
                    Ts])
        out["monotomo_median_A"] = prog.median_resolution

        m = args.dir_n
        dh, dmask, dzones, dTs = cs.mono_halves(m, args.seed)
        save_image(str(d / "dvol.vol"), 0.5 * (dh[0] + dh[1]))
        save_image(str(d / "dmask.vol"), dmask.astype(np.float32))
        run("directional", "resolution_directional",
            ["--vol", d / "dvol.vol", "--mask", d / "dmask.vol", "--oroot",
             d / "md", "--sampling_rate", dTs])
        mres = load(d / "md_monores.vol")
        out["directional"] = {"inner_mean_A": float(mres[dzones[0]].mean()),
                              "outer_mean_A": float(mres[dzones[-1]].mean())}

    mv = out["movie"]
    # the zones' limits are never tighter than one band of the phase's
    # 256^3 sweep; the isotropic span's never tighter than two shells
    chip_scale = cs.MOVIE_SIZE / min(512, cs.MOVIE_SIZE)
    out["limits"] = {
        "pos_median_px": 2 * mv["pos_median_samples"] * chip_scale,
        "pos_worst_px": 2 * mv["pos_worst_samples"] * chip_scale,
        "band_power_ratio": 1 + (mv["band_power_ratio"] - 1) / 2,
        "gain_corr": 1 - 2 * (1 - mv["gain_corr"]),
        "zone_ratio_err": [max(2 * abs(z["ratio"] - 1), t) for z, t in
                           zip(out["monores"], cs.zone_tolerances())],
        "fso_span_iso_max": max(2 * spans["iso"], 2.0 / n),
        "fso_span_aniso_min": spans["aniso"] / 2}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
