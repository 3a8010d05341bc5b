"""Plan the limits of chip_smoke.py phase 7 with the reference package on
the CPU: the same recipe (chip_smoke.align2d_views: one BLOBS8 view at rot
30, tilt 60 as the clean reference; views at psi uniform on [0, 360),
shifts of +-6 px at N=128 (scaled with N), half mirrored in x, noise of
0.5 sigma of the clean view), through the reference's programs:

  transform_filter --fourier low_pass 0.25
  -> transform_normalize --method NewXmipp --background circle 56*N/128
  -> image_align --ref <clean view> --max_shift 8*N/128 --oaligned
  -> transform_geometry --apply_transform of image_align's rows
  and the reference-free image_align --iter 3 on the normalised stack.

Run from the repo root on a CPU host with jax (the views are evaluated
with torch on the CPU by chip_smoke.py's own functions):

    JAX_PLATFORMS=cpu python tools/plan_align_2d.py [--views 2000] [--n 64]

Prints one JSON line of the numbers phase 7 checks. The reference's
image_align writes psi + 180 and negated shifts on mirrored rows (ROADMAP
§3 item 4), so its rows are read both as written ("raw") and with that
term taken out ("corrected"); the geometry of its rows is checked as
written.
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
    ap.add_argument("--views", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=64)
    args = ap.parse_args()
    N, V = args.n, args.views
    from xmipp3_tpu.core.image import Image, save_image
    from xmipp3_tpu.core.metadata import MetaData
    from xmipp3_tpu.ops.align import align_considering_mirrors
    from xmipp3_tpu.programs import get_program

    clean, views, G, mirror = cs.align2d_views(N, V, args.seed, "cpu")
    max_shift = max(1, round(cs.ALIGN_MAX_SHIFT * N / cs.N))
    radius = cs.ALIGN_BG_RADIUS * N / cs.N
    out = {"N": N, "views": V, "max_shift": max_shift, "bg_radius": radius,
           "seconds": {}}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        f = lambda name: str(d / name)
        save_image(f("clean.xmp"), clean)
        save_image(f("views.mrcs"), views)

        def run(label, name, argv):
            t0 = time.perf_counter()
            assert get_program(name).run_with_args(argv + ["-v", "0"]) == 0
            out["seconds"][label] = time.perf_counter() - t0

        run("filter", "transform_filter",
            ["-i", f("views.mrcs"), "-o", f("filt.mrcs"), "--fourier",
             "low_pass", str(cs.ALIGN_LOWPASS)])
        run("normalise", "transform_normalize",
            ["-i", f("filt.mrcs"), "-o", f("norm.mrcs"), "--method",
             "NewXmipp", "--background", "circle", str(radius)])
        run("align", "image_align",
            ["-i", f("norm.mrcs"), "--ref", f("clean.xmp"), "--max_shift",
             str(max_shift), "-o", f("aligned.xmd"), "--oaligned",
             f("aligned.mrcs")])
        run("geometry", "transform_geometry",
            ["-i", f("aligned.xmd"), "-o", f("geo.mrcs"),
             "--apply_transform"])
        run("reference-free align", "image_align",
            ["-i", f("norm.mrcs"), "--iter", str(cs.ALIGN_FREE_ITERS),
             "--max_shift", str(max_shift), "-o", f("free.xmd"),
             "--oaligned", f("free.mrcs")])
        load = lambda name: np.squeeze(Image(f(name)).data)

        filt = load("filt.mrcs")
        want = cs.lowpass_numpy(views[:64], cs.ALIGN_LOWPASS)
        out["filter_vs_numpy"] = float(np.abs(filt[:64] - want).max()
                                       / np.abs(want).max())
        norm = load("norm.mrcs")
        c = np.arange(N) - N // 2
        bg = np.hypot(c[:, None], c[None, :]) > radius
        out["background_mean"] = float(norm[:, bg].mean(1).mean())
        out["background_std"] = float(norm[:, bg].std(1).mean())

        md = MetaData(f("aligned.xmd"))
        rows = [md.getRow(i) for i in md]
        for key, fix in (("raw", False), ("corrected", True)):
            if fix:
                for r in rows:
                    if r["flip"]:
                        r["anglePsi"] = float(r["anglePsi"]) - 180.0
                        r["shiftX"] = -float(r["shiftX"])
                        r["shiftY"] = -float(r["shiftY"])
            ok, psi_err, shift_err = cs.registration_errors(rows, G, mirror)
            out[key] = {
                "flip_right": float(ok.mean()),
                "psi_within_2_deg": float((psi_err[ok] <= cs.ALIGN_PSI_DEG)
                                          .sum() / V),
                "median_psi_err_deg": float(np.median(psi_err[ok])),
                "median_shift_err_px": float(np.median(shift_err[ok]))}
        aligned_avg = load("aligned.mrcs").mean(0)
        geo_avg = load("geo.mrcs").mean(0)
        free_avg = load("free_avg.mrcs")
        out["geo_vs_aligned_avg"] = cs.stack_corr(geo_avg, aligned_avg)
        out["aligned_avg_vs_clean"] = cs.stack_corr(aligned_avg, clean)
        out["geo_avg_vs_clean"] = cs.stack_corr(geo_avg, clean)
        res = align_considering_mirrors(clean, free_avg[None], n_iters=3,
                                        max_shift=max_shift)
        out["free_avg_vs_clean"] = float(np.asarray(res[4])[0])
        out["free_avg_mirrored"] = bool(np.asarray(res[3])[0])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
