"""Plan the limits of chip_smoke.py phase 6 with the reference package on
the CPU: the same CTF recipe (chip_smoke.ctf_recipe / plant_ctf: 20
micrographs, defocusU 8,000-20,000 A, 300 A astigmatism, 300 kV, Cs 2.7 mm,
Q0 0.1, 2 A/px, noise of 0.5 sigma after the CTF) at N=64, through the
reference's programs:

  reconstruct_fourier --useCTF --sampling 2 on the clean CTF views at their
    true poses (ctfModel files), and the same without --useCTF;
  ctf_phase_flip -> angular_projection_matching --phase_flipped --ctf
    <middle micrograph> --max_shift 4 --batch 512 against a 5-degree gallery
    -> reconstruct_fourier --useCTF --phaseFlipped --sampling 2
    --prepare_fsc -> resolution_fsc on the halves;
  reconstruct_fourier --useCTF --phaseFlipped of the phase-flipped views at
    their true poses (the reconstruction's share of the closing map's
    error, without the matching's);
  ctf_correct_wiener2d --pad 2 on 512 noisy views.

Run from the repo root on a CPU host with jax (the port's numpy helpers
come from chip_smoke.py):

    JAX_PLATFORMS=cpu python tools/plan_ctf_cycle.py [--views 2000]
        [--n 64] [--no-matching] [--min-ctf 0.01,0.1,...]

--no-matching stops after the reconstructions from true poses (the
closing map's ceiling), which is what a run at phase 6's own size
(--n 128 --views 10000) can afford on a CPU. --assignment <xmd> (at phase
6's size and seed, whose views this script makes bit for bit) phase-flips
the views and reconstructs them with the reference at the poses of
another run's assignment (the port's, from phase 6), and does nothing
else. --min-ctf lists the --minCTF values that every --useCTF
reconstruction runs at (the reference's default, 0.01, when not given):
the views, the phase flip and the matching are made once, and each value's
maps are reported under "minCTF <value>".

Prints one JSON line of the quality numbers phase 6 checks.
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
    ap.add_argument("--no-matching", action="store_true")
    ap.add_argument("--assignment", default="")
    ap.add_argument("--min-ctf", default="0.01",
                    help="comma-separated --minCTF values of the --useCTF "
                         "reconstructions")
    args = ap.parse_args()
    min_ctfs = [float(v) for v in args.min_ctf.split(",")]
    N = args.n
    from xmipp3_tpu.core.image import Image, save_image
    from xmipp3_tpu.core.metadata import MetaData
    from xmipp3_tpu.ops.ctf import CTFDescription
    from xmipp3_tpu.programs import get_program

    V, per = args.views, args.views // cs.CTF_GROUPS
    blobs = [(cz * N / cs.N, cy * N / cs.N, cx * N / cs.N, s, a)
             for cz, cy, cx, s, a in cs.BLOBS8]
    ref = cs.phantom(N, blobs)
    rng = np.random.default_rng(args.seed + 3)
    rot = rng.uniform(0, 360, V)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, V)))
    psi = rng.uniform(0, 360, V)
    sx, sy = rng.uniform(-3, 3, (2, V))
    clean = cs.projections(N, rot, tilt, psi, sx, sy, blobs, device="cpu")
    ctf_clean = cs.ctf_stack(clean)
    noisy = ctf_clean + (0.5 * ctf_clean.std()) * np.random.default_rng(
        args.seed + 5).standard_normal(ctf_clean.shape, dtype=np.float32)
    out = {"N": N, "views": V}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        save_image(str(d / "phantom.vol"), ref)
        save_image(str(d / "clean.mrcs"), ctf_clean)
        save_image(str(d / "noisy.mrcs"), noisy)
        models = []
        for g, (u, v, az) in enumerate(zip(*cs.ctf_recipe())):
            models.append(str(d / f"mic{g:02d}.ctfparam"))
            CTFDescription(sampling_rate=cs.CTF_TS, voltage=cs.CTF_KV,
                           defocusU=float(u), defocusV=float(v),
                           azimuthal_angle=float(az), Cs=cs.CTF_CS,
                           Q0=cs.CTF_Q0).write(models[-1])
        pose = lambda i: {"angleRot": float(rot[i]),
                          "angleTilt": float(tilt[i]),
                          "anglePsi": float(psi[i]), "shiftX": float(sx[i]),
                          "shiftY": float(sy[i])}
        MetaData.fromRows({"image": f"{i + 1}@{d}/clean.mrcs", **pose(i),
                           "ctfModel": models[i // per]}
                          for i in range(V)).write(str(d / "true.xmd"))
        MetaData.fromRows({"image": f"{i + 1}@{d}/noisy.mrcs", "itemId": i + 1,
                           "ctfModel": models[i // per]}
                          for i in range(V)).write(str(d / "noisy.xmd"))
        MetaData.fromRows({"image": f"{i + 1}@{d}/flipped.mrcs", **pose(i),
                           "ctfModel": models[i // per]}
                          for i in range(V)).write(str(d / "flip_true.xmd"))
        MetaData.fromRows({"image": f"{i + 1}@{d}/noisy.mrcs",
                           "ctfModel": models[i // per]}
                          for i in range(min(cs.WIENER_VIEWS, V))).write(
            str(d / "wiener_in.xmd"))

        def run(name, argv):
            t0 = time.perf_counter()
            assert get_program(name).run_with_args(argv + ["-v", "0"]) == 0
            out.setdefault("seconds", {})[name + " " + " ".join(argv[2:4])
                                          + " " + argv[-1]] = \
                time.perf_counter() - t0

        def quality(vol):
            rec = np.squeeze(Image(str(vol)).data)
            a, b = rec - rec.mean(), ref - ref.mean()
            from xmipp3_tpu.ops.fsc import fsc_3d
            _, fsc = fsc_3d(rec, ref)
            fsc = np.asarray(fsc)
            return {"corr": float((a * b).sum() / np.sqrt((a * a).sum()
                                                          * (b * b).sum())),
                    "fsc_min_to_half_nyquist":
                        float(fsc[: len(fsc) // 2].min())}

        sampling = ["--sampling", str(cs.CTF_TS)]
        if args.assignment:
            run("ctf_phase_flip", ["-i", f"{d}/noisy.xmd", "-o",
                                   f"{d}/flipped.mrcs"])
            got = MetaData(args.assignment)
            keys = ("angleRot", "angleTilt", "anglePsi", "shiftX", "shiftY",
                    "flip")
            MetaData.fromRows(
                {"image": f"{int(r['itemId'])}@{d}/flipped.mrcs",
                 "ctfModel": models[(int(r["itemId"]) - 1) // per],
                 **{k: r[k] for k in keys}}
                for r in (got.getRow(i) for i in got)).write(
                str(d / "assigned.xmd"))
            for m in min_ctfs:
                run("reconstruct_fourier", ["-i", f"{d}/assigned.xmd", "-o",
                                            f"{d}/a.vol", "--mesh", "none",
                                            "--useCTF", "--phaseFlipped",
                                            "--minCTF", str(m)] + sampling)
                out[f"minCTF {m}"] = {
                    "reference_map_of_the_assignment": quality(d / "a.vol")}
            print(json.dumps(out))
            return 0
        run("reconstruct_fourier", ["-i", f"{d}/true.xmd", "-o",
                                    f"{d}/t0.vol", "--mesh", "none"])
        out["true_no_usectf"] = quality(d / "t0.vol")
        run("ctf_phase_flip", ["-i", f"{d}/noisy.xmd", "-o",
                               f"{d}/flipped.mrcs", "--save_metadata_stack",
                               f"{d}/flipped.xmd"])
        for m in min_ctfs:
            mc = ["--minCTF", str(m)] + sampling
            run("reconstruct_fourier", ["-i", f"{d}/true.xmd", "-o",
                                        f"{d}/t.vol", "--mesh", "none",
                                        "--useCTF"] + mc)
            run("reconstruct_fourier", ["-i", f"{d}/flip_true.xmd", "-o",
                                        f"{d}/ft.vol", "--mesh", "none",
                                        "--useCTF", "--phaseFlipped"] + mc)
            out[f"minCTF {m}"] = {"true_usectf": quality(d / "t.vol"),
                                  "flipped_true_poses": quality(d / "ft.vol")}
        if args.no_matching:
            print(json.dumps(out))
            return 0
        run("angular_project_library", ["-i", f"{d}/phantom.vol", "-o",
                                        f"{d}/gallery", "--sampling_rate",
                                        str(cs.GALLERY_RATE)])
        run("angular_projection_matching", [
            "-i", f"{d}/flipped.xmd", "-o", f"{d}/assigned.xmd", "--ref",
            f"{d}/gallery", "--max_shift", str(cs.MATCH_SHIFT), "--batch",
            str(cs.MATCH_BATCH), "--mesh", "none", "--phase_flipped",
            "--ctf", models[cs.CTF_GROUPS // 2]])
        md = MetaData(f"{d}/assigned.xmd")
        rows = [md.getRow(i) for i in md]
        col = lambda k: np.array([float(r[k]) for r in rows])
        order = col("itemId").astype(int) - 1
        from xmipp3_tpu.core.sampling import directions_from_angles
        d_true = directions_from_angles(np.stack([rot, tilt], 1))[order]
        d_got = directions_from_angles(np.stack([col("angleRot"),
                                                 col("angleTilt")], 1))
        d_got = np.where((col("flip") > 0)[:, None], -d_got, d_got)
        ang = np.degrees(np.arccos(np.clip((d_true * d_got).sum(1), -1, 1)))
        out["matching"] = {
            "within_7.5_deg": float((ang <= 1.5 * cs.GALLERY_RATE).mean()),
            "median_angle_deg": float(np.median(ang)),
            "median_shift_err_px": float(np.median(np.hypot(
                col("shiftX") - sx[order], col("shiftY") - sy[order])))}
        for m in min_ctfs:
            run("reconstruct_fourier", ["-i", f"{d}/assigned.xmd", "-o",
                                        f"{d}/cycle.vol", "--mesh", "none",
                                        "--useCTF", "--phaseFlipped",
                                        "--minCTF", str(m), "--prepare_fsc",
                                        f"{d}/half"] + sampling)
            prog = get_program("resolution_fsc")
            assert prog.run_with_args(["-i", f"{d}/half_2_recons.vol",
                                       "--ref", f"{d}/half_1_recons.vol",
                                       "-s", str(cs.CTF_TS), "-o",
                                       f"{d}/h.frc", "-v", "0"]) == 0
            out[f"minCTF {m}"]["cycle"] = dict(
                quality(d / "cycle.vol"),
                **{"halves_resolution_0.143_A": prog.resolution})
        run("ctf_correct_wiener2d", ["-i", f"{d}/wiener_in.xmd", "-o",
                                     f"{d}/w.mrcs", "--pad", "2"])
        w = np.squeeze(Image(f"{d}/w.mrcs").data)
        k = min(cs.WIENER_VIEWS, V)

        def mean_corr(a, b):
            a = a.reshape(len(a), -1) - a.reshape(len(a), -1).mean(1)[:, None]
            b = b.reshape(len(b), -1) - b.reshape(len(b), -1).mean(1)[:, None]
            return float(((a * b).sum(1) / np.sqrt((a * a).sum(1)
                                                   * (b * b).sum(1))).mean())
        out["wiener"] = {"corr_raw": mean_corr(noisy[:k], clean[:k]),
                         "corr_corrected": mean_corr(w, clean[:k])}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
