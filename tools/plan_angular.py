"""Plan the quality limits of chip_smoke.py phase 12 with the reference
package on the CPU: the same recipes (chip_smoke's helpers) through the
reference's programs, at a smaller size.

- Phase 12's phantom description at --n (angular_descr) through
  phantom_create and phantom_project --nangles --views, Fourier and
  --method real_space: the median correlation of each real-space view
  with its Fourier view.
- Phase 4's recipe at --n (the 8-blob phantom with its centres scaled,
  --views views at uniform poses, shifts of +-3 px, noise of 0.5 sigma;
  the seed's draws), the reference's 5-degree gallery and its
  angular_projection_matching --max_shift 4 and reconstruct_fourier: the
  starting assignment (flipped rows turned into their unflipped poses,
  chip_smoke.unflipped_rows) through angular_continuous_assign2
  (--optimizeAngles --optimizeShift; with --optimizeGray on the first
  --subset views) and angular_continuous_assign --optimizeShift (the
  first --subset views): median rotation and shift errors against the
  truth; angular_discrete_assign (--shift_step 2
  --number_orientations 3, with every gallery direction kept by the
  preselection and every in-plane angle searched, and with its defaults on
  the first --subset views) and angular_assignment_mag (--refVol, -angleStep 5): the share
  within 7.5 degrees; angular_class_average: the
  median correlation of the averages of at least 3 views with their
  gallery image; multireference_aligneability --sampling 5: the median
  accuracy weight; validation_nontilt on the discrete clouds of the first
  --subset views: its score; compare_views of the phantom and the cycle's
  map at 10 degrees: the median correlation; continuous_create_residuals
  --optimizeShift on the first --subset views: the residuals' energy over
  the views'.
- Phase 6's recipe at --n (20 planted CTFs at 2 A/px, noise of 0.5 sigma
  after them) at the true poses through subtract_projection --sampling 2:
  the energy left inside r < 0.45 n over the views'.
- chip_smoke.ssnr_set at --n through resolution_ssnr: the median S_SSNR
  over the low-frequency rows; chip_smoke.commonline_set (24 views at 64
  px, as phase 12 runs it) through angular_commonline --NGen 1000
  --NGroup 2: its energy.

Run from the repo root on a CPU host with jax:

    JAX_PLATFORMS=cpu python tools/plan_angular.py [--n 64] [--views 1000]
        [--subset 500] [--seed 0]

Prints one JSON line of the readings and the limits: a correlation-like
reading r gives 1 - 2 (1 - r), an error or a left-over energy e gives 2 e,
the SSNR and the common-line energy half the reading. These are readings
of the reference package's quality on a CPU, never a time of the port.
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
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--views", type=int, default=1000)
    ap.add_argument("--subset", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    from xmipp3_tpu.core.image import Image, save_image
    from xmipp3_tpu.core.metadata import MetaData
    from xmipp3_tpu.programs import get_program

    n, V, S, seed = args.n, args.views, args.subset, args.seed
    read, seconds = {}, {}

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        f = lambda name: str(root / name)

        def run(label, name, argv):
            t0 = time.perf_counter()
            prog = get_program(name)
            rc = prog.run_with_args([str(a) for a in argv] + ["-v", "0"])
            assert rc == 0, (label, rc)
            seconds[label] = time.perf_counter() - t0
            return prog

        def md_rows(fn):
            md = MetaData(str(fn))
            return [md.getRow(i) for i in md]

        stack = lambda name: Image.read_stack(f(name))

        # phantoms and projection
        Path(f("ph.descr")).write_text(cs.angular_descr(n))
        run("phantom_create", "phantom_create", ["-i", f("ph.descr"), "-o",
                                                 f("ph.vol")])
        for label, extra in (("pf", []), ("pr", ["--method", "real_space"])):
            run(f"project_{label}", "phantom_project",
                ["-i", f("ph.descr"), "-o", f(f"{label}.stk"), "--nangles",
                 V, "--xdim", n, "--seed", seed, *extra])
        read["real_vs_fourier_corr"] = float(np.median(cs.image_corrs(
            stack("pr.stk"), stack("pf.stk"))))

        # phase 4's recipe at n
        blobs = cs.scaled_blobs(cs.BLOBS8, n)
        ref = cs.phantom(n, blobs)
        save_image(f("phantom.vol"), ref)
        rng = np.random.default_rng(seed + 3)
        rot = rng.uniform(0, 360, V)
        tilt = np.degrees(np.arccos(rng.uniform(-1, 1, V)))
        psi = rng.uniform(0, 360, V)
        sx, sy = rng.uniform(-3, 3, (2, V))
        poses = dict(rot=rot, tilt=tilt, psi=psi, sx=sx, sy=sy)
        clean = cs.projections(n, rot, tilt, psi, sx, sy, blobs,
                               device="cpu")
        save_image(f("views.mrcs"), clean + (0.5 * clean.std())
                   * rng.standard_normal(clean.shape, dtype=np.float32))
        MetaData.fromRows({"image": f"{i + 1}@{f('views.mrcs')}",
                           "itemId": i + 1} for i in range(V)).write(
                               f("views.xmd"))
        run("gallery", "angular_project_library",
            ["-i", f("phantom.vol"), "-o", f("gallery"), "--sampling_rate",
             cs.GALLERY_RATE])
        run("matching", "angular_projection_matching",
            ["-i", f("views.xmd"), "-o", f("assigned.xmd"), "--ref",
             f("gallery"), "--max_shift", cs.MATCH_SHIFT, "--mesh", "none"])
        run("reconstruct", "reconstruct_fourier",
            ["-i", f("assigned.xmd"), "-o", f("cycle.vol"), "--mesh", "none"])
        rows4 = md_rows(f("assigned.xmd"))
        start = cs.unflipped_rows(rows4)
        MetaData.fromRows(start).write(f("cont_in.xmd"))
        read["phase4_errors"] = cs.pose_errors(start, poses)
        MetaData.fromRows(start[:S]).write(f("cont_sub.xmd"))
        read["phase4_subset_errors"] = cs.pose_errors(start[:S], poses)
        for label, name, inp, extra in (
                ("pose", "angular_continuous_assign2", "cont_in.xmd",
                 ["--optimizeAngles", "--optimizeShift"]),
                ("full", "angular_continuous_assign2", "cont_sub.xmd",
                 ["--optimizeAngles", "--optimizeShift", "--optimizeGray"]),
                ("wavelet", "angular_continuous_assign", "cont_sub.xmd",
                 ["--optimizeShift"])):
            run(f"continuous_{label}", name,
                ["-i", f(inp), "-o", f(f"c_{label}.xmd"), "--ref",
                 f("phantom.vol"), *extra])
            read[f"continuous_{label}"] = cs.pose_errors(
                md_rows(f(f"c_{label}.xmd")), poses)
        da_args = ["--ref", f("gallery.doc"), "--max_shift", cs.MATCH_SHIFT,
                   "--shift_step", cs.ANG_SHIFT_STEP, "--number_orientations",
                   cs.ANG_ORIENTATIONS, "--mesh", "none"]
        run("discrete", "angular_discrete_assign",
            ["-i", f("views.xmd"), "-o", f("da.xmd"), *da_args,
             *cs.ANG_DA_FLAGS])
        MetaData.fromRows(md_rows(f("views.xmd"))[:S]).write(
            f("views_sub.xmd"))
        run("discrete_default", "angular_discrete_assign",
            ["-i", f("views_sub.xmd"), "-o", f("da_default.xmd"), *da_args])
        run("mag", "angular_assignment_mag",
            ["-i", f("views.xmd"), "-o", f("mag.xmd"), "--refVol",
             f("phantom.vol"), "-angleStep", cs.GALLERY_RATE, "-odir",
             f("magdir"), "--maxShift", cs.MATCH_SHIFT, "--mesh", "none"])
        da = md_rows(f("da.xmd"))
        read["discrete_within"] = cs.directions_within(
            cs.first_orientation(da, cs.ANG_ORIENTATIONS), poses,
            cs.GALLERY_RATE)
        read["discrete_default_within"] = cs.directions_within(
            cs.first_orientation(md_rows(f("da_default.xmd")),
                                 cs.ANG_ORIENTATIONS), poses,
            cs.GALLERY_RATE)
        read["mag_within"] = cs.directions_within(md_rows(f("mag.xmd")),
                                                  poses, cs.GALLERY_RATE)
        run("class_average", "angular_class_average",
            ["-i", f("assigned.xmd"), "--lib", f("gallery.doc"), "-o",
             f("ca"), "--split", "--mesh", "none"])
        counts = np.array([r["classCount"] for r in md_rows(f("ca.xmd"))])
        big = counts >= cs.ANG_CA_MIN
        read["class_average_corr"] = float(np.median(cs.image_corrs(
            stack("ca.stk")[big], stack("gallery.stk")[big])))
        prog = run("aligneability", "multireference_aligneability",
                   ["-i", f("assigned.xmd"), "--volume", f("phantom.vol"),
                    "--sampling", cs.GALLERY_RATE, "-o", f("mra.xmd")])
        read["aligneability_acc"] = float(np.median(
            [r["weightAlignabilityAccuracy"] for r in md_rows(f("mra.xmd"))]))
        MetaData.fromRows(da[:cs.ANG_ORIENTATIONS * S]).write(f("clouds.xmd"))
        (root / "vnt").mkdir()
        prog = run("validation_nontilt", "validation_nontilt",
                   ["--i", f("clouds.xmd"), "--gallery", f("gallery.doc"),
                    "--odir", f("vnt")])
        read["nontilt_score"] = float(prog.score)
        prog = run("compare_views", "compare_views",
                   ["-v1", f("phantom.vol"), "-v2", f("cycle.vol"), "-o",
                    f("cv.xmp"), "--degstep", 2 * cs.GALLERY_RATE])
        read["compare_views_corr"] = float(np.median(prog.corr_image))
        MetaData.fromRows(start[:S]).write(f("ccr_in.xmd"))
        run("create_residuals", "continuous_create_residuals",
            ["-i", f("ccr_in.xmd"), "-o", f("ccr.xmd"), "--ref",
             f("phantom.vol"), "--optimizeShift", "--oresiduals",
             f("ccr.stk")])
        ids = np.array([int(r["itemId"]) for r in start[:S]])
        read["residual_ratio"] = float(
            (stack("ccr.stk").astype(np.float64) ** 2).sum()
            / (stack("views.mrcs")[ids - 1].astype(np.float64) ** 2).sum())

        # phase 6's recipe at n, at the true poses
        ctf_views = cs.ctf_stack(clean)
        rng = np.random.default_rng(seed + 5)
        ctf_views += (0.5 * ctf_views.std()) * rng.standard_normal(
            ctf_views.shape, dtype=np.float32)
        save_image(f("ctf.mrcs"), ctf_views)
        per = -(-V // cs.CTF_GROUPS)
        descs = list(zip(*cs.ctf_recipe()))
        MetaData.fromRows(
            {"image": f"{i + 1}@{f('ctf.mrcs')}", "itemId": i + 1,
             "angleRot": float(rot[i]), "angleTilt": float(tilt[i]),
             "anglePsi": float(psi[i]), "shiftX": float(sx[i]),
             "shiftY": float(sy[i]), "ctfSamplingRate": cs.CTF_TS,
             "ctfVoltage": cs.CTF_KV, "ctfDefocusU": float(descs[i // per][0]),
             "ctfDefocusV": float(descs[i // per][1]),
             "ctfDefocusAngle": float(descs[i // per][2]),
             "ctfSphericalAberration": cs.CTF_CS, "ctfQ0": cs.CTF_Q0}
            for i in range(V)).write(f("sub_in.xmd"))
        run("subtract_projection", "subtract_projection",
            ["-i", f("sub_in.xmd"), "--ref", f("phantom.vol"), "-o", f("sub"),
             "--sampling", cs.CTF_TS])
        read["subtraction_energy"] = cs.masked_energy(
            stack("sub.mrcs"), cs.ANG_SUB_RADIUS * n) / cs.masked_energy(
                ctf_views, cs.ANG_SUB_RADIUS * n)

        # SSNR and common lines
        simg, nimg, nvol, srot, stilt, spsi = cs.ssnr_set(seed, S, n, ref,
                                                          "cpu")
        save_image(f("ssnr_s.mrcs"), simg)
        save_image(f("ssnr_n.mrcs"), nimg)
        save_image(f("noise.vol"), nvol)
        for tag in "sn":
            MetaData.fromRows(
                {"image": f"{i + 1}@{f(f'ssnr_{tag}.mrcs')}",
                 "angleRot": float(srot[i]), "angleTilt": float(stilt[i]),
                 "anglePsi": float(spsi[i])} for i in range(S)).write(
                     f(f"ssnr_{tag}.xmd"))
        prog = run("resolution_ssnr", "resolution_ssnr",
                   ["--signal", f("phantom.vol"), "--noise", f("noise.vol"),
                    "--sel_signal", f("ssnr_s.xmd"), "--sel_noise",
                    f("ssnr_n.xmd"), "-o", f("ssnr.txt")])
        read["ssnr_low"] = cs.ssnr_quality(np.asarray(prog.ssnr_table), n)
        save_image(f("cl.mrcs"), cs.commonline_set(seed, "cpu"))
        MetaData.fromRows({"image": f"{i + 1}@{f('cl.mrcs')}"}
                          for i in range(cs.ANG_CL[0])).write(f("cl_in.xmd"))
        run("commonline", "angular_commonline",
            ["-i", f("cl_in.xmd"), "--oang", f("cl.xmd"), "--NGen", 1000,
             "--NGroup", 2])
        read["commonline_energy"] = float(md_rows(f("cl.xmd"))[0]["cost"])

    corr = lambda r: 1 - 2 * (1 - r)
    limits = {
        "ANG_REAL_CORR": corr(read["real_vs_fourier_corr"]),
        "ANG_ROT_DEG": {k: 2 * read[f"continuous_{k}"][0]
                        for k in ("pose", "full", "wavelet")},
        "ANG_SHIFT_PX": {k: 2 * read[f"continuous_{k}"][1]
                         for k in ("pose", "full", "wavelet")},
        "ANG_CA_CORR": corr(read["class_average_corr"]),
        "ANG_SUB_ENERGY": 2 * read["subtraction_energy"],
        "ANG_MRA_ACC": corr(read["aligneability_acc"]),
        "ANG_VNT_SCORE": corr(read["nontilt_score"]),
        "ANG_CV_CORR": corr(read["compare_views_corr"]),
        "ANG_SSNR": read["ssnr_low"] / 2,
        "ANG_CCR_RATIO": 2 * read["residual_ratio"],
        "ANG_CL_ENERGY": read["commonline_energy"] / 2}
    print(json.dumps({"n": n, "views": V, "subset": S, "seed": seed,
                      "reference": read, "limits": limits,
                      "seconds": seconds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
