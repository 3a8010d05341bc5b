"""Plan the limits of chip_smoke.py phase 13 with the reference package on
the CPU: the phase's recipes (chip_smoke's phase 13 helpers) at --n
through the reference's programs, reading each quality number.

- Heterogeneity: chip_smoke.analysis_hetero_set (two states of the 8-blob
  phantom, one blob moved by 6 px at N=128, scaled to n; 1,000 noisy
  views each) -> classify_first_split (its defaults, --Nrec 100
  --Nsamples 8, with --mask chip_smoke.analysis_mask, a sphere about the
  moved blob): |corr(pc1, the planted difference)| and whether v1 and
  v2 correlate best with different states; classify_first_split3: the
  share of the views in their own state's half.
- Screening: phase 4's recipe at n (2,000 views) through
  chip_smoke.screening_set (1 % outliers at 3x contrast, 500 noise-only
  images) -> image_eliminate_empty_particles -t chip_smoke.AN_EMPTY_T
  (the share of empties eliminated and of particles kept),
  image_sort_by_statistics and image_eliminate_byEnergy (the outliers'
  AUC), image_find_center on the first 1,000 views moved by
  chip_smoke.AN_CENTER x n/N (the error, in px at n), image_ssnr (the
  median SSNR) and image_sort on the first --sort-views views (the
  chain's median neighbour correlation; the reference aligns every
  remaining view at every step on the CPU, so fewer views than the
  phase's 1,000: a shorter chain has fewer close neighbours to pick, so
  its reading is a lower one).
- Dimension reduction: chip_smoke.write_classify_data at n (phase 10's
  2,000 views), the first 1,000 registered by their planted poses and
  downsampled to 32^2 -> image_vectorize -> matrix_dimred -m LTSA --dout
  3 (the share of views nearest their direction's centroid) and -m PCA
  (against numpy's SVD); image_rotational_pca --eigenvectors 8
  --psi_step chip_smoke.AN_RPCA_PSI on 2,000 of the screening views at n
  (the share of the views' variance its basis holds).
- Sketch (phase 13's own data, not scaled to n): phase 4's 10,000 views
  at N=128 (chip_smoke.matching_cycle's recipe), the first 2,000
  Fourier-cropped to 64^2 -> image_rotational_pca --eigenvectors 8 at
  the default --psi_step 15, serially (its randomised sketch above 4e7
  values) and with --mesh dp over two virtual CPU devices (the exact
  eigenbasis): the share of the expanded data's variance that the
  sketch's basis holds over the share that the exact basis holds, and
  the largest principal angle between the two bases.
- Class analysis: classify_extract_features with every extractor on 500
  of phase 10's views at n (each extractor's median coefficient of
  variation), denoising_tv on 512 of the screening views' clean and noisy
  forms (the rms error against the clean views, before and after).

Run from the repo root on a CPU host with jax (about 15 minutes, a few
GB):

    JAX_PLATFORMS=cpu python tools/plan_analysis.py [--n 64]
        [--sort-views 200] [--seed 0]

Each part (hetero, screen, sort, dimred, classes) runs in a process of its
own (`--part` runs one): the reference compiles its programs anew for
every shape, and image_sort's chain gives every step a new one, so one
process for everything ran out of memory for compiled code (LLVM's
"Cannot allocate memory"). The sort part also clears jax's caches before
each of the chain's alignments.

Prints one JSON line of the readings and of the limits: twice the
shortfall of a share, AUC or correlation r (1 - 2 (1 - r)), twice an
error (scaled from n to N=128), half the SSNR and half the variance share
(a share far from 1, held like phase 10's node purity).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PARTS = ("hetero", "screen", "sort", "dimred", "sketch", "classes")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--sort-views", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--part", default="", choices=("", *PARTS))
    args = ap.parse_args()
    if not args.part:
        return run_parts(args)
    from xmipp3_tpu.core.image import Image, save_image
    from xmipp3_tpu.core.metadata import MetaData
    from xmipp3_tpu.programs import get_program
    from xmipp3_tpu_torch.ops.geo import apply_md_geometry
    from xmipp3_tpu_torch.ops.resize import fourier_resize_2d

    n, seed = args.n, args.seed
    read, seconds = {}, {}

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        f = lambda name: str(root / name)

        def run(label, name, argv):
            print(f"plan_analysis: {label}", file=sys.stderr, flush=True)
            t0 = time.perf_counter()
            prog = get_program(name)
            rc = prog.run_with_args([str(a) for a in argv] + ["-v", "0"])
            assert rc == 0, (label, rc)
            seconds[label] = time.perf_counter() - t0
            return prog

        def md_rows(fn):
            md = MetaData(str(fn))
            return [md.getRow(i) for i in md]

        vol = lambda name: np.squeeze(Image(f(name)).data)

        if args.part == "hetero":
            # heterogeneity
            noisy, clean, hp, state = cs.analysis_hetero_set(
                n, cs.AN_STATE_VIEWS, seed, "cpu")
            het = cs.write_views(root, "hetero", noisy, hp)
            vA, vB = (cs.phantom(n, b) for b in cs.analysis_states(n))
            save_image(f("het_mask.vol"), cs.analysis_mask(n))
            run("first_split", "classify_first_split",
                ["-i", het, "--oroot", f("split"), "--mask", "binary_file",
                 f("het_mask.vol")])
            v1, v2 = vol("split_v1.vol"), vol("split_v2.vol")
            read["pc1_corr"] = abs(cs.real_corr(vol("split_pc1.vol"), vB - vA))
            c = [[cs.real_corr(v, s) for s in (vA, vB)] for v in (v1, v2)]
            read["v_state_corr"] = c
            read["states_differ"] = bool((c[0][0] > c[0][1])
                                         != (c[1][0] > c[1][1]))
            run("first_split3", "classify_first_split3",
                ["-i", het, "--oroot", f("s3")])
            in1 = np.zeros(len(state), bool)
            in1[[int(r["itemId"]) - 1 for r in md_rows(f("s3_avg1.xmd"))]] = True
            agree = float((in1 == (state == 0)).mean())
            read["split3_share"] = max(agree, 1.0 - agree)

        # screening on phase 4's recipe at n
        blobs = cs.scaled_blobs(cs.BLOBS8, n)
        rng = np.random.default_rng(seed + 3)
        V = cs.AN_SCREEN_VIEWS
        rot = rng.uniform(0, 360, V)
        tilt = np.degrees(np.arccos(rng.uniform(-1, 1, V)))
        psi = rng.uniform(0, 360, V)
        sx, sy = rng.uniform(-3, 3, (2, V))
        clean4 = cs.projections(n, rot, tilt, psi, sx, sy, blobs,
                                device="cpu")
        views4 = clean4 + (0.5 * clean4.std()) * rng.standard_normal(
            clean4.shape, dtype=np.float32)
        if args.part == "screen":
            scr, outl, empty = cs.screening_set(views4, seed)
            scr_md = cs.write_views(root, "screen", scr)
            prog = run("empty", "image_eliminate_empty_particles",
                       ["-i", scr_md, "-o", f("kept.xmd"), "-e", f("elim.xmd"),
                        "-t", cs.AN_EMPTY_T])
            elim = prog.ratio <= cs.AN_EMPTY_T
            read["empty_eliminated"] = float(elim[empty].mean())
            read["particles_kept"] = float((~elim[~empty]).mean())
            part = cs.write_views(root, "part", scr[:V])
            prog = run("sort_by_statistics", "image_sort_by_statistics",
                       ["-i", part, "-o", f("stats.xmd")])
            read["stats_auc"] = cs.auc_upper(prog.zscores, outl)
            sigma20 = float(np.median(scr[:V][~outl].var(axis=(1, 2))))
            run("by_energy", "image_eliminate_byEnergy",
                ["-i", part, "-o", f("energy.xmd"), "--confidence",
                 cs.AN_ENERGY_CONF, "--sigma2", sigma20])
            kept = {int(r["itemId"]) - 1 for r in md_rows(f("energy.xmd"))}
            bad = np.array([i not in kept for i in range(V)])
            read["energy_auc"] = 0.5 * (float(bad[outl].mean())
                                        + float((~bad[~outl]).mean()))
            dx, dy = (v * n / cs.N for v in cs.AN_CENTER)
            moved = np.roll(views4[:cs.AN_CENTER_VIEWS],
                            (int(round(dy)), int(round(dx))), axis=(1, 2))
            ctr = cs.write_views(root, "centre", moved)
            prog = run("find_center", "image_find_center",
                       ["-i", ctr, "--oroot", f("ctr")])
            read["center_err_px"] = float(np.hypot(
                prog.center[0] - (n / 2 + round(dx)),
                prog.center[1] - (n / 2 + round(dy))))
            prog = run("ssnr", "image_ssnr", ["-i", part, "-o", f("ssnr.xmd")])
            read["ssnr_median"] = float(np.median(prog.ssnr))
        if args.part == "sort":
            # the chain aligns the remaining views at each step, a shape a
            # step: drop the compiled programs before each
            import jax
            from xmipp3_tpu.ops import align as jalign
            aligner = jalign.align_considering_mirrors

            def fresh(*a, **k):
                jax.clear_caches()
                return aligner(*a, **k)
            jalign.align_considering_mirrors = fresh
        if args.part == "sort":
            srt = cs.write_views(root, "sort", views4[:args.sort_views])
            prog = run("sort", "image_sort", ["-i", srt, "--oroot",
                                              f("sorted")])
            read["sort_median_corr"] = float(np.median(prog.ccs[1:]))

        if args.part in ("dimred", "classes"):
            (root / "cls").mkdir()
            cs.write_classify_data(root / "cls", n, cs.CLS_VIEWS, seed, "cpu")
        if args.part == "dimred":
            # dimension reduction
            rows10 = md_rows(root / "cls" / "poses.xmd")[:cs.AN_DIMRED_VIEWS]
            col = lambda k: np.array([float(r[k]) for r in rows10], np.float32)
            v10 = Image.read_stack(str(root / "cls" / "views.mrcs"))
            reg = fourier_resize_2d(apply_md_geometry(
                v10[:cs.AN_DIMRED_VIEWS], col("anglePsi"), col("shiftX"),
                col("shiftY"), col("flip") > 0.5, device="cpu"),
                cs.AN_DIMRED_N, cs.AN_DIMRED_N).numpy()
            label = np.asarray(cs.classify_recipe(n, cs.CLS_VIEWS, seed)[
                "label"])[np.array([int(r["itemId"]) for r in rows10]) - 1]
            dmd = cs.write_views(root, "dimred_in", reg)
            run("vectorize", "image_vectorize", ["-i", dmd, "-o",
                                                 f("vectors.xmd")])
            run("ltsa", "matrix_dimred", ["-i", f("vectors.xmd"), "-o",
                                          f("ltsa.xmd"), "-m", "LTSA", "--dout",
                                          3])
            Y = np.stack([r["dimred"] for r in md_rows(f("ltsa.xmd"))])
            read["ltsa_nearest_centroid"] = cs.nearest_centroid_share(Y, label)
            run("pca", "matrix_dimred", ["-i", f("vectors.xmd"), "-o",
                                         f("pca.xmd"), "-m", "PCA", "--dout", 3])
            Yp = np.stack([r["dimred"] for r in md_rows(f("pca.xmd"))])
            X = reg.reshape(len(reg), -1).astype(np.float64)
            U, S, _ = np.linalg.svd(X - X.mean(axis=0), full_matrices=False)
            want = U[:, :3] * S[:3]
            sgn = np.sign((Yp * want).sum(axis=0))
            read["pca_vs_numpy_svd"] = float(np.abs(Yp * sgn - want).max()
                                             / np.abs(want).max())
            rp = cs.write_views(root, "rpca_in", views4[:cs.AN_RPCA_VIEWS])
            run("rotational_pca", "image_rotational_pca",
                ["-i", rp, "--oroot", f("rpca"), "--eigenvectors",
                 cs.AN_RPCA_EIG, "--psi_step", cs.AN_RPCA_PSI, "--mesh",
                 "none"])
            basis = vol("rpca.stk").reshape(cs.AN_RPCA_EIG, -1).astype(
                np.float64)
            Xs = views4[:cs.AN_RPCA_VIEWS].reshape(cs.AN_RPCA_VIEWS, -1) \
                .astype(np.float64)
            Xs -= Xs.mean(axis=0)
            Q = np.linalg.qr(basis.T)[0]
            read["rpca_variance_share"] = float(((Xs @ Q) ** 2).sum()
                                                / (Xs ** 2).sum())

        if args.part == "sketch":
            read.update(sketch_readings(root, run, vol, seed))

        if args.part == "classes":
            # class analysis
            fmd = root / "feat_in.xmd"
            MetaData.fromRows(md_rows(root / "cls" / "views.xmd")[:500]).write(
                str(fmd))
            run("features", "classify_extract_features",
                ["-i", fmd, "-o", f("features.xmd"), *cs.AN_FEATURES])
            rows = md_rows(f("features.xmd"))
            read["feature_spread"] = {}
            for lab in cs.AN_FEATURE_LABELS:
                F = np.stack([r[lab] for r in rows]).astype(np.float64)
                read["feature_spread"][lab] = float(np.median(
                    F.std(axis=0) / np.maximum(np.abs(F.mean(axis=0)), 1e-30)))
            T = cs.AN_TV_VIEWS
            sigma = float((views4[:T] - clean4[:T]).std())
            tv = cs.write_views(root, "tv_in", views4[:T])
            run("denoising_tv", "denoising_tv",
                ["-i", tv, "-o", f("tv.mrcs"), "--weight",
                 cs.AN_TV_WEIGHT * sigma])
            den = Image.read_stack(f("tv.mrcs"))
            read["tv_rms_raw"] = float(np.sqrt(((views4[:T] - clean4[:T]) ** 2)
                                               .mean()))
            read["tv_rms_denoised"] = float(np.sqrt(((den - clean4[:T]) ** 2)
                                                    .mean()))

    print(json.dumps({"read": read, "seconds": seconds}))
    return 0


def sketch_readings(root: Path, run, vol, seed: int) -> dict:
    """The reference's rotational PCA sketch against its exact (mesh)
    eigenbasis on phase 13's data (see the module's docstring)."""
    from xmipp3_tpu.ops.geo import rotate_2d
    from xmipp3_tpu_torch.ops.resize import fourier_resize_2d
    rng = np.random.default_rng(seed + 3)
    rot = rng.uniform(0, 360, cs.VIEWS)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, cs.VIEWS)))
    psi = rng.uniform(0, 360, cs.VIEWS)
    sx, sy = rng.uniform(-3, 3, (2, cs.VIEWS))
    clean = cs.projections(cs.N, rot, tilt, psi, sx, sy, cs.BLOBS8,
                           device="cpu")
    views = (clean + (0.5 * clean.std()) * rng.standard_normal(
        clean.shape, dtype=np.float32))[:cs.AN_RPCA_VIEWS]
    del clean
    small = fourier_resize_2d(views, cs.AN_RPCA_N, cs.AN_RPCA_N,
                              device="cpu").numpy()
    rp = cs.write_views(root, "sketch_in", small)
    bases = {}
    for mode in ("none", "dp"):
        run(f"rotational_pca_{mode}", "image_rotational_pca",
            ["-i", rp, "--oroot", root / f"sketch_{mode}", "--eigenvectors",
             cs.AN_RPCA_EIG, "--mesh", mode])
        bases[mode] = vol(f"sketch_{mode}.stk")
    # the program's expansion over the default 15-degree psi grid
    X = np.concatenate([small] + [np.asarray(rotate_2d(
        small, np.full(len(small), a, np.float32)))
        for a in np.arange(15.0, 360.0, 15.0)]).reshape(len(small) * 24, -1)
    assert X.size > 4e7, X.shape
    Xc = X.astype(np.float64)
    del X
    Xc -= Xc.mean(axis=0)
    total = (Xc ** 2).sum()
    share = {}
    for mode, basis in bases.items():
        Q = np.linalg.qr(basis.reshape(len(basis), -1).T.astype(
            np.float64))[0]
        share[mode] = float(((Xc @ Q) ** 2).sum() / total)
    return {"sketch_share": share["none"], "exact_share": share["dp"],
            "sketch_share_ratio": share["none"] / share["dp"],
            "sketch_vs_exact_max_angle_rad": float(cs.principal_angles(
                bases["none"], bases["dp"]).max())}


def run_parts(args) -> int:
    """Each part in a process of its own; one JSON line of every reading
    and the limits."""
    import subprocess
    read, seconds = {}, {}
    for part in PARTS:
        # two virtual CPU devices for the sketch part's --mesh dp run (set
        # before jax starts)
        env = dict(os.environ, XLA_FLAGS=(
            "--xla_force_host_platform_device_count=2")) \
            if part == "sketch" else None
        out = subprocess.run(
            [sys.executable, __file__, "--part", part, "--n", str(args.n),
             "--sort-views", str(args.sort_views), "--seed",
             str(args.seed)], capture_output=True, text=True, check=True,
            env=env)
        got = json.loads(out.stdout.strip().splitlines()[-1])
        read.update(got["read"])
        seconds.update(got["seconds"])
    n = args.n
    twice = lambda v: 1.0 - 2.0 * (1.0 - v)
    limits = {
        "AN_PC1_CORR": twice(read["pc1_corr"]),
        "AN_SPLIT3_SHARE": twice(read["split3_share"]),
        "AN_EMPTY_ELIM": twice(read["empty_eliminated"]),
        "AN_EMPTY_KEPT": twice(read["particles_kept"]),
        "AN_STATS_AUC": twice(read["stats_auc"]),
        "AN_ENERGY_AUC": twice(read["energy_auc"]),
        "AN_CENTER_ERR": 2.0 * read["center_err_px"] * cs.N / n,
        "AN_SSNR": 0.5 * read["ssnr_median"],
        "AN_SORT_CORR": twice(read["sort_median_corr"]),
        "AN_LTSA_SEP": twice(read["ltsa_nearest_centroid"]),
        "AN_RPCA_SHARE": 0.5 * read["rpca_variance_share"],
        "AN_RPCA_SKETCH": twice(read["sketch_share_ratio"]),
    }
    print(json.dumps({"n": n, "sort_views": args.sort_views,
                      "seed": args.seed, "read": read, "limits": limits,
                      "seconds": seconds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
