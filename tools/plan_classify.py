"""Plan the limits of chip_smoke.py phase 10 with the reference package on
the CPU: the same recipe (chip_smoke's phase 10 helpers) through the
reference's programs, with fewer views.

Data: chip_smoke.write_classify_data at N=128 (the 16 far-apart
directions of the 5-degree gallery, psi, +-4 px shifts, half mirrored,
noise of chip_smoke.CLS_NOISE sigma; the CTF views, the planted poses with
5 % of the rows moved by 15 degrees, the rotational spectra). Programs:
classify_CL2D --nref 16 --nref0 4 --iter 10 -> classify_CL2D_core_analysis
--computeCore 3 2 and --computeStableCore 1; ml_align2d --nref 16
--mirror --iter 10; mlf_align2d the same on the CTF views with
--sampling_rate 2; classify_kerdensom --xdim 7 --ydim 7 --norm --reg0 10
--regF 1 on the spectra;
angular_accuracy_pca --ref the phantom on the poses. The readings are the
phase's: purity and directions won, the cores, the log-likelihood's rise
and dips, the class averages' correlation with their direction's clean
image, the node purity and the moved rows' AUC.

The reference cannot run the phase's 10,000 views at N=128 on a shared
CPU: its ML2D E-step holds several (views, 13, 32, 512) float32 tensors
(1.7 GB each at 2,000 views). So CL2D, KerDenSOM and the PCA score run on
--views (default 2,000) and the two ML programs on the first --ml-views
(default 1,000); about 15 minutes and up to ~8 GB.

Run from the repo root on a CPU host with jax:

    JAX_PLATFORMS=cpu python tools/plan_classify.py [--views 2000]
        [--ml-views 1000] [--seed 0]

Prints one JSON line of the readings and of the limits that twice the
reference's shortfall gives (purities, agreements and correlations with
twice their distance to 1, the AUC likewise, the directions won with
twice their distance to 16; the node purity, at about 0.4, at half its
reading). CL2D also runs with --mesh dp over two virtual CPU devices
(XLA_FLAGS), and its classes are paired with the serial run's
(chip_smoke.same_classes).
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
# two virtual CPU devices for the reference's --mesh dp run of CL2D (set
# before jax starts); every other run asks for --mesh none
os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=2")

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=2000)
    ap.add_argument("--ml-views", type=int, default=1000)
    ap.add_argument("--n", type=int, default=cs.N)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import xmipp3_tpu.models.ml2d as jml
    from xmipp3_tpu.core.image import Image
    from xmipp3_tpu.core.metadata import MetaData
    from xmipp3_tpu.programs import get_program

    # the reference's ML programs keep only the last log-likelihood: keep
    # the model's result of each run for its history
    kept = {}
    model = jml.ml2d

    def keep(*a, **k):
        kept["res"] = model(*a, **k)
        return kept["res"]

    jml.ml2d = keep

    out = {"views": args.views, "ml_views": args.ml_views, "n": args.n,
           "seed": args.seed, "noise": cs.CLS_NOISE, "seconds": {}}

    def run(label, name, argv):
        t0 = time.perf_counter()
        prog = get_program(name)
        assert prog.run_with_args([str(a) for a in argv] + ["-v", "0"]) == 0
        out["seconds"][label] = time.perf_counter() - t0
        return prog

    def column(fn, key):
        md = MetaData(str(fn))
        rows = sorted((md.getRow(i) for i in md), key=lambda r: r["itemId"])
        return np.array([r[key] for r in rows])

    def head(src, dst, count):
        md = MetaData(str(src))
        MetaData.fromRows([md.getRow(i) for i in md][:count]).write(str(dst))

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        t0 = time.perf_counter()
        data = cs.write_classify_data(d, args.n, args.views, args.seed,
                                      "cpu")
        out["seconds"]["data"] = time.perf_counter() - t0
        label, moved, classes = data["label"], data["moved"], data["classes"]
        out["pin"], out["back_corr"] = data["pin"], data["back_corr"]

        assign = {}
        for lab, mode in (("cl2d", "none"), ("cl2d_mesh", "dp")):
            (d / lab).mkdir()
            run(lab, "classify_CL2D",
                ["-i", d / "views.xmd", "--odir", d / lab, "--oroot", "cl",
                 "--nref", cs.CLS_NREF, "--nref0", cs.CLS_NREF0, "--iter",
                 cs.CLS_ITER, "--mesh", mode])
            assign[lab] = column(d / lab / "cl_images.xmd", "ref") - 1
        pur, won = cs.class_purity(assign["cl2d"], label)
        out["cl2d"] = {"purity": pur, "directions_won": won,
                       "mesh_same_class": cs.same_classes(
                           assign["cl2d_mesh"], assign["cl2d"]),
                       "mesh_purity": cs.class_purity(assign["cl2d_mesh"],
                                                      label)[0]}
        run("core", "classify_CL2D_core_analysis",
            ["--dir", d / "cl2d", "--root", "cl", "--computeCore", 3, 2])
        run("stable_core", "classify_CL2D_core_analysis",
            ["--dir", d / "cl2d", "--root", "cl", "--computeStableCore", 1])
        cores, stable = cs.core_quality(d / "cl2d", "cl", label, 3)
        out["core"] = {"levels": cores, "stable_core_views": stable}

        m = args.ml_views
        for lab, name, inp, extra in (
                ("ml2d", "ml_align2d", "views.xmd", []),
                ("mlf2d", "mlf_align2d", "ctf_views.xmd",
                 ["--sampling_rate", cs.CTF_TS])):
            head(d / inp, d / f"{lab}_in.xmd", m)
            run(lab, name, ["-i", d / f"{lab}_in.xmd", "--nref",
                             cs.CLS_NREF, "--mirror", "--iter", cs.CLS_ITER,
                             "--oroot", d / lab, "--mesh", "none", *extra])
            ll = np.asarray(kept["res"]["loglike"])
            assign = column(d / f"{lab}_images.xmd", "ref") - 1
            pur, won = cs.class_purity(assign, label[:m])
            refs = Image.read_stack(str(d / f"{lab}_references.stk"))
            corr = cs.average_corr(refs, classes, cs.majorities(
                assign, label[:m], cs.CLS_NREF), "cpu")
            out[lab] = {"loglike": ll.tolist(),
                        "dips": int((np.diff(ll) < -1e-3
                                     * np.abs(ll[:-1])).sum()),
                        "purity": pur, "directions_won": won,
                        "avg_corr_min": min(corr),
                        "avg_corr_median": float(np.median(corr))}

        run("kerdensom", "classify_kerdensom",
            ["-i", d / "spectra.xmd", "--oroot", d / "som", "--xdim",
             cs.CLS_SOM[1], "--ydim", cs.CLS_SOM[0], *cs.CLS_SOM_FLAGS])
        pur, won = cs.class_purity(column(d / "som_images.xmd", "ref"),
                                   label)
        out["kerdensom"] = {"node_purity": pur, "directions_won": won}

        run("accuracy_pca", "angular_accuracy_pca",
            ["-i", d / "poses.xmd", "--ref", d / "phantom.vol", "-o",
             d / "acc.xmd"])
        score = column(d / "acc.xmd", "scoreByPcaResidual")
        out["accuracy_pca"] = {"auc": cs.auc_lower(score, moved),
                               "moved_median": float(np.median(
                                   score[moved])),
                               "kept_median": float(np.median(
                                   score[~moved]))}

    twice = lambda v: 1.0 - 2.0 * (1.0 - v)
    out["limits"] = {
        "CLS_CL2D_PURITY": twice(out["cl2d"]["purity"]),
        "CLS_CL2D_WON": cs.CLS_DIRS - 2 * (cs.CLS_DIRS
                                           - out["cl2d"]["directions_won"]),
        "CLS_ML2D_PURITY": twice(min(out["ml2d"]["purity"],
                                     out["mlf2d"]["purity"])),
        "CLS_ML2D_WON": cs.CLS_DIRS - 2 * (cs.CLS_DIRS - min(
            out["ml2d"]["directions_won"], out["mlf2d"]["directions_won"])),
        "CLS_AVG_CORR": twice(min(out["ml2d"]["avg_corr_median"],
                                  out["mlf2d"]["avg_corr_median"])),
        "CLS_MESH_SAME": twice(out["cl2d"]["mesh_same_class"]),
        # half the reading: twice its distance to 1 would be below 0
        "CLS_SOM_PURITY": 0.5 * out["kerdensom"]["node_purity"],
        "CLS_AUC": twice(out["accuracy_pca"]["auc"])}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
