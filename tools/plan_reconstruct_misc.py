"""Plan the map-quality limits of chip_smoke.py phase 11 with the reference
package on the CPU: the same recipes (chip_smoke's helpers) through the
reference's programs, at a smaller size.

(b) Phase 3's recipe (the 4-blob phantom's views at uniform poses, psi and
shifts of +-3 px, true poses in the metadata; chip_smoke.write_dataset)
at --n (default 64) with the blobs' centres scaled from 128:
reconstruct_art --parallel_mode pSART with 10 blocks a pass and -n 2, and
reconstruct_art --parallel_mode SIRT -n 3 --POCS_positivity, on --views
(default 2,000; ART grids trilinearly); reconstruct_wbp --filsam 5 (the
arbitrary-geometry filter) and reconstruct_wbp --diameter 0.75 n on the
first --kb-views (default 500): the reference grids those with the exact
Kaiser-Bessel tap expansion, 64 taps a sample in one batch, which holds
several GB at 500 views of 64 px. The readings: each volume's correlation with the phantom
and whether ART's residual history rises.

(d) chip_smoke.significance_data at --n: 256 views of the 8-blob phantom
(uniform directions, psi, +-1 px, noise of 0.05 sigma) and the phantom
low-passed to a quarter of Nyquist as --initvolumes;
reconstruct_significant --angularSampling 5 --iter 3 --maxShift 4. The
reading: the final volume's correlation with the phantom (and the
start's).

Run from the repo root on a CPU host with jax:

    JAX_PLATFORMS=cpu python tools/plan_reconstruct_misc.py [--n 64]
        [--views 2000] [--kb-views 500] [--seed 0]

Prints one JSON line of the readings and the limits that twice the
reference's shortfall from a correlation of 1 gives. These are readings
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
    ap.add_argument("--views", type=int, default=2000)
    ap.add_argument("--kb-views", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    from xmipp3_tpu.core.image import Image
    from xmipp3_tpu.core.metadata import MetaData
    from xmipp3_tpu.programs import get_program

    n = args.n
    out, seconds = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        blobs = cs.scaled_blobs(cs.BLOBS, n)
        md = cs.write_dataset(root, args.views, args.seed, n=n, blobs=blobs)
        rows = list(MetaData(str(md)).iterRows())
        MetaData.fromRows(rows[:args.kb_views]).write(str(root / "kb.xmd"))
        ref = cs.phantom(n, blobs)
        seconds["data"] = time.perf_counter() - t0
        block = -(-args.views // 10)
        for label, name, inp, flags in (
                ("art_psart", "reconstruct_art", md,
                 ["--parallel_mode", "pSART", "--block_size", block, "-n",
                  cs.RM_ART_ITERS]),
                ("art_sirt", "reconstruct_art", md,
                 ["--parallel_mode", "SIRT", "-n", cs.RM_SIRT_ITERS,
                  "--POCS_positivity"]),
                ("wbp", "reconstruct_wbp", root / "kb.xmd",
                 ["--filsam", cs.RM_FILSAM]),
                ("wbp_ramp", "reconstruct_wbp", root / "kb.xmd",
                 ["--diameter", int(cs.RM_WBP_DIAMETER * n)])):
            t0 = time.perf_counter()
            prog = get_program(name)
            fn = root / f"{label}.vol"
            rc = prog.run_with_args([str(a) for a in (
                "-i", inp, "-o", fn, *flags, "-v", "0")])
            seconds[label] = time.perf_counter() - t0
            assert rc == 0, label
            vol = np.squeeze(Image(str(fn)).data)
            q = out[label] = {"corr": cs.volume_corr(vol, ref)}
            hist = getattr(prog, "residual_history", None)
            if hist is not None:
                q["residual_history"] = [float(v) for v in hist]
                q["non_increasing"] = cs.non_increasing(hist)
            print(label, q, f"{seconds[label]:.1f} s", flush=True)

        t0 = time.perf_counter()
        sig_ref = cs.significance_data(root, n, cs.RM_SIG_VIEWS, args.seed,
                                           "cpu")
        (root / "sig").mkdir()
        rc = get_program("reconstruct_significant").run_with_args(
            [str(a) for a in (
                "-i", root / "sig.xmd", "--odir", root / "sig",
                "--initvolumes", root / "init.vol", "--angularSampling",
                cs.RM_SIG_RATE, "--iter", cs.RM_SIG_ITERS, "--maxShift",
                cs.RM_SIG_MAX_SHIFT, "-v", "0")])
        seconds["reconstruct_significant"] = time.perf_counter() - t0
        assert rc == 0
        vol = np.squeeze(Image(str(root / "sig" /
                                   "significant_volume.vol")).data)
        out["reconstruct_significant"] = {
            "corr": cs.volume_corr(vol, sig_ref),
            "start_corr": cs.volume_corr(np.squeeze(Image(str(
                root / "init.vol")).data), sig_ref)}
    limits = {k: 1 - 2 * (1 - v["corr"]) for k, v in out.items()}
    print(json.dumps({"n": n, "views": args.views,
                      "kb_views": args.kb_views, "readings": out,
                      "limits": limits, "seconds": seconds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
