"""Run one of chip_smoke.py's later phases alone on the card, with every
check: the kernels are built, then

- 14: phase 14's inputs are made as phases 4 and 10 make them (phase 10's
  4,096 views and poses on disk, the first 2,000 of phase 4's clean views
  and true poses), and chip_smoke.misc_and_volumes runs the 18 programs
  of the micrograph, misc and volume slices;
- 15: chip_smoke.flexibility runs the 16 programs of the Zernike3D and
  NMA slice;
- 16: chip_smoke.tomography runs the 28 programs of the tomography slice,
  the tail of flex_misc_ext and the three tilt programs;
- 17: chip_smoke.tail runs the long tail: the deep programs, the rest of
  final_batch and scripts_misc, matlab_bridge and the infra programs.

Phases 15-17 make their own data; they read nothing of the earlier
phases. On the card, from the repo root:

    python3 tools/phase_alone.py 16 [--keep rec_truth.mrc ...]

The data go under chip_smoke_data/p<phase>/, removed at the end. --keep
copies a volume of the data folder, as float16 (its high and low bytes
apart, so that zlib packs the exponents), to
chiprun_out/p<phase>_<name>.npz: tools/plan_tomo.py --tomogram reads it.
The dry run of a phase's code on the CPU is its plan with --package port
(tools/plan_volume_misc.py, tools/plan_flex.py, tools/plan_tomo.py,
tools/plan_tail.py).
"""
import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def misc_volume(root: Path):
    cls = root / "classify"
    cls.mkdir(parents=True)
    t0 = time.perf_counter()
    cs.write_classify_data(cls, cs.N, cs.CLS_VIEWS, 0, cs.DEVICE)
    p4, _ = cs.cycle_poses(0)
    p4 = {k: v[:cs.MS_VIEWS] for k, v in p4.items()}
    clean = cs.projections(cs.N, p4["rot"], p4["tilt"], p4["psi"],
                           p4["sx"], p4["sy"], cs.BLOBS8, device=cs.DEVICE)
    print(f"inputs in {time.perf_counter() - t0:.2f} s", flush=True)
    cs.misc_and_volumes(0, root / "misc", cls, clean, p4)


PHASES = {14: misc_volume,
          15: lambda root: cs.flexibility(0, root),
          16: lambda root: cs.tomography(0, root),
          17: lambda root: cs.tail(0, root)}


def keep(src: Path, dst: Path):
    from xmipp3_tpu_torch.core.image import Image
    bits = np.squeeze(Image(str(src)).data).astype(np.float16).view(np.uint16)
    np.savez_compressed(dst, hi=(bits >> 8).astype(np.uint8),
                        lo=(bits & 255).astype(np.uint8))
    print(f"kept {src.name} {bits.shape} as {dst}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phase", type=int, choices=sorted(PHASES))
    ap.add_argument("--keep", action="append", default=[])
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    from xmipp3_tpu_torch.ops import _cuda_build
    t0 = time.perf_counter()
    _cuda_build.build()
    print(f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    cs.warm_ranks()
    root = ROOT / "chip_smoke_data" / f"p{args.phase}"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        kernels = PHASES[args.phase](root)
    except cs.SmokeFailure as e:
        print(f"phase {args.phase} FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        print(f"phase {args.phase} call {time.perf_counter() - t0:.2f} s",
              flush=True)
        out = ROOT / "chiprun_out"
        for name in args.keep:
            if (root / name).is_file():
                out.mkdir(exist_ok=True)
                keep(root / name, out / f"p{args.phase}_{Path(name).stem}")
        shutil.rmtree(root, ignore_errors=True)
    if kernels:
        print(json.dumps({"kernels": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
