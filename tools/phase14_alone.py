"""Run chip_smoke.py's phase 14 alone: its inputs are made as phases 4 and
10 make them (phase 10's 4,096 views and poses on disk, the first 2,000
of phase 4's clean views and true poses), then
chip_smoke.misc_and_volumes runs the 18 programs with every check.

On the card, from the repo root (about 80 s on an H100):

    python3 tools/phase14_alone.py

The data go under chip_smoke_data/p14/, removed at the end. The dry run
of the phase's code on the CPU is tools/plan_volume_misc.py --package
port.
"""
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    root = ROOT / "chip_smoke_data" / "p14"
    shutil.rmtree(root, ignore_errors=True)
    cls = root / "classify"
    cls.mkdir(parents=True)
    t0 = time.perf_counter()
    cs.write_classify_data(cls, cs.N, cs.CLS_VIEWS, 0, cs.DEVICE)
    p4, _ = cs.cycle_poses(0)
    p4 = {k: v[:cs.MS_VIEWS] for k, v in p4.items()}
    clean = cs.projections(cs.N, p4["rot"], p4["tilt"], p4["psi"],
                           p4["sx"], p4["sy"], cs.BLOBS8, device=cs.DEVICE)
    print(f"inputs in {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    try:
        cs.misc_and_volumes(0, root / "misc", cls, clean, p4)
    except cs.SmokeFailure as e:
        print(f"phase 14 FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        print(f"phase 14 call {time.perf_counter() - t0:.2f} s", flush=True)
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
