"""Run chip_smoke.py's phase 15 alone: the kernels are built, then
chip_smoke.flexibility runs the 16 programs of the Zernike3D and NMA
slice with every check (the phase makes its own data; it reads nothing
of the earlier phases).

On the card, from the repo root:

    python3 tools/phase15_alone.py

The data go under chip_smoke_data/p15/, removed at the end. The dry run
of the phase's code on the CPU is tools/plan_flex.py --package port.
"""
import json
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
    from xmipp3_tpu_torch.ops import _cuda_build
    t0 = time.perf_counter()
    _cuda_build.build()
    print(f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    root = ROOT / "chip_smoke_data" / "p15"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        kernels = cs.flexibility(0, root)
    except cs.SmokeFailure as e:
        print(f"phase 15 FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        print(f"phase 15 call {time.perf_counter() - t0:.2f} s", flush=True)
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"kernels": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
