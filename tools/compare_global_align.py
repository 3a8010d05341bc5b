"""Compare the global movie alignment of the port and of the reference
package on one movie, on the CPU: phantom_movie -size S S F --seed
(the port's, on the CPU; ice, dose and barrel distortion at their
defaults) -> both packages' ops.movie.global_align(frames, 50), as
movie_alignment_correlation calls it with its defaults. Prints each
package's seconds and its median and worst error against the _gt.xmd
truth (gauge: mean 0), and the largest difference between the two.

chip_smoke.py phase 9 reads these errors on a 4096^2 x 40 movie on the
card; the reference cannot run that size on a shared CPU, so this tool
holds the two packages against each other at 4096^2 with fewer frames
and at 2048^2 with all 40.

    JAX_PLATFORMS=cpu python tools/compare_global_align.py [--size 4096]
        [--frames 8] [--seed 0]
"""
from __future__ import annotations

import argparse
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
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    from xmipp3_tpu.ops import movie as jm
    from xmipp3_tpu_torch.core.image import Image
    from xmipp3_tpu_torch.core.metadata import MetaData
    from xmipp3_tpu_torch.ops import movie as tm
    from xmipp3_tpu_torch.programs import get_program
    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as tmp:
        fn = str(Path(tmp) / "m.mrcs")
        S = str(args.size)
        assert get_program("phantom_movie").run_with_args(
            ["-o", fn, "-size", S, S, str(args.frames), "--seed",
             str(args.seed), "--device", "cpu", "-v", "0"]) == 0
        md = MetaData(fn[:-5] + "_gt.xmd")
        truth = np.stack([md.getColumn("shiftX"), md.getColumn("shiftY")],
                         1)
        frames = Image.read_stack(fn)
    pos = {}
    for name, align in (("reference", lambda: jm.global_align(frames, 50)),
                        ("port", lambda: tm.global_align(frames, 50,
                                                         device="cpu"))):
        t0 = time.perf_counter()
        pos[name] = np.asarray(align())
        med, worst = cs.position_errors(pos[name], truth)
        print(f"{name}: {time.perf_counter() - t0:.2f} s, median {med:.4f} "
              f"px, worst {worst:.4f} px", flush=True)
    print(f"{args.size}^2 x {args.frames} frames: port vs reference "
          f"{np.abs(pos['port'] - pos['reference']).max():.3e} px")
    return 0


if __name__ == "__main__":
    sys.exit(main())
