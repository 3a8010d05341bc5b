"""What the variants tools beside this file share: their command line, the
card's name and power limit, the build of a tool's .cu, and holding every
candidate against a plain version before timing them all in turns.

Not a tool itself: scatter_variants.py, cross_variants.py and
kb_variants.py import it.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the phase-2 data and the timer)


def start(doc: str, tool: str, argv=None):
    """Parse `--seed` and `--rounds`. Without a CUDA card, say so and
    return None; else print the card's name and power limit and return the
    arguments."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print(f"{tool}: needs a CUDA card", file=sys.stderr)
        return None
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    return args


def build(tool: str, argtypes: dict):
    """Build `<tool>.cu` from beside this file (csrc/ on its include path)
    into the package's build directory, then the package's own kernels.
    Print ptxas's register and spill lines, bind each symbol of `argtypes`
    ({name: [ctypes types]}) and return the library."""
    from xmipp3_tpu_torch.ops import _cuda_build as cb
    cb.BUILD_DIR.mkdir(exist_ok=True)
    lib = cb.BUILD_DIR / f"lib{tool}.so"
    out = subprocess.run(
        cb.nvcc_command(Path(__file__).with_name(f"{tool}.cu"), lib),
        capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
    for line in out.stdout.splitlines() + out.stderr.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip())
    dll = ctypes.CDLL(str(lib))
    for name, types in argtypes.items():
        getattr(dll, name).argtypes = types
    cb.build()
    return dll


def measure(title: str, cands: dict, rel_err, tol: float, rounds: int,
            bad: list, floors: dict | None = None, width: int = 50):
    """Hold each candidate ({label: fn()}) to `tol`, rel_err(fn) running it
    once and returning max |fn - plain| / max |plain|; then time every
    candidate and floor (timed, not held) in turns, `rounds` readings of 20
    launches each, with CUDA events. Print one table; append what disagrees
    to `bad`."""
    import torch
    rel = {}
    for label, fn in cands.items():
        rel[label] = rel_err(fn)
        torch.cuda.synchronize()
    timed = {**cands, **(floors or {})}
    times = {label: [] for label in timed}
    for _ in range(rounds):
        for label, fn in timed.items():
            times[label].append(cs.time_ms(fn, reps=20))
    print(f"{title}:")
    for label in timed:
        line = f"  {label:{width}s} " + " ".join(
            f"{x:8.4f}" for x in times[label]) + " ms"
        if label in rel:
            ok = rel[label] <= tol
            line += f"   rel err {rel[label]:.1e}" + ("" if ok else
                                                     "   DISAGREES")
            if not ok:
                bad.append(f"{label} on {title}: {rel[label]:.3e}")
        print(line)


def finish(bad: list) -> int:
    """Name every candidate that disagreed; the tool's exit code."""
    for what in bad:
        print(f"DISAGREES: {what}", file=sys.stderr)
    return 1 if bad else 0
