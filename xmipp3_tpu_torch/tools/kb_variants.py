#!/usr/bin/env python3
"""Time the Kaiser-Bessel gridding kernel K3 of xmipp3_tpu_torch beside its
first design, on one CUDA card, at chip_smoke.py's phase-2 shapes (one
256-image batch of slice samples at N=128, P=256: M = 1,661,440; the CLI's
blob, radius 1.9, alpha 15, order 0).

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 xmipp3_tpu_torch/tools/kb_variants.py [--seed 0] [--rounds 2]

It builds kb_variants.cu from beside itself (which includes the package's
csrc/scatter_kb.cu) into xmipp3_tpu_torch/_build/, holds both kernels
against kb_scatter_plain on the same samples (max |candidate - plain| <=
1e-4 * max |plain|: float atomics add in a run-dependent order), and times
them in turns, `--rounds` times over, with CUDA events (20 launches a
reading, the accumulators reused between launches). It exits 1 if a
candidate disagrees. Only numbers of one run on one card compare.
"""
from __future__ import annotations

import ctypes
import sys

import harness
from harness import cs

PTR = ctypes.c_void_p
ARGTYPES = [PTR] * 9 + [ctypes.c_int64, ctypes.c_int, ctypes.c_float, PTR,
                        PTR]


def main(argv=None) -> int:
    args = harness.start(__doc__, "kb_variants", argv)
    if args is None:
        return 2
    import torch
    from xmipp3_tpu_torch.ops import _cuda_build as cb
    from xmipp3_tpu_torch.ops import scatter_kb
    from xmipp3_tpu_torch.ops.reconstruct import (BLOB_ALPHA, BLOB_ORDER,
                                                  BLOB_RADIUS)
    dll = harness.build("kb_variants", {"xv_kb_v0": ARGTYPES})
    dev, P = cs.DEVICE, cs.P
    samples = [t for group in cs.slice_samples(args.seed, dev) for t in group]
    M = samples[0].numel()
    kb = dict(P=P, radius=BLOB_RADIUS, alpha=BLOB_ALPHA, order=BLOB_ORDER)
    poly = (ctypes.c_float * 8)(*scatter_kb._window_poly(
        BLOB_RADIUS, BLOB_ALPHA, BLOB_ORDER))
    print(f"M = {M}, P = {P}")
    work = cs.cubes(dev)

    def v0():
        cb.check_launch(dll.xv_kb_v0(
            *(cb.ptr(t) for t in (*samples, *work)), M, P,
            BLOB_RADIUS * BLOB_RADIUS, ctypes.cast(poly, PTR),
            cb.stream_ptr(torch.device(dev))), "xv_kb_v0")

    cands = {"v0, the first design: three cubes interleaved, scalar atomics":
             v0,
             "kb_scatter_3ch (the package's kernel: channel in blockIdx.y, "
             "rows as float4 quads)":
             lambda: scatter_kb.kb_scatter_3ch(*work, *samples, **kb)}
    want = cs.cubes(dev)
    scatter_kb.kb_scatter_plain(*want, *samples, **kb)
    ref = max(float(w.abs().max()) for w in want)

    def rel_err(fn):
        for w in work:
            w.zero_()
        fn()
        return max(float((a - b).abs().max())
                   for a, b in zip(work, want)) / ref

    bad = []
    harness.measure("K3", cands, rel_err, cs.TOL, args.rounds, bad,
                    width=90)
    return harness.finish(bad)


if __name__ == "__main__":
    sys.exit(main())
