#!/usr/bin/env python3
"""Time the shared-index scatter kernels K1 and K5 of xmipp3_tpu_torch
beside three experiments and index_add_, on one CUDA card, at chip_smoke.py's
phase-2 shapes.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 xmipp3_tpu_torch/tools/scatter_variants.py [--seed 0] [--rounds 2]

It builds scatter_variants.cu from beside itself (which includes the
package's csrc/scatter_common.cuh) into xmipp3_tpu_torch/_build/, holds
every candidate against index_add_ on the same stream (max |candidate -
plain| <= 1e-4 * max |plain|: float atomics add in a run-dependent order),
and times the candidates in turns, `--rounds` times over, with CUDA events
(20 launches a reading, the three 64 MiB accumulators reused between
launches). The experiments are the package's kernels with one step of
csrc/scatter_common.cuh taken out (K1 without the warp aggregation, K5
without the 8-byte atomics) and K1's stream into one interleaved (S, 4)
accumulator with one float4 atomic per update. Streams:

- nn: one 256-image batch of nearest-voxel updates at N=128, P=256
  (M = 1,661,440), the stream K1 sees on the `--interp nn` path;
- nn x4: every index of that stream four times in a row (an oversampled or
  symmetric data set: duplicates inside a warp);
- one voxel: every update on one voxel (contention);
- uniformly random voxels, and consecutive voxels (idx = i): a warp's 32
  atomics on 32 sectors, and on 4;
- tri: the batch's 8 trilinear tap streams (8 x M), for K5, beside
  tri_scatter on the raw samples.

It prints one table and exits 1 if a candidate disagrees. Only numbers of
one run on one card compare.
"""
from __future__ import annotations

import ctypes
import sys

import harness
from harness import cs

PTR, I64 = ctypes.c_void_p, ctypes.c_int64


def main(argv=None) -> int:
    args = harness.start(__doc__, "scatter_variants", argv)
    if args is None:
        return 2
    import torch
    from xmipp3_tpu_torch.ops import _cuda_build as cb
    from xmipp3_tpu_torch.ops import scatter, scatter_tri
    dll = harness.build("scatter_variants", {
        "xv_k1_channel": [PTR] * 7 + [I64, I64, PTR],
        "xv_k5_channel": [PTR] * 5 + [I64, I64, I64, PTR],
        "xv_k1_cube4": [PTR] * 5 + [I64, I64, PTR]})
    dev, P = cs.DEVICE, cs.P
    S = P ** 3
    stream = lambda: cb.stream_ptr(torch.device(dev))
    ptrs = lambda *ts: [cb.ptr(t) for t in ts]

    def k1_channel(c, st):
        cb.check_launch(dll.xv_k1_channel(*ptrs(*st, *c), st[0].numel(), S,
                                          stream()), "xv_k1_channel")

    def k5_channel(c, st):
        idx, v = st
        cb.check_launch(dll.xv_k5_channel(*ptrs(idx, v, *c), *idx.shape, S,
                                          stream()), "xv_k5_channel")

    def lib1(c, st):
        for a, u in zip(c, st[1:]):
            a.index_add_(0, st[0], u)

    def lib5(c, st):
        for i, v in zip(*st):
            for a, u in zip(c, v):
                a.index_add_(0, i, u)

    bad = []

    def measure(stream_name, st, plain, cands, rounds):
        """cands: {label: fn(cubes, st)}, held against `plain` on the same
        stream, then timed in turns."""
        want = cs.cubes(dev)
        plain(want, st)
        ref = max(float(w.abs().max()) for w in want)
        work = cs.cubes(dev)

        def rel_err(fn):
            for w in work:
                w.zero_()
            fn()
            return max(float((a - b).abs().max())
                       for a, b in zip(work, want)) / ref

        harness.measure(stream_name, {label: (lambda fn=fn: fn(work, st))
                                      for label, fn in cands.items()},
                        rel_err, cs.TOL, rounds, bad)

    (zi, yi, xi), (v0, v1, v2) = cs.slice_samples(args.seed, dev)
    z0, y0, x0 = (torch.round(a).to(torch.int32) for a in (zi, yi, xi))
    nn = scatter.expand_taps(z0, y0, x0, [(0, 0, 0)],
                             lambda *_: torch.ones_like(zi), v0, v1, v2, P)
    M = nn[0].numel()
    print(f"M = {M}, S = {S}")
    k1 = {"scatter_add_3ch (the package's K1)":
          lambda c, st: scatter.scatter_add_3ch(*c, *st),
          "K1 without warp aggregation": k1_channel,
          "index_add_ x3": lib1}
    measure("nn", nn, lib1, k1, args.rounds)

    # the (S, 4) accumulator: one float4 atomic per update
    acc4 = torch.zeros((S, 4), dtype=torch.float32, device=dev)
    want = cs.cubes(dev)
    lib1(want, nn)
    ref = max(float(w.abs().max()) for w in want)

    def rel_err4(fn):
        acc4.zero_()
        fn()
        return max(float((acc4[:, k] - want[k]).abs().max())
                   for k in range(3)) / ref

    harness.measure("nn into one (S, 4) accumulator", {
        "float4 atomics": lambda: cb.check_launch(dll.xv_k1_cube4(
            *ptrs(*nn, acc4), M, S, stream()), "xv_k1_cube4")},
        rel_err4, cs.TOL, args.rounds, bad)
    del acc4, want

    dup = tuple(t.repeat_interleave(4)[:M].contiguous() for t in nn)
    measure("nn x4 (each index four times in a row)", dup, lib1, k1,
            args.rounds)
    one = (torch.full_like(nn[0], S // 2 + 5),) + nn[1:]
    measure("one voxel", one, lib1, k1, 1)
    # what the atomics cost by themselves: every lane of a warp on a sector
    # of its own, against eight lanes a sector
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rand = (torch.randint(0, S, (M,), generator=gen, device=dev,
                          dtype=torch.int32),) + nn[1:]
    measure("uniformly random voxels", rand, lib1, k1, 1)
    seq = (torch.arange(M, device=dev, dtype=torch.int32),) + nn[1:]
    measure("consecutive voxels (idx = i)", seq, lib1, k1, 1)
    del dup, one, rand, seq

    tri = scatter_tri.tri_expand(zi, yi, xi, v0, v1, v2, P)
    idx8 = tri[0].view(8, -1)
    v8 = torch.stack([u.view(8, -1) for u in tri[1:]], dim=1).contiguous()
    k5 = {"scatter_add_3ch_streams (the package's K5)":
          lambda c, st: scatter.scatter_add_3ch_streams(*c, *st),
          "K5 without 8-byte atomics": k5_channel,
          "index_add_ x24": lib5,
          "tri_scatter (K2, same taps from raw samples)":
          lambda c, st: scatter_tri.tri_scatter(*c, zi, yi, xi, v0, v1, v2,
                                                P=P)}
    measure("tri 8 x M", (idx8, v8), lib5, k5, args.rounds)
    return harness.finish(bad)


if __name__ == "__main__":
    sys.exit(main())
