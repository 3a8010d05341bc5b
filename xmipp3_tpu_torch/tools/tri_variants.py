#!/usr/bin/env python3
"""Time the trilinear gridding kernel K2 of xmipp3_tpu_torch beside its
first design and the calls that compute the same sum from the expanded
taps, on one CUDA card, at chip_smoke.py's phase-2 shapes (one 256-image
batch of slice samples at N=128, P=256: M = 1,661,440 samples, 8 taps
each).

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 xmipp3_tpu_torch/tools/tri_variants.py [--seed 0] [--rounds 2]

It builds tri_variants.cu from beside itself (which includes the package's
csrc/scatter_tri.cu) into xmipp3_tpu_torch/_build/, holds every candidate
against tri_scatter_plain on the same samples (max |candidate - plain| <=
1e-4 * max |plain|: float atomics add in a run-dependent order), and times
them in turns, `--rounds` times over, with CUDA events (20 launches a
reading, the cubes reused between launches). Candidates:

- v0, the first design (24 scalar atomics a sample, three cubes at once);
- tri_scatter (the channel in blockIdx.y, a row's two taps as the float4
  atomic of the 16-byte quad that holds both);
- K5 and K1 on the batch's 8 tap streams, stacked and flattened.

Timed beside them: `index_add_` x3 on the flattened tap stream (the tap
expansion outside the timed window). It exits 1 if a candidate disagrees.
Only numbers of one run on one card compare.
"""
from __future__ import annotations

import ctypes
import sys

import harness
from harness import cs

PTR, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
SAMPLE_ARGS = [PTR] * 9 + [I64, INT]


def main(argv=None) -> int:
    args = harness.start(__doc__, "tri_variants", argv)
    if args is None:
        return 2
    import torch
    from xmipp3_tpu_torch.ops import _cuda_build as cb
    from xmipp3_tpu_torch.ops import scatter, scatter_tri
    dll = harness.build("tri_variants", {"xv_tri_v0": SAMPLE_ARGS + [PTR]})
    dev, P = cs.DEVICE, cs.P
    samples = [t for group in cs.slice_samples(args.seed, dev) for t in group]
    M = samples[0].numel()
    print(f"M = {M}, P = {P}")
    planar = cs.cubes(dev)
    ptrs = lambda *ts: [cb.ptr(t) for t in ts]
    stream = lambda: cb.stream_ptr(torch.device(dev))

    def v0():
        cb.check_launch(dll.xv_tri_v0(*ptrs(*samples, *planar), M, P,
                                      stream()), "xv_tri_v0")
        return planar

    tri = scatter_tri.tri_expand(*samples, P)
    idx8 = tri[0].view(8, -1)
    v8 = torch.stack([u.view(8, -1) for u in tri[1:]], dim=1).contiguous()

    def index_add():
        for a, u in zip(planar, tri[1:]):
            a.index_add_(0, tri[0], u)

    cands = {
        "v0, the first design: 24 scalar atomics, three cubes at once": v0,
        "tri_scatter: channel in blockIdx.y, a row as its float4 quad":
        lambda: scatter_tri.tri_scatter(*planar, *samples, P=P),
        "K5 on the 8 tap streams (scatter_add_3ch_streams)":
        lambda: scatter.scatter_add_3ch_streams(*planar, idx8, v8),
        "K1 on the flattened tap stream (scatter_add_3ch)":
        lambda: scatter.scatter_add_3ch(*planar, *tri)}
    floors = {"index_add_ x3 on the flattened tap stream": index_add}
    want = cs.cubes(dev)
    scatter_tri.tri_scatter_plain(*want, *samples, P=P)
    ref = max(float(w.abs().max()) for w in want)

    def rel_err(fn):
        for w in planar:
            w.zero_()
        got = fn()
        return max(float((a - b).abs().max())
                   for a, b in zip(got, want)) / ref

    bad = []
    harness.measure("K2", cands, rel_err, cs.TOL, args.rounds, bad,
                    floors=floors, width=70)
    return harness.finish(bad)


if __name__ == "__main__":
    sys.exit(main())
