#!/usr/bin/env python3
"""Time the cross-spectrum kernel K4 of xmipp3_tpu_torch beside its first
design, its own 8-byte-copy path and the two complex einsums, on one CUDA
card, at chip_smoke.py's phase-2 shapes (B=512 images, 31 rings,
R=1652 references, k=64 harmonics, with the mirror).

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 xmipp3_tpu_torch/tools/cross_variants.py [--seed 0] [--rounds 2]

It builds cross_variants.cu from beside itself (which includes the
package's csrc/cross.cu) into xmipp3_tpu_torch/_build/, holds every
candidate against cross_spectrum_plain on the same operands (max |candidate
- plain| <= 1e-5 * max |plain|: the sums run in a fixed order), and times
the candidates in turns, `--rounds` times over, with CUDA events (20
launches a reading, outputs allocated once), beside the time PyTorch takes
to write the two outputs alone (the floor under all of them). Beside each
tile it prints a model of what the tile reads from L2 into shared memory,
8 nr k (B ceil(R / TR) + R ceil(B / TB)) bytes, not a measurement. It exits
1 if a candidate disagrees. Only numbers of one run on one card compare.
"""
from __future__ import annotations

import ctypes
import sys

import harness
from harness import cs

ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def main(argv=None) -> int:
    args = harness.start(__doc__, "cross_variants", argv)
    if args is None:
        return 2
    import torch
    from xmipp3_tpu_torch.ops import _cuda_build as cb
    from xmipp3_tpu_torch.ops import cross
    dll = harness.build("cross_variants", {"xv_cross_v0": ARGTYPES,
                                           "xv_cross_8byte": ARGTYPES})
    fi, fr, w = cs.cross_operands(args.seed)
    B, nr, K = fi.shape
    R = fr.shape[0]
    print(f"B={B}, nr={nr}, R={R}, k={K}, with the mirror")
    out = torch.empty((B, R, K), dtype=torch.complex64, device=cs.DEVICE)
    out_m = torch.empty_like(out)
    ptrs = [cb.ptr(t) for t in (fi, fr, w, out, out_m)]

    def raw(symbol):
        def run():
            cb.check_launch(getattr(dll, symbol)(
                *ptrs, B, nr, R, K, cb.stream_ptr(fi.device)), symbol)
            return out, out_m
        return run

    def l2(tb, tr):
        return f"L2 model {cs.l2_to_shared_bytes(B, nr, R, K, tb, tr) / 1e9:.3f} GB"

    def einsums():
        wi = w[None, :, None]
        return (torch.einsum("brk,Rrk->bRk", fi * wi, fr.conj()),
                torch.einsum("brk,Rrk->bRk", fi.conj() * wi, fr.conj()))

    cands = {
        f"v0, the first design: 8 x 16 x 32, 8-byte copies ({l2(8, 16)})":
        raw("xv_cross_v0"),
        f"cross_spectrum, the package's kernel: 32 x 32 x 4 ({l2(32, 32)})":
        lambda: cross.cross_spectrum(fi, fr, w, mirror=True),
        "the package's kernel with its 8-byte copies (operands off a "
        "16-byte boundary)": raw("xv_cross_8byte"),
        "two complex einsums (the library call)": einsums}
    want = cross.cross_spectrum_plain(fi, fr, w, mirror=True)
    ref = max(float(p.abs().max()) for p in want)

    def rel_err(fn):
        out.zero_()
        out_m.zero_()
        return max(float((g - p).abs().max())
                   for g, p in zip(fn(), want)) / ref

    floor = {"the two outputs written alone (zero_, 2 x 433 MB)":
             lambda: (out.zero_(), out_m.zero_())}
    bad = []
    harness.measure("K4", cands, rel_err, cs.TOL_CROSS, args.rounds, bad,
                    floors=floor, width=90)
    return harness.finish(bad)


if __name__ == "__main__":
    sys.exit(main())
