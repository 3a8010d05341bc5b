"""K4: weighted complex cross-spectrum of ring FFTs.

    cross  [b, R, k] = sum_r f_imgs[b, r, k]       * w[r] * conj(f_refs[R, r, k])
    cross_m[b, R, k] = sum_r conj(f_imgs[b, r, k]) * w[r] * conj(f_refs[R, r, k])

Replaces `cross_spectrum_pallas` of xmipp3_tpu/ops/pallas_cross.py:44-76 and
the four real einsums of xmipp3_tpu/ops/match.py:91-99. With fi = a + ib
(times w) and fr = c + id both spectra share the four real products ac, bd,
bc, ad: cross = (ac + bd, bc - ad), cross_m = (ac - bd, -(bc + ad)). The CUDA
kernel (csrc/cross.cu) forms them in float32 registers on the data as it
lies (k fastest), a block per tile of images, references and harmonics,
and writes each output once.

Bound on the card: the bytes of the outputs, 8 B * B * R * k per spectrum,
some twenty-five times the inputs; the float32 work (8 flop per ring and
output pair) needs about three quarters of that time.

`cross_spectrum` launches the kernel for CUDA tensors and uses the plain
version (four real `torch.einsum`) only for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from xmipp3_tpu_torch.ops import _cuda_build as cb

# Launches of the CUDA kernel (never of the plain version) since the last
# reset; a run sets it to 0 and reads it to show its path used the kernel.
launches = 0

_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)


def cross_spectrum_plain(f_imgs, f_refs, w, mirror: bool = False):
    """The four real products as einsums (xmipp3_tpu/ops/match.py:91-99)."""
    a = f_imgs.real * w[None, :, None]
    b = f_imgs.imag * w[None, :, None]
    c, d = f_refs.real, f_refs.imag
    ac = torch.einsum("brk,Rrk->bRk", a, c)
    bd = torch.einsum("brk,Rrk->bRk", b, d)
    bc = torch.einsum("brk,Rrk->bRk", b, c)
    ad = torch.einsum("brk,Rrk->bRk", a, d)
    cross = torch.complex(ac + bd, bc - ad)
    if not mirror:
        return cross
    return cross, torch.complex(ac - bd, -(bc + ad))


def cross_spectrum(f_imgs, f_refs, w, mirror: bool = False):
    """Cross-spectrum of every (image, reference) pair, per harmonic.

    f_imgs (B, nr, k) and f_refs (R, nr, k) complex64, w (nr,) float32, all
    contiguous and on one device. Returns cross (B, R, k) complex64, and with
    mirror=True the pair (cross, cross_m), the second being the spectrum of
    the mirrored images (conjugated ring FFTs)."""
    what = "cross_spectrum"
    if f_imgs.ndim != 3 or f_refs.ndim != 3 or \
            f_imgs.shape[1:] != f_refs.shape[1:]:
        raise ValueError(f"{what}: f_imgs {tuple(f_imgs.shape)} and f_refs "
                         f"{tuple(f_refs.shape)} must be (B, nr, k) and "
                         "(R, nr, k)")
    B, nr, K = f_imgs.shape
    R = f_refs.shape[0]
    dev = cb.check_operands(what, torch.complex64, B * nr * K, f_imgs=f_imgs)
    rdev = cb.check_operands(what, torch.complex64, R * nr * K, f_refs=f_refs)
    wdev = cb.check_operands(what, torch.float32, nr, w=w)
    if not dev == rdev == wdev:
        raise ValueError(f"{what}: operands on {dev}, {rdev} and {wdev}")
    if dev.type == "cpu":
        return cross_spectrum_plain(f_imgs, f_refs, w, mirror)
    cross = torch.empty((B, R, K), dtype=torch.complex64, device=dev)
    cross_m = torch.empty_like(cross) if mirror else None
    if cross.numel():
        global launches
        fn = cb.bind("cross", "xm_cross_spectrum", _ARGTYPES)
        with torch.cuda.device(dev):
            rc = fn(cb.ptr(f_imgs), cb.ptr(f_refs), cb.ptr(w), cb.ptr(cross),
                    cb.ptr(cross_m) if mirror else None, B, nr, R, K,
                    cb.stream_ptr(dev))
        launches += 1
        cb.check_launch(rc, what)
    return (cross, cross_m) if mirror else cross
