"""K3: direct Kaiser-Bessel gridding of raw Fourier samples, 4x4x4 taps.

Replaces `kb_scatter_3ch` of xmipp3_tpu/ops/pallas_scatter_kb.py:192-278,
whose Pallas kernel (built by `_mk_kernel`, :89-189) sorts the samples by
base voxel, runs four dz passes over 8192-voxel tiles and accumulates
one-hot MXU products of 1024-sample DMA blocks. The CUDA kernel
(csrc/scatter_kb.cu) takes one sample per thread and walks its 64 taps at
offsets -1..2 from the floor corner: the window is the same degree-7
polynomial in d^2 (`_window_poly`, a copy of :54-70), clamped at 0 and zero
where d^2 > r^2; a sample whose floor corner lies outside [0, P) on any axis
is dropped whole (:213-222); a tap outside the cube is skipped per axis.
The channel is the grid's second dimension, so one cube is walked at a
time, and a (dz, dy) row's four taps go out as the float4 atomics of the
one or two 16-byte quads that hold them.

Bound on the card: 24 bytes read per sample plus the touched voxels of the
three cubes read and written once; the arithmetic (64 distance and Horner
evaluations a sample and channel) is far below the card's float32 rate. The
float atomics, resolved in L2 at one request per 32-byte sector an
instruction touches, are what sets the time in practice, so a measured time
is reported beside the byte and sector bounds, not as a share of them.

kz-slab mode (`zdim`, `z_lo`, as in the TPU kernel; the mesh
reconstructors use it): the cubes are flat (zdim * P * P) slabs whose first
plane is the absolute plane `z_lo` of the (P, P, P) cube. The whole-sample
drop still tests the floor corner against [0, P); a tap is kept where its
absolute plane z lies in [z_lo, z_lo + zdim), at the row z - z_lo of the
slab. Slabs that partition [0, P) add up to the full cube. A slab may be a
view into a larger tensor at any offset.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch
from scipy import special as ss

from xmipp3_tpu_torch.core import timing
from xmipp3_tpu_torch.ops import _cuda_build as cb
from xmipp3_tpu_torch.ops.scatter import expand_taps, scatter_add_3ch_plain

# Launches of the CUDA kernel (never of the plain version) since the last
# reset; a run sets it to 0 and reads it to show its path used the kernel.
# A launch in kz-slab mode counts in slab_launches instead.
launches = 0
slab_launches = 0

POLY_DEG = 7
KB_TAPS = [(dz, dy, dx) for dz in range(-1, 3) for dy in range(-1, 3)
           for dx in range(-1, 3)]

_ARGTYPES = (ctypes.c_void_p,) * 9 + (ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_void_p,
                                      ctypes.c_void_p)


@lru_cache(maxsize=8)
def _window_poly(radius: float, alpha: float, order: int):
    """Least-squares polynomial in d^2 matching the KB window on
    [0, radius^2], highest power first; max abs error ~3e-4 at degree 7
    for (1.9, 15, 0)."""
    d2 = np.linspace(0, radius * radius, 1024)
    t2 = np.maximum(1 - d2 / (radius * radius), 0.0)
    arg = alpha * np.sqrt(t2)
    if order == 0:
        w = ss.iv(0, arg) / ss.iv(0, alpha)
    elif order == 2:
        safe = np.maximum(arg, 1e-6)
        i2 = np.where(arg < 1e-6, 0.0, ss.iv(2, safe))
        w = t2 * i2 / ss.iv(2, alpha)
    else:
        raise NotImplementedError("blob order must be 0 or 2")
    return tuple(float(c) for c in np.polyfit(d2, w, POLY_DEG))


def kb_expand(zi, yi, xi, v0, v1, v2, P: int, radius: float, alpha: float,
              order: int, zdim: int | None = None, z_lo: int = 0):
    """The 64-tap update stream (idx, u0, u1, u2) of raw samples with the
    polynomial window and the kernel's drop rule, into the full cube or
    (zdim set) into the slab of zdim planes from plane z_lo."""
    z0, y0, x0 = (torch.floor(a).to(torch.int32) for a in (zi, yi, xi))
    valid = ((z0 >= 0) & (z0 < P) & (y0 >= 0) & (y0 < P)
             & (x0 >= 0) & (x0 < P))
    fz, fy, fx = zi - z0, yi - y0, xi - x0
    poly = _window_poly(radius, alpha, order)
    r2 = radius * radius

    def weight(dz, dy, dx):
        d2 = (dz - fz) ** 2 + (dy - fy) ** 2 + (dx - fx) ** 2
        w = torch.zeros_like(d2)
        for coef in poly:
            w = w * d2 + coef
        return torch.where(valid & (d2 <= r2), torch.clamp(w, min=0.0), 0.0)

    return expand_taps(z0, y0, x0, KB_TAPS, weight, v0, v1, v2, P, zdim,
                       z_lo)


def kb_scatter_plain(c0, c1, c2, zi, yi, xi, v0, v1, v2, P: int,
                     radius: float, alpha: float, order: int,
                     zdim: int | None = None, z_lo: int = 0):
    """Plain version of the kernel: tap expansion, then index_add_."""
    return scatter_add_3ch_plain(
        c0, c1, c2, *kb_expand(zi, yi, xi, v0, v1, v2, P, radius, alpha,
                               order, zdim, z_lo))


def kb_scatter_3ch(c0, c1, c2, zi, yi, xi, v0, v1, v2, P: int,
                   radius: float, alpha: float, order: int,
                   zdim: int | None = None, z_lo: int = 0):
    """Scatter-add the 4^3 KB footprint of every sample (zi, yi, xi), in
    cube index space, into the (P, P, P) cubes c0/c1/c2 (float32,
    contiguous, updated in place and returned); with zdim set, into the
    three (zdim, P, P) slabs whose first plane is the absolute plane z_lo
    (kz-slab mode). Needs radius <= 2, the reach of the 4^3 footprint."""
    what = "kb_scatter_3ch"
    if radius > 2.0:
        raise ValueError(f"{what}: blob radius {radius} > 2 exceeds the 4^3 "
                         "footprint; use the tap expansion")
    slab = zdim is not None
    if slab and not (0 < zdim <= P and 0 <= z_lo <= P - zdim):
        raise ValueError(f"{what}: slab of {zdim} planes from plane {z_lo} "
                         f"does not lie in a cube of {P} planes")
    z_lo = int(z_lo)
    zdim = P if zdim is None else int(zdim)
    dev = cb.check_operands(what, torch.float32, zdim * P * P, c0=c0, c1=c1,
                            c2=c2)
    M = zi.numel()
    sdev = cb.check_operands(what, torch.float32, M, zi=zi, yi=yi, xi=xi,
                             v0=v0, v1=v1, v2=v2)
    if dev != sdev:
        raise ValueError(f"{what}: cubes on {dev}, samples on {sdev}")
    timing.count("k3.samples", M)
    if dev.type == "cpu":
        return kb_scatter_plain(c0, c1, c2, zi, yi, xi, v0, v1, v2, P,
                                radius, alpha, order, zdim, z_lo)
    if M == 0:
        return c0, c1, c2
    global launches, slab_launches
    poly = (ctypes.c_float * (POLY_DEG + 1))(
        *_window_poly(radius, alpha, order))
    fn = cb.bind("scatter_kb", "xm_kb_scatter", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(*(cb.ptr(t) for t in (zi, yi, xi, v0, v1, v2, c0, c1, c2)),
                M, P, zdim, z_lo, radius * radius,
                ctypes.cast(poly, ctypes.c_void_p), cb.stream_ptr(dev))
    if slab:
        slab_launches += 1
    else:
        launches += 1
    cb.check_launch(rc, what)
    return c0, c1, c2
