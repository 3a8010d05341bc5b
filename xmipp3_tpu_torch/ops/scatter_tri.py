"""K2: trilinear gridding of raw Fourier samples into three (P, P, P) cubes.

Replaces `tri_scatter_packed` of xmipp3_tpu/ops/pallas_scatter_tri.py:185-257,
whose Pallas kernel `_tri_kernel` (:62-149) sorts the raw samples, expands
the in-plane taps after the sort and carries the dz = 1 taps in a lag ring,
all in a packed (ntiles, 128, 96) accumulator built for one-hot MXU
products. The CUDA kernel (csrc/scatter_tri.cu) takes one sample per thread
into three contiguous (P, P, P) cubes: floor corner and fractions computed
in the thread, the 8 corners masked per axis exactly as the XLA path of
xmipp3_tpu/ops/reconstruct.py:242-268 does. One cube is walked at a time
(the channel in blockIdx.y), and a row's two taps go out as one float4
atomic on the 16-byte quad that holds both.

Bound on the card: 24 bytes read per sample plus the touched voxels of the
three cubes read and written once; the float atomics' update rate in L2 is
what sets the time in practice, so a measured time is reported beside that
byte bound, not as a share of it. On an NVIDIA H100 80GB HBM3 at a
700.00 W power limit, for one 256-image batch at N=128, P=256
(tools/tri_variants.py): 0.49 ms, against 1.38 ms for the first design and
1.03 ms for `index_add_` on the expanded taps.

`unpack_packed_cube` loads an accumulator saved from the TPU's packed
layout (the counterpart of `packed_cube_unpack`, pallas_scatter_tri.py:177-182).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from xmipp3_tpu_torch.ops import _cuda_build as cb
from xmipp3_tpu_torch.ops.scatter import expand_taps, scatter_add_3ch_plain

# Launches of the CUDA kernel (never of the plain version) since the last
# reset; a run sets it to 0 and reads it to show its path used the kernel.
launches = 0

TRI_TAPS = [(dz, dy, dx) for dz in range(2) for dy in range(2)
            for dx in range(2)]

_ARGTYPES = (ctypes.c_void_p,) * 9 + (ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_void_p)

# The TPU kernel's packed accumulator: (ntiles, LO2, NCH*HI2) with
# TILE = LO2*HI2 cells per tile, holding P^3 + 2P^2 cells per channel.
_LO2, _HI2, _NCH = 128, 32, 3
_TILE = _LO2 * _HI2


def tri_expand(zi, yi, xi, v0, v1, v2, P: int):
    """The 8-tap trilinear update stream of raw samples (idx, u0, u1, u2):
    floor corner, fractions, and (1-f)/f weights per axis, corners outside
    the cube zero-weighted (xmipp3_tpu/ops/reconstruct.py:206-263)."""
    z0, y0, x0 = (torch.floor(a).to(torch.int32) for a in (zi, yi, xi))
    fz, fy, fx = zi - z0, yi - y0, xi - x0

    def weight(dz, dy, dx):
        return ((fz if dz else 1 - fz) * (fy if dy else 1 - fy)
                * (fx if dx else 1 - fx))

    return expand_taps(z0, y0, x0, TRI_TAPS, weight, v0, v1, v2, P)


def tri_scatter_plain(c0, c1, c2, zi, yi, xi, v0, v1, v2, P: int):
    """Plain version of the kernel: tap expansion, then index_add_."""
    return scatter_add_3ch_plain(c0, c1, c2,
                                 *tri_expand(zi, yi, xi, v0, v1, v2, P))


def tri_scatter(c0, c1, c2, zi, yi, xi, v0, v1, v2, P: int):
    """Trilinear gridding: every sample (zi, yi, xi) in cube index space
    spreads v0/v1/v2 over its 8 floor corners into the (P, P, P) cubes
    c0/c1/c2 (float32, contiguous, updated in place and returned)."""
    what = "tri_scatter"
    dev = cb.check_operands(what, torch.float32, P ** 3, c0=c0, c1=c1, c2=c2)
    M = zi.numel()
    sdev = cb.check_operands(what, torch.float32, M, zi=zi, yi=yi, xi=xi,
                             v0=v0, v1=v1, v2=v2)
    if dev != sdev:
        raise ValueError(f"{what}: cubes on {dev}, samples on {sdev}")
    if dev.type == "cpu":
        return tri_scatter_plain(c0, c1, c2, zi, yi, xi, v0, v1, v2, P)
    if M == 0:
        return c0, c1, c2
    global launches
    fn = cb.bind("scatter_tri", "xm_tri_scatter", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(*(cb.ptr(t) for t in (zi, yi, xi, v0, v1, v2, c0, c1, c2)),
                M, P, cb.stream_ptr(dev))
    launches += 1
    cb.check_launch(rc, what)
    return c0, c1, c2


def unpack_packed_cube(packed, P: int) -> np.ndarray:
    """The TPU kernel's packed accumulator (ntiles, 128, 96) -> a numpy
    (3, P, P, P) float32 array (real, imaginary, weight)."""
    packed = np.asarray(packed, np.float32)
    ntiles = packed.shape[0]
    chans = packed.reshape(ntiles, _LO2, _NCH, _HI2).transpose(2, 0, 1, 3)
    flat = chans.reshape(_NCH, ntiles * _TILE)
    return np.ascontiguousarray(flat[:, :P ** 3].reshape(_NCH, P, P, P))
