"""K1: three-channel shared-index scatter-add, and the tap streams that feed it.

Replaces `scatter_add_3ch` / `_pallas_scatter3` of
xmipp3_tpu/ops/pallas_scatter.py:110-180, whose Pallas kernel `_seg_kernel`
(:45-107) sorts the update stream and accumulates one-hot MXU products per
8192-voxel tile. The CUDA kernel (csrc/scatter.cu) needs none of that: one
thread per update, three float atomics into the shared index.

Bound on the card: the bytes are 16 per update (index and three values)
plus the three accumulators read and written once; in practice the float
atomics' update rate in L2 sets the time, so a measured time is reported
beside that byte bound, not as a share of it.

`scatter_add_3ch` launches the kernel for CUDA tensors and uses the plain
version (three `index_add_`) only for CPU tensors. It updates the
accumulators in place and returns them.
"""
from __future__ import annotations

import ctypes

import torch

from xmipp3_tpu_torch.ops import _cuda_build as cb

# Launches of the CUDA kernel (never of the plain version) since the last
# reset; a run sets it to 0 and reads it to show its path used the kernel.
launches = 0

_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_void_p)


def scatter_add_3ch_plain(c0, c1, c2, idx, v0, v1, v2):
    """c_k.view(-1)[idx] += v_k with torch's index_add_ (in place)."""
    for c, v in ((c0, v0), (c1, v1), (c2, v2)):
        c.view(-1).index_add_(0, idx.view(-1), v.view(-1))
    return c0, c1, c2


def scatter_add_3ch(c0, c1, c2, idx, v0, v1, v2):
    """3-channel shared-index scatter-add: c_k.view(-1)[idx] += v_k.

    c0/c1/c2: float32 accumulators of S elements (any contiguous shape);
    idx: int32 of M indices in [0, S) (callers clip and zero-weight, as in
    the reference's contract); v0/v1/v2: float32 of M values. In place."""
    what = "scatter_add_3ch"
    S = c0.numel()
    dev = cb.check_operands(what, torch.float32, S, c0=c0, c1=c1, c2=c2)
    M = idx.numel()
    vdev = cb.check_operands(what, torch.float32, M, v0=v0, v1=v1, v2=v2)
    idev = cb.check_operands(what, torch.int32, M, idx=idx)
    if not dev == vdev == idev:
        raise ValueError(f"{what}: operands on {dev}, {vdev} and {idev}")
    if dev.type == "cpu":
        return scatter_add_3ch_plain(c0, c1, c2, idx, v0, v1, v2)
    if M == 0:
        return c0, c1, c2
    global launches
    fn = cb.bind("scatter", "xm_scatter_add_3ch", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(cb.ptr(idx), cb.ptr(v0), cb.ptr(v1), cb.ptr(v2), cb.ptr(c0),
                cb.ptr(c1), cb.ptr(c2), M, S, cb.stream_ptr(dev))
    launches += 1
    cb.check_launch(rc, what)
    return c0, c1, c2


def expand_taps(z0, y0, x0, taps, tap_weight, v0, v1, v2, P: int):
    """The update stream of a gridding footprint, tap-major.

    For each (dz, dy, dx) in `taps`: the flat index of voxel
    (z0+dz, y0+dy, x0+dx) clipped into the (P, P, P) cube, and the three
    channel values times tap_weight(dz, dy, dx), zeroed where the voxel
    lies outside the cube on any axis (the per-axis mask of
    xmipp3_tpu/ops/reconstruct.py:251-263). z0/y0/x0 int32, values float32,
    all of one shape. Returns (idx int32, u0, u1, u2), each 1-D."""
    idx, u0, u1, u2 = [], [], [], []
    for dz, dy, dx in taps:
        w = tap_weight(dz, dy, dx)
        zj, yj, xj = z0 + dz, y0 + dy, x0 + dx
        inside = ((zj >= 0) & (zj < P) & (yj >= 0) & (yj < P)
                  & (xj >= 0) & (xj < P))
        w = torch.where(inside, w, 0.0)
        flat = ((zj.clamp(0, P - 1) * P + yj.clamp(0, P - 1)) * P
                + xj.clamp(0, P - 1))
        idx.append(flat.reshape(-1))
        u0.append((w * v0).reshape(-1))
        u1.append((w * v1).reshape(-1))
        u2.append((w * v2).reshape(-1))
    return (torch.cat(idx).to(torch.int32), torch.cat(u0), torch.cat(u1),
            torch.cat(u2))
