"""K1: three-channel shared-index scatter-add, and the tap streams that feed
it; K5: the same over several update streams in one launch.

K1 replaces `scatter_add_3ch` / `_pallas_scatter3` of
xmipp3_tpu/ops/pallas_scatter.py:110-180, whose Pallas kernel `_seg_kernel`
(:45-107) sorts the update stream and accumulates one-hot MXU products per
8192-voxel tile. K5 replaces `scatter_add_3ch_streams` of
xmipp3_tpu/ops/pallas_scatter.py:264-331, whose Pallas kernel
`_seg_kernel_multi` (:194-261) walks ns sorted streams per tile from
searchsorted tile starts. The CUDA kernels (csrc/scatter.cu) need no sort,
no tile starts and no one-hot products: float atomics, sent one
accumulator at a time (the channel is the slow grid index, so one launch
serves the three channels and counts as one). K1 takes one update per
thread and sums a warp's updates to one voxel before one lane adds them;
K5 gives a thread column i of every stream, so a sample's taps go out
together, and sends streams (2t, 2t+1) that hit x-neighbours as one 8-byte
atomic.

Bound on the card: the bytes the function must move are 16 per update
(index and three values) plus the touched voxels of the three accumulators
read and written once, which makes device memory the bound; what sets the
time is the rate at which L2 takes atomics, one request per 32-byte sector
a warp's atomic touches (csrc/scatter.cu has the measured rates). So a
measured time is reported beside the byte bound and beside the same bound
counted in sectors, not as a share of either.

`scatter_add_3ch` and `scatter_add_3ch_streams` launch their kernel for
CUDA tensors and use the plain version (`index_add_`) only for CPU tensors.
They update the accumulators in place and return them.
"""
from __future__ import annotations

import ctypes

import torch

from xmipp3_tpu_torch.ops import _cuda_build as cb

# Launches of the CUDA kernel (never of the plain version) since the last
# reset; a run sets it to 0 and reads it to show its path used the kernel.
launches = 0
# The same for K5's kernel (scatter_add_3ch_streams).
streams_launches = 0

_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_void_p)
_STREAMS_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int64,) * 3 + (
    ctypes.c_void_p,)


def _check_cube_size(what: str, S: int) -> None:
    if S >= 2 ** 31:
        raise ValueError(f"{what}: accumulators of {S} elements cannot be "
                         "addressed by int32 indices (S must be < 2**31)")


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
    _check_cube_size(what, S)
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


def scatter_add_3ch_streams_plain(c0, c1, c2, idx_streams, v_streams):
    """Per stream and channel, index_add_ on the indices clamped into
    [0, S) (in place): an out-of-range index carries zero by contract."""
    S = c0.numel()
    for idx, v in zip(idx_streams, v_streams):
        i = idx.clamp(0, S - 1)
        for c, u in zip((c0, c1, c2), v):
            c.view(-1).index_add_(0, i, u)
    return c0, c1, c2


def scatter_add_3ch_streams(c0, c1, c2, idx_streams, v_streams):
    """Multi-stream scatter-add: c_k.view(-1)[idx_streams[s]] += v_streams[s][k]
    for every stream s, in one launch.

    c0/c1/c2: float32 accumulators of S elements; idx_streams: (ns, M) int32;
    v_streams: (ns, 3, M) float32 (the reference's lists of streams,
    stacked). An index outside [0, S) must carry zero values and is skipped.
    In place."""
    what = "scatter_add_3ch_streams"
    if idx_streams.ndim != 2 or v_streams.shape != (
            idx_streams.shape[0], 3, idx_streams.shape[1]):
        raise ValueError(f"{what}: idx_streams {tuple(idx_streams.shape)} and "
                         f"v_streams {tuple(v_streams.shape)} must be (ns, M) "
                         "and (ns, 3, M)")
    ns, M = idx_streams.shape
    S = c0.numel()
    _check_cube_size(what, S)
    dev = cb.check_operands(what, torch.float32, S, c0=c0, c1=c1, c2=c2)
    vdev = cb.check_operands(what, torch.float32, ns * 3 * M,
                             v_streams=v_streams)
    idev = cb.check_operands(what, torch.int32, ns * M,
                             idx_streams=idx_streams)
    if not dev == vdev == idev:
        raise ValueError(f"{what}: operands on {dev}, {vdev} and {idev}")
    if dev.type == "cpu":
        return scatter_add_3ch_streams_plain(c0, c1, c2, idx_streams,
                                             v_streams)
    if ns * M == 0:
        return c0, c1, c2
    global streams_launches
    fn = cb.bind("scatter", "xm_scatter_add_3ch_streams", _STREAMS_ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(cb.ptr(idx_streams), cb.ptr(v_streams), cb.ptr(c0),
                cb.ptr(c1), cb.ptr(c2), ns, M, S, cb.stream_ptr(dev))
    streams_launches += 1
    cb.check_launch(rc, what)
    return c0, c1, c2


def _tap_index(z0, y0, x0, dz, dy, dx, P: int, zdim: int | None, z_lo: int):
    """(flat index, inside) of the tap (dz, dy, dx) of every sample in a
    slab of zdim planes of P x P whose first plane is the absolute plane
    z_lo (the full cube: zdim None, z_lo 0): the voxel clipped into the
    slab, and whether it lies in it on every axis (the per-axis mask of
    xmipp3_tpu/ops/reconstruct.py:251-259)."""
    zdim = P if zdim is None else zdim
    zj, yj, xj = z0 + (dz - z_lo), y0 + dy, x0 + dx
    inside = ((zj >= 0) & (zj < zdim) & (yj >= 0) & (yj < P)
              & (xj >= 0) & (xj < P))
    flat = ((zj.clamp(0, zdim - 1) * P + yj.clamp(0, P - 1)) * P
            + xj.clamp(0, P - 1))
    return flat, inside


def expand_tap_streams(z0, y0, x0, taps, tap_weight, v0, v1, v2, P: int,
                       zdim: int | None = None, z_lo: int = 0):
    """The update streams of a gridding footprint, one per tap, for K5.

    For each (dz, dy, dx) in `taps`: the flat index of voxel
    (z0+dz, y0+dy, x0+dx) clipped into the (P, P, P) cube, and the three
    channel values times tap_weight(dz, dy, dx), zeroed where the voxel
    lies outside the cube on any axis (the per-axis mask of
    xmipp3_tpu/ops/reconstruct.py:251-263). With zdim set the cube is the
    slab of zdim planes from the absolute plane z_lo (kz-slab mode): the
    index is relative to the slab and taps outside it are zeroed.
    z0/y0/x0 int32, values float32, all of one shape with M elements.
    Returns (idx (ns, M) int32, v (ns, 3, M) float32), filled tap by
    tap."""
    ns, M = len(taps), z0.numel()
    idx = torch.empty((ns, M), dtype=torch.int32, device=z0.device)
    v = torch.empty((ns, 3, M), dtype=torch.float32, device=z0.device)
    chans = [u.reshape(-1) for u in (v0, v1, v2)]
    for t, (dz, dy, dx) in enumerate(taps):
        flat, inside = _tap_index(z0, y0, x0, dz, dy, dx, P, zdim, z_lo)
        w = torch.where(inside, tap_weight(dz, dy, dx), 0.0).reshape(-1)
        idx[t] = flat.reshape(-1)
        for k, u in enumerate(chans):
            torch.mul(w, u, out=v[t, k])
    return idx, v


def expand_taps(z0, y0, x0, taps, tap_weight, v0, v1, v2, P: int,
                zdim: int | None = None, z_lo: int = 0):
    """The update stream of a gridding footprint, tap-major, for K1 and for
    the plain versions of the gridding kernels: the same updates as
    `expand_tap_streams`, as (idx int32, u0, u1, u2), each 1-D of
    len(taps) * M."""
    idx, u0, u1, u2 = [], [], [], []
    for dz, dy, dx in taps:
        flat, inside = _tap_index(z0, y0, x0, dz, dy, dx, P, zdim, z_lo)
        w = torch.where(inside, tap_weight(dz, dy, dx), 0.0)
        idx.append(flat.reshape(-1))
        u0.append((w * v0).reshape(-1))
        u1.append((w * v1).reshape(-1))
        u2.append((w * v2).reshape(-1))
    return (torch.cat(idx).to(torch.int32), torch.cat(u0), torch.cat(u1),
            torch.cat(u2))
