"""Data-parallel and kz-slab Fourier reconstruction over the ranks of a mesh.

Counterpart of the reference package's parallel/reconstruct.py (the
mpi_reconstruct_fourier replacement: per-node partial Fourier volumes and
one reduction). Every rank backprojects its share into cubes of its own on
its device, in chunks of `batch` particles, and the ranks meet once:

  parallel_reconstruct  particles sharded over the data axis, full cubes,
                        one all_reduce(SUM) of the three accumulators;
  slab_reconstruct      particles replicated, each rank grids only its
                        z-slab of the cube (backproject_chunk's kz-slab
                        mode), the slabs all_gather'ed into the full cube;
  slab_reconstruct_2d   particles sharded over "data" and the cube over
                        "z": all_reduce over data, all_gather over z;
  parallel_art_correction
                        one ART block: its projections dealt to the ranks,
                        each rank projects the volume at its poses, forms
                        the residuals and grids them (K2), and one
                        all_reduce of the cubes and the residual sum and
                        one of max |residual| join them.

--useCTF (ctfp=): each rank computes the CTF factor table of the rows it
grids (its shard, or every row for a slab rank), a chunk at a time, and
reuses it across the symmetry loop (_ctf_tables).

P is padded to a multiple of the z size, as in the reference, so a slab
volume differs slightly from the serial one where the z size does not
divide P. Every rank finalizes the full cube and returns the (N, N, N)
volume on its device (replicated, as the reference returns it). Chunking
changes only the order of the float adds.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.geometry import euler_matrix
from xmipp3_tpu_torch.core.sym import SymList
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.ops.reconstruct import (backproject_chunk,
                                              ctf_gridding_multipliers,
                                              finalize_volume)
from xmipp3_tpu_torch.parallel.mesh import (all_gather, all_reduce,
                                            pad_to_multiple, shard_rows)


def _ctf_tables(ctfp, sampling, min_ctf, N, max_freq, phase_flipped,
                device):
    """A function of a row slice that returns that chunk's (C, S) CTF
    data/weight gridding multipliers on `device`, or (None, None) when
    --useCTF is off. ctfp: dict of (B,) arrays, padded like the rows (the
    padded rows weigh 0)."""
    def tables(sl):
        if ctfp is None:
            return None, None
        return ctf_gridding_multipliers(
            {k: v[sl] for k, v in ctfp.items()}, sampling, min_ctf, N,
            max_freq, phase_flipped, device=device)
    return tables


def _padded_ctf(ctfp, multiple: int):
    """ctfp with each (B,) array padded to a multiple of `multiple` rows by
    repeating the last row (padded rows weigh 0)."""
    if ctfp is None:
        return None
    return {k: np.pad(np.asarray(v, np.float32), (0, (-len(v)) % multiple),
                      mode="edge") for k, v in ctfp.items()}


def _padded_size(N: int, pad_factor: float, multiple: int = 1) -> int:
    P = int(round(N * pad_factor))
    P += P % 2
    return P + (-P) % multiple                # slabs must tile the cube


def _poses(B, rot, tilt, psi, sx, sy, weights, multiple: int):
    """Euler matrices, shifts and weights of B particles padded to a
    multiple of `multiple` rows; padded rows weigh 0."""
    z = np.zeros(B, np.float32)
    get = lambda v: pad_to_multiple(
        z if v is None else np.asarray(v, np.float32), multiple)[0]
    w = get(np.ones(B, np.float32) if weights is None else weights).copy()
    w[B:] = 0.0
    mats = np.asarray(euler_matrix(get(rot), get(tilt), get(psi)),
                      np.float32)
    return mats, get(sx), get(sy), w


def _grid(mesh, imgs, mats, sx, sy, w, P: int, max_freq, interp, batch,
          tables, sym="c1", slab_p=None, slab_z0=0):
    """Backproject rows of one rank in chunks into new accumulators on its
    device: (P, P, P), or (slab_p, P, P) from plane slab_z0. tables(sl)
    gives a chunk's CTF factors (_ctf_tables)."""
    zdim = P if slab_p is None else slab_p
    acc = [torch.zeros((zdim, P, P), dtype=torch.float32, device=mesh.device)
           for _ in range(3)]
    for s in range(0, len(imgs), batch):
        sl = slice(s, s + batch)
        chunk = torch.as_tensor(np.ascontiguousarray(imgs[sl]),
                                device=mesh.device)
        with timed_phase("add_batch", sync=acc[0]):
            ctf_data, ctf_w = tables(sl)
            for S in SymList(sym).sym_matrices():
                m = np.einsum("cij,jk->cik", mats[sl], S.astype(np.float32))
                backproject_chunk(*acc, chunk, m, sx[sl], sy[sl], w[sl], P,
                                  max_freq, slab_p=slab_p, slab_z0=slab_z0,
                                  interp=interp, ctf_data=ctf_data,
                                  ctf_w=ctf_w)
    return acc


def _finish(acc, N, P, interp, niter_weight):
    with timed_phase("finish", sync=acc[0]):
        return finalize_volume(*acc, N, P, interp=interp,
                               niter_weight=niter_weight)


def parallel_reconstruct(mesh, imgs, rot, tilt, psi, sx=None, sy=None,
                         weights=None, pad_factor: float = 2.0,
                         sym: str = "c1", max_freq: float = 0.5,
                         axis_name: str = "data", flip=None,
                         interp: str = "kb", niter_weight: int = 1,
                         ctfp=None, sampling: float = 1.0,
                         min_ctf: float = 0.01, phase_flipped: bool = False,
                         batch: int = 256):
    """Reconstruct a volume with the particle axis sharded over `mesh`.

    imgs: (B, N, N) float32, the whole stack on every rank (padded to a
    mesh multiple here; each rank grids its contiguous shard). Returns the
    (N, N, N) volume on the rank's device. ctfp: optional dict of (B,)
    CTF parameter arrays (--useCTF); the rank grids its own rows' CTF
    factors."""
    imgs = np.asarray(imgs, np.float32)
    if flip is not None and np.any(flip):
        # stored flip: backproject the x-mirrored image with negated
        # shiftX (as FourierReconstructor.add_batch does)
        f = np.asarray(flip).astype(bool)
        imgs = np.where(f[:, None, None], imgs[:, :, ::-1], imgs)
        sx = np.zeros(len(imgs), np.float32) if sx is None \
            else np.asarray(sx, np.float32).copy()
        sx[f] = -sx[f]
    B, N, _ = imgs.shape
    n_dev = mesh.shape[axis_name]
    P = _padded_size(N, pad_factor)
    imgs_p, _ = pad_to_multiple(imgs, n_dev)
    mats, sx_p, sy_p, w_p = _poses(B, rot, tilt, psi, sx, sy, weights, n_dev)
    sl = shard_rows(len(imgs_p), mesh, axis_name)
    ctf_p = _padded_ctf(ctfp, n_dev)
    tables = _ctf_tables(None if ctf_p is None else
                         {k: v[sl] for k, v in ctf_p.items()}, sampling,
                         min_ctf, N, max_freq, phase_flipped, mesh.device)
    acc = _grid(mesh, imgs_p[sl], mats[sl], sx_p[sl], sy_p[sl], w_p[sl], P,
                max_freq, interp, batch, tables, sym=sym)
    # the MPI_Reduce replacement: one all_reduce over the data axis
    with timed_phase("reduce", sync=acc[0]):
        for a in acc:
            all_reduce(a, mesh, axis_name)
    return _finish(acc, N, P, interp, niter_weight)


def slab_reconstruct(mesh, imgs, rot, tilt, psi, sx=None, sy=None,
                     weights=None, pad_factor: float = 2.0,
                     max_freq: float = 0.5, axis_name: str = "data",
                     interp: str = "kb", niter_weight: int = 1,
                     ctfp=None, sampling: float = 1.0,
                     min_ctf: float = 0.01, phase_flipped: bool = False,
                     batch: int = 256):
    """Volume-sharded (kz-slab) reconstruction: each rank owns one z-slab
    of the Fourier cube. Images are replicated; every rank computes the
    full sample stream and keeps the updates that land in its slab, so the
    ranks do not meet during backprojection. The slabs are gathered before
    the finalize step (Hermitian symmetrization and inverse FFT), which
    crosses slab boundaries. With ctfp every rank computes the CTF factors
    of every row, as it grids every row."""
    imgs = np.asarray(imgs, np.float32)
    B, N, _ = imgs.shape
    n_dev = mesh.shape[axis_name]
    P = _padded_size(N, pad_factor, n_dev)
    slab_p = P // n_dev
    mats, sx_a, sy_a, w = _poses(B, rot, tilt, psi, sx, sy, weights, 1)
    tables = _ctf_tables(ctfp, sampling, min_ctf, N, max_freq,
                         phase_flipped, mesh.device)
    acc = _grid(mesh, imgs, mats, sx_a, sy_a, w, P, max_freq, interp, batch,
                tables, slab_p=slab_p, slab_z0=mesh.coords[axis_name] * slab_p)
    with timed_phase("reduce", sync=acc[0]):
        acc = [all_gather(a, mesh, axis_name) for a in acc]
    return _finish(acc, N, P, interp, niter_weight)


def slab_reconstruct_2d(mesh, imgs, rot, tilt, psi, sx=None, sy=None,
                        weights=None, pad_factor: float = 2.0,
                        max_freq: float = 0.5, data_axis: str = "data",
                        z_axis: str = "z", interp: str = "kb",
                        niter_weight: int = 1,
                        ctfp=None, sampling: float = 1.0,
                        min_ctf: float = 0.01, phase_flipped: bool = False,
                        batch: int = 256):
    """dp x slab 2-D-mesh reconstruction: the particle axis is sharded over
    `data_axis` and the Fourier cube over `z_axis`. Each rank backprojects
    only its image shard into its z-slab; one all_reduce along the data
    axis fuses the image shards, and the slabs are gathered along z.

    mesh must carry both axes (resolve_mesh("slab2d") gives (n/2, 2))."""
    imgs = np.asarray(imgs, np.float32)
    B, N, _ = imgs.shape
    n_data, n_z = mesh.shape[data_axis], mesh.shape[z_axis]
    P = _padded_size(N, pad_factor, n_z)
    slab_p = P // n_z
    imgs_p, _ = pad_to_multiple(imgs, n_data)
    mats, sx_p, sy_p, w_p = _poses(B, rot, tilt, psi, sx, sy, weights,
                                   n_data)
    sl = shard_rows(len(imgs_p), mesh, data_axis)
    ctf_p = _padded_ctf(ctfp, n_data)
    tables = _ctf_tables(None if ctf_p is None else
                         {k: v[sl] for k, v in ctf_p.items()}, sampling,
                         min_ctf, N, max_freq, phase_flipped, mesh.device)
    acc = _grid(mesh, imgs_p[sl], mats[sl], sx_p[sl], sy_p[sl], w_p[sl], P,
                max_freq, interp, batch, tables, slab_p=slab_p,
                slab_z0=mesh.coords[z_axis] * slab_p)
    with timed_phase("reduce", sync=acc[0]):
        acc = [all_gather(all_reduce(a, mesh, data_axis), mesh, z_axis)
               for a in acc]
    return _finish(acc, N, P, interp, niter_weight)


def parallel_art_correction(mesh, vol, imgs, rot, tilt, psi,
                            pad_factor: float = 2.0, max_freq: float = 0.5,
                            axis_name: str = "data", interp: str = "tri"):
    """One ART block update, data-parallel: project the current volume at
    the block's poses, form residuals and backproject them, with the
    block's projections sharded over the mesh and one all_reduce fusing the
    partial cubes (the reference distributes ART blocks across MPI workers
    the same way, basic_art.h:92-116). The block is padded to a multiple of
    the ranks with rows of weight 0, as in the reference.

    vol: (N, N, N) tensor or array, the same on every rank; imgs: the
    block's (B, N, N) projections. Returns (correction volume (N, N, N) on
    the rank's device, residual sum of squares, max |residual|) — what
    art_reconstruct's mode family needs."""
    from xmipp3_tpu_torch.ops.art import _forward
    dev = mesh.device
    imgs = torch.as_tensor(imgs, dtype=torch.float32, device=dev)
    B, N, _ = imgs.shape
    n_dev = mesh.shape[axis_name]
    P = _padded_size(N, pad_factor)
    pad = (-B) % n_dev
    if pad:
        imgs = torch.cat([imgs, imgs.new_zeros((pad, N, N))])
    mats, _, _, w = _poses(B, rot, tilt, psi, None, None, None, n_dev)
    sl = shard_rows(B + pad, mesh, axis_name)
    w_l = torch.as_tensor(w[sl], device=dev)
    vol = torch.as_tensor(vol, dtype=torch.float32, device=dev)
    resid = (imgs[sl] - _forward(vol, mats[sl], N, pad_factor)) \
        * w_l[:, None, None]
    ss = (resid ** 2).sum()
    rmax = resid.abs().max() if len(resid) else ss.new_zeros(())
    z = np.zeros(len(resid), np.float32)
    acc = [torch.zeros((P, P, P), dtype=torch.float32, device=dev)
           for _ in range(3)]
    backproject_chunk(*acc, resid, mats[sl], z, z, w[sl], P, max_freq,
                      interp=interp)
    for a in (*acc, ss):
        all_reduce(a, mesh, axis_name)
    all_reduce(rmax, mesh, axis_name, op="max")
    corr = finalize_volume(*acc, N, P, interp=interp)
    return corr, float(ss), float(rmax)
