"""Mesh engines of the remaining program families (counterpart of the
reference package's parallel/engines.py: `shard_batch`,
`parallel_pca_components`, `parallel_refine_defocus`,
`parallel_class_sums` and `parallel_filter_bank`).

The reference expresses each engine's data parallelism as an input
sharding that XLA partitions. Here every rank of the process group takes
its contiguous shard of the padded sample axis (`shard_rows`), runs the
serial engine on it on its own device, and the shards meet in one
all_gather; the pads are dropped after it. The PCA moments, the class
sums and the filter bank's sums meet in one all_reduce instead.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.parallel.mesh import (Mesh, all_gather, all_reduce,
                                            pad_to_multiple, shard_rows)


def pad_repeat_first(a, multiple: int):
    """a (n, ...) padded to a multiple of `multiple` rows by repeating row
    0 (a zero row would make a normalized correlation's gradient NaN at
    sqrt(0)), as float32 numpy."""
    a = np.asarray(a, np.float32)
    rep = (-len(a)) % multiple
    if rep:
        a = np.concatenate([a, np.broadcast_to(a[:1], (rep,) + a.shape[1:])])
    return a


def shard_batch(arr, mesh: Mesh, axis_name: str = "data"):
    """This rank's contiguous rows of axis 0 of `arr` (its length a
    multiple of the axis size: pad first) as a float32 tensor on the
    rank's device. The reference device_puts the whole batch with a
    NamedSharding over axis 0; here each rank holds only its own rows,
    and the results meet in `gather_batch`."""
    sl = shard_rows(len(arr), mesh, axis_name)
    return torch.as_tensor(np.ascontiguousarray(np.asarray(
        arr, np.float32)[sl]), device=mesh.device)


def gather_batch(t: torch.Tensor, mesh: Mesh, n_valid: int,
                 axis_name: str = "data") -> torch.Tensor:
    """Every rank's rows of a sharded batch, in row order, with the padded
    rows after n_valid dropped."""
    return all_gather(t.contiguous(), mesh, axis_name)[:n_valid]


def parallel_pca_components(mesh: Mesh, X, n_eig: int,
                            axis_name: str = "data"):
    """Top-`n_eig` principal components (n_eig, D) of X (samples, D; an
    array, or a tensor already on the rank's device), as numpy float64,
    with the sample axis sharded over the mesh (the
    mpi_image_rotational_pca analog; the reference distributes its
    H-matrix accumulations over MPI ranks, image_rotational_pca.h:41).

    Each rank sums s1 = sum x and X^T X over its contiguous share of the
    rows in float32 (as the reference computes them), one all_reduce fuses
    both, and every rank takes the eigendecomposition of
    the centred float64 covariance on its device (a host eigh of 16,384^2
    takes minutes). Equal to the serial SVD's components up to sign."""
    from xmipp3_tpu_torch.device import as_tensor, fp32_products
    X = as_tensor(X, mesh.device)
    n, D = X.shape
    per = -(-n // mesh.shape[axis_name])
    mine = X[per * mesh.coords[axis_name]:per * (mesh.coords[axis_name] + 1)]
    acc = torch.empty((D + 1, D), device=mesh.device)
    acc[0] = mine.sum(dim=0)
    with fp32_products():
        torch.matmul(mine.T, mine, out=acc[1:])
    acc = all_reduce(acc, mesh, axis_name).to(torch.float64)
    mu = acc[0] / n
    # centered covariance from raw moments: C - n mu mu^T
    _, V = torch.linalg.eigh(acc[1:] - n * torch.outer(mu, mu))
    return V.flip(1)[:, :n_eig].T.contiguous().cpu().numpy()


def parallel_refine_defocus(mesh: Mesh, psds, seed_params, sampling,
                            axis_name: str = "data", **kwargs):
    """refine_defocus_batch with the region axis sharded over the mesh
    (ctf_estimate_from_micrograph --mode regions is embarrassingly
    parallel over grid regions; the reference farms regions to MPI
    workers). Padded regions are fit too (same compute) and dropped.
    Every rank returns the whole (R, NPARAMS) result (numpy)."""
    from xmipp3_tpu_torch.models.ctf_estimation import refine_defocus_batch
    if isinstance(psds, torch.Tensor):
        psds = psds.cpu().numpy()
    psds = np.asarray(psds, np.float32)
    psds_p, n_valid = pad_to_multiple(psds, mesh.shape[axis_name])
    mine = psds_p[shard_rows(len(psds_p), mesh, axis_name)]
    out = refine_defocus_batch(mine, seed_params, sampling,
                               device=mesh.device, **kwargs)
    out = all_gather(torch.as_tensor(out, device=mesh.device), mesh,
                     axis_name)
    return out.cpu().numpy()[:n_valid]


def parallel_class_sums(mesh: Mesh, imgs, psi, sx, sy, flip, assign,
                        n_refs: int, sel_weights=None,
                        axis_name: str = "data"):
    """Class-average accumulation with the particle axis sharded over the
    mesh (the mpi_angular_class_average work split): each rank registers
    its particle shard (apply_md_geometry) and adds it into the class sums
    with index_add_, weighted by sel_weights (B,) (0/1: the --select/--limit
    rejections, or a --split half); one all_reduce fuses (sums, counts).

    Returns (sums (K, H, W), counts (K,)) as host arrays on every rank."""
    from xmipp3_tpu_torch.ops.geo import apply_md_geometry
    dev = mesh.device
    imgs = np.asarray(imgs, np.float32)
    B, H, W = imgs.shape
    n = mesh.shape[axis_name]
    w = np.ones(B, np.float32) if sel_weights is None \
        else np.asarray(sel_weights, np.float32)
    pad = lambda v: pad_to_multiple(np.asarray(v), n)[0]
    # padded rows weigh 0 and add nothing
    sl = shard_rows(len(pad(w)), mesh, axis_name)
    mine = lambda v, dt=torch.float32: torch.as_tensor(
        np.ascontiguousarray(pad(v)[sl]), dtype=dt, device=dev)
    w_l = mine(w)
    reg = apply_md_geometry(mine(imgs), mine(psi), mine(sx), mine(sy),
                            mine(flip) > 0.5)
    a_l = mine(np.asarray(assign, np.int64), torch.int64)
    acc = torch.zeros(n_refs, H * W + 1, device=dev)
    acc[:, :-1].index_add_(0, a_l, reg.reshape(len(reg), -1) * w_l[:, None])
    acc[:, -1].index_add_(0, a_l, w_l)
    acc = all_reduce(acc, mesh, axis_name).cpu().numpy()
    return acc[:, :-1].reshape(n_refs, H, W), acc[:, -1]


def parallel_filter_bank(mesh: Mesh, v1r, v2r, r2, shape, bank_step,
                         bank_overlap, weight_fun, weight_power,
                         axis_name: str = "data"):
    """The halves-restoration filter bank with its bands dealt to the ranks
    in turn (the cuda_volume_halves_restoration per-band loop): each rank
    sums its bands (ops.halves_restoration.filter_bank_bands), one
    all_reduce fuses the three sums. Bands are independent, so the result
    is the serial one up to the order of the sums. Returns (m_v1r, m_v2r,
    m_s) as tensors on the rank's device."""
    from xmipp3_tpu_torch.ops import halves_restoration as hr
    dev = mesh.device
    n, i = mesh.shape[axis_name], mesh.coords[axis_name]
    filter_step = bank_step * (1.0 - bank_overlap)
    ws = np.arange(hr.n_bands(bank_step, bank_overlap),
                   dtype=np.float32) * np.float32(filter_step)
    v1r, v2r = (torch.as_tensor(v, dtype=torch.float32, device=dev)
                for v in (v1r, v2r))
    r2 = torch.as_tensor(r2, device=dev)
    m = torch.stack(hr.filter_bank_bands(
        torch.fft.rfftn(v1r), torch.fft.rfftn(v2r), r2, shape, ws[i::n],
        bank_step, weight_fun, weight_power))
    m = all_reduce(m, mesh, axis_name) * (1.0 - bank_overlap)
    return m[0], m[1], m[2]
