"""Mesh engines of the remaining program families (counterpart of the
reference package's parallel/engines.py; so far its
`parallel_refine_defocus` and `parallel_class_sums`).

The reference expresses each engine's data parallelism as an input
sharding that XLA partitions. Here every rank of the process group takes
its contiguous shard of the padded sample axis (`shard_rows`), runs the
serial engine on it on its own device, and the shards meet in one
all_gather; the pads are dropped after it. The class sums meet in one
all_reduce instead.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.parallel.mesh import (Mesh, all_gather, all_reduce,
                                            pad_to_multiple, shard_rows)


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
