"""Mesh engines of the remaining program families (counterpart of the
reference package's parallel/engines.py; so far its
`parallel_refine_defocus`).

The reference expresses each engine's data parallelism as an input
sharding that XLA partitions. Here every rank of the process group takes
its contiguous shard of the padded sample axis (`shard_rows`), runs the
serial engine on it on its own device, and the shards meet in one
all_gather; the pads are dropped after it.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.parallel.mesh import (Mesh, all_gather,
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
