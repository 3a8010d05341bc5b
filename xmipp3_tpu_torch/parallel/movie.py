"""Mesh-parallel movie alignment: the patch axis sharded over the ranks.

Counterpart of the reference package's parallel/movie.py. The reference
FlexAlign GPU pipeline runs local (patch) alignment on a stream pool
(movie_alignment_correlation_gpu.cpp:649 std::vector<GPU>); here every
rank of the process group holds the whole movie on its device, measures
the pairwise shifts of its contiguous shard of the patches with the
serial path's own function (ops.movie.local_patch_shifts), and the shards
meet in one all_gather of the (patch, pair) shifts and peaks. The small
per-patch least-squares solves run on the host of every rank.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor
from xmipp3_tpu_torch.ops.movie import (field_from_patch_shifts,
                                        local_patch_shifts, local_patch_size,
                                        patch_grid)
from xmipp3_tpu_torch.parallel.mesh import Mesh, all_gather, shard_rows


def local_align_mesh(mesh: Mesh, frames, global_pos, patches=(5, 5),
                     patch_size: int = 256, max_shift_px: int = 8,
                     axis_name: str = "data", patches_avg: int = 1):
    """Patch-sharded local alignment, with ops.movie.local_align's contract:
    returns the (ny, nx, F, 2) field and the patch centres, on every rank.
    The patch list is padded with copies of its last patch to a multiple of
    the axis size; the copies are measured and dropped."""
    frames = as_tensor(frames, mesh.device)
    F, H, W = frames.shape
    patch_size = local_patch_size(H, W, patch_size)
    ny, nx = patches
    cys, cxs = patch_grid(H, W, ny, nx, patch_size)
    centres = np.array([(cy, cx) for cy in cys for cx in cxs])
    n_patch = len(centres)
    centres = np.concatenate(
        [centres, np.repeat(centres[-1:], (-n_patch) % mesh.shape[axis_name],
                            axis=0)])
    mine = centres[shard_rows(len(centres), mesh, axis_name)]
    shifts, peaks = local_patch_shifts(frames, global_pos, mine, patch_size,
                                       max_shift_px, int(patches_avg))
    both = all_gather(torch.cat([shifts, peaks[..., None]], dim=-1), mesh,
                      axis_name).cpu().numpy()[:n_patch]
    field = field_from_patch_shifts(both[..., :2], both[..., 2], ny, nx, F)
    return field, cys, cxs
