"""Batched 2-D affine warp (reference swiftalign/transform/affine_2d.py:
kornia affine -> the port's bilinear or B-spline warp on the card)."""
from __future__ import annotations

import numpy as np


def affine_2d(images, matrices, interpolation: str = "bilinear",
              padding: str = "zeros", out=None, device=None):
    """images (B, H, W); matrices (B, 2, 3) or (B, 3, 3) in centered
    logical (x, y) coordinates, input->output (the port's
    ops.geo.apply_affine_2d convention) — compose them with
    affine_matrix_2d. Warps on `device` (the card by default) and returns
    the warped stack as numpy."""
    from xmipp3_tpu_torch.ops.geo import apply_affine_2d
    images = np.asarray(images, np.float32)
    matrices = np.asarray(matrices, np.float32)
    if matrices.ndim == 2:
        matrices = matrices[None]
    if matrices.shape[-2:] == (2, 3):
        M = np.tile(np.eye(3, dtype=np.float32), (len(matrices), 1, 1))
        M[:, :2, :] = matrices
    else:
        M = matrices
    order = 1 if interpolation == "bilinear" else 3
    res = apply_affine_2d(images, M, order=order,
                          device=device).cpu().numpy()
    if out is not None:
        out[...] = res
        return out
    return res
