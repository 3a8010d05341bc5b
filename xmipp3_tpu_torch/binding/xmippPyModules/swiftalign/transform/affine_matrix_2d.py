from __future__ import annotations

import numpy as np


def affine_matrix_2d(angles=None, shifts=None, scale=None, device=None):
    """(B, 3, 3) affine matrices in centered logical (x, y) coordinates
    from in-plane angles (deg) and shifts — the matrix that, fed to
    affine_2d, rotates each image by `angle` and shifts it by `shift`
    (reference affine_matrix_2d role; the port's convention of
    ops.geo.alignment_matrices_2d, built on `device`, the card by
    default, and returned as numpy)."""
    from xmipp3_tpu_torch.ops.geo import alignment_matrices_2d
    angles = np.zeros(1) if angles is None else np.atleast_1d(angles)
    B = len(angles)
    shifts = np.zeros((B, 2)) if shifts is None else \
        np.broadcast_to(np.asarray(shifts, np.float64), (B, 2))
    sc = None if scale is None else \
        np.broadcast_to(np.asarray(scale, np.float32), (B,))
    return alignment_matrices_2d(
        np.asarray(angles, np.float32),
        shifts[:, 0].astype(np.float32), shifts[:, 1].astype(np.float32),
        scale=sc, device=device).cpu().numpy()
