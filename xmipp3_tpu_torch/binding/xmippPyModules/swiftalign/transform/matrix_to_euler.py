from __future__ import annotations

import numpy as np


def matrix_to_euler(matrices):
    """Rotation matrices (B, 3, 3) -> (rot, tilt, psi) degrees."""
    from xmipp3_tpu_torch.core.geometry import matrix_to_euler as _m2e
    matrices = np.asarray(matrices, np.float64)
    if matrices.ndim == 2:
        matrices = matrices[None]
    out = np.array([_m2e(m) for m in matrices])
    return out[:, 0], out[:, 1], out[:, 2]
