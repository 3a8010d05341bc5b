from __future__ import annotations

import numpy as np


def quaternion_to_matrix(q):
    """Unit quaternions (B, 4) (w, x, y, z) -> rotation matrices
    (B, 3, 3)."""
    q = np.asarray(q, np.float64)
    if q.ndim == 1:
        q = q[None]
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    n = np.maximum(w * w + x * x + y * y + z * z, 1e-30)
    w, x, y, z = w / np.sqrt(n), x / np.sqrt(n), y / np.sqrt(n), \
        z / np.sqrt(n)
    M = np.empty((len(q), 3, 3))
    M[:, 0, 0] = 1 - 2 * (y * y + z * z)
    M[:, 0, 1] = 2 * (x * y - z * w)
    M[:, 0, 2] = 2 * (x * z + y * w)
    M[:, 1, 0] = 2 * (x * y + z * w)
    M[:, 1, 1] = 1 - 2 * (x * x + z * z)
    M[:, 1, 2] = 2 * (y * z - x * w)
    M[:, 2, 0] = 2 * (x * z - y * w)
    M[:, 2, 1] = 2 * (y * z + x * w)
    M[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return M
