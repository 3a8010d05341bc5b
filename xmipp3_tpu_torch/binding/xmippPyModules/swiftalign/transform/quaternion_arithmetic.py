from __future__ import annotations

import numpy as np


def quaternion_product(a, b):
    """Hamilton product of (.., 4) quaternion arrays (w, x, y, z)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    w1, x1, y1, z1 = np.moveaxis(a, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(b, -1, 0)
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], axis=-1)


def quaternion_conj(q):
    q = np.asarray(q, np.float64).copy()
    q[..., 1:] *= -1
    return q
