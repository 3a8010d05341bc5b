from __future__ import annotations

import numpy as np


def euler_to_matrix(rot, tilt, psi):
    """ZYZ Euler angles (deg) -> passive rotation matrices (B, 3, 3) —
    identical convention to the framework core (core/geometry.py) and the
    reference's Euler_angles2matrix."""
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    rot = np.atleast_1d(np.asarray(rot, np.float32))
    tilt = np.atleast_1d(np.asarray(tilt, np.float32))
    psi = np.atleast_1d(np.asarray(psi, np.float32))
    return np.asarray(euler_matrix(rot, tilt, psi))
