"""ZYZ Euler -> quaternion (w, x, y, z), matching euler_to_matrix up to
sign (reference swiftalign/transform/euler_to_quaternion.py role)."""
from __future__ import annotations

import numpy as np


def euler_to_quaternion(rot, tilt, psi, out=None):
    rot = np.radians(np.atleast_1d(np.asarray(rot, np.float64)))
    tilt = np.radians(np.atleast_1d(np.asarray(tilt, np.float64)))
    psi = np.radians(np.atleast_1d(np.asarray(psi, np.float64)))
    # ZYZ: q = qz(rot) * qy(tilt) * qz(psi)
    hr, ht, hp = rot / 2, tilt / 2, psi / 2
    qw = np.cos(ht) * np.cos(hr + hp)
    qx = -np.sin(ht) * np.sin(hr - hp)
    qy = np.sin(ht) * np.cos(hr - hp)
    qz = np.cos(ht) * np.sin(hr + hp)
    q = np.stack([qw, qx, qy, qz], axis=-1)
    if out is not None:
        out[...] = q
        return out
    return q
