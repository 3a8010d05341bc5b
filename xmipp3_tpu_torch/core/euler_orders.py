"""General Euler-angle machinery over all 24 axis orders.

TPU-native rebuild of the reference's `data/euler.{h,cpp}` (itself following
Graphics Gems IV / Imath): host-side angle bookkeeping, vectorized over
batches of angles with numpy (float64) — no device code needed since this is
metadata math, not image math.

Order encoding (same hex codes as the reference so order values round-trip
through metadata): bits ABCD = initial axis (0/1/2 → 0x0000/0x1000/0x2000),
parity-even (0x0100), initial-repeated (0x0010), frame-static (0x0001).

Angle storage convention (reference euler.h:224-228): the triple (x, y, z)
is in *ijk* order — x is the rotation about the initial axis, etc. —
matching `Euler::x/y/z`. `angle_mapping` converts to/from XYZ layout.
"""
from __future__ import annotations

import numpy as np

ORDERS = {
    "XYZ": 0x0101, "XZY": 0x0001, "YZX": 0x1101, "YXZ": 0x1001,
    "ZXY": 0x2101, "ZYX": 0x2001,
    "XZX": 0x0011, "XYX": 0x0111, "YXY": 0x1011, "YZY": 0x1111,
    "ZYZ": 0x2011, "ZXZ": 0x2111,
    "XYZr": 0x2000, "XZYr": 0x2100, "YZXr": 0x1000, "YXZr": 0x1100,
    "ZXYr": 0x0000, "ZYXr": 0x0100,
    "XZXr": 0x2110, "XYXr": 0x2010, "YXYr": 0x1110, "YZYr": 0x1010,
    "ZYZr": 0x0110, "ZXZr": 0x0010,
}
ORDER_LIST = list(ORDERS.values())
ZYZ = ORDERS["ZYZ"]


def _resolve(order) -> int:
    if isinstance(order, str):
        return ORDERS[order]
    return int(order)


def order_flags(order):
    """(initial_axis, parity_even, initial_repeated, frame_static)."""
    p = _resolve(order)
    axis = 2 if p & 0x2000 else (1 if p & 0x1000 else 0)
    return axis, bool(p & 0x100), bool(p & 0x10), bool(p & 0x1)


def angle_order(order):
    """Rotation axes (i, j, k) in application order."""
    axis, even, _rep, _stat = order_flags(order)
    i = axis
    j = (i + 1) % 3 if even else (i - 1 if i > 0 else 2)
    k = (i - 1 if i > 0 else 2) if even else (i + 1) % 3
    return i, j, k


def angle_mapping(order):
    """Mapping from xyz component order to the stored ijk order."""
    axis, even, _rep, _stat = order_flags(order)
    m = [0, 0, 0]
    m[axis] = 0
    m[(axis + 1) % 3] = 1 if even else 2
    m[(axis + 2) % 3] = 2 if even else 1
    return m[0], m[1], m[2]


def _xyz_rotation(r):
    """The reference's eulerRotate core: the matrix that premultiplies M for
    a rotation given as xyz-component angles r = (rx, ry, rz); batched
    (..., 3) -> (..., 3, 3)."""
    r = np.asarray(r, np.float64)
    cx, cy, cz = np.cos(r[..., 0]), np.cos(r[..., 1]), np.cos(r[..., 2])
    sx, sy, sz = np.sin(r[..., 0]), np.sin(r[..., 1]), np.sin(r[..., 2])
    m = np.empty(r.shape[:-1] + (3, 3), np.float64)
    m[..., 0, 0] = cz * cy
    m[..., 0, 1] = sz * cy
    m[..., 0, 2] = -sy
    m[..., 1, 0] = -sz * cx + cz * sy * sx
    m[..., 1, 1] = cz * cx + sz * sy * sx
    m[..., 1, 2] = cy * sx
    m[..., 2, 0] = sz * sx + cz * sy * cx
    m[..., 2, 1] = -cz * sx + sz * sy * cx
    m[..., 2, 2] = cy * cx
    return m


def euler_rotate(M, r):
    """Premultiply homogeneous matrix M (4x4 or 3x3) by the xyz rotation r
    (the reference Euler::eulerRotate contract)."""
    M = np.asarray(M, np.float64)
    R = _xyz_rotation(np.asarray(r, np.float64))
    out = M.copy()
    out[..., :3, :] = R @ M[..., :3, :]
    return out


def to_matrix(x, y, z, order=ZYZ):
    """Angles (stored ijk layout) -> rotation matrix (batched; (...,3,3))."""
    i, j, k = angle_order(order)
    axis, even, rep, stat = order_flags(order)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    z = np.asarray(z, np.float64)
    a1, a2, a3 = (x, y, z) if stat else (z, y, x)
    if not even:
        a1, a2, a3 = -a1, -a2, -a3
    ci, cj, ch = np.cos(a1), np.cos(a2), np.cos(a3)
    si, sj, sh = np.sin(a1), np.sin(a2), np.sin(a3)
    cc, cs, sc, ss = ci * ch, ci * sh, si * ch, si * sh
    shape = np.broadcast(x, y, z).shape
    M = np.zeros(shape + (3, 3), np.float64)
    if rep:
        M[..., i, i] = cj
        M[..., j, i] = sj * si
        M[..., k, i] = sj * ci
        M[..., i, j] = sj * sh
        M[..., j, j] = -cj * ss + cc
        M[..., k, j] = -cj * cs - sc
        M[..., i, k] = -sj * ch
        M[..., j, k] = cj * sc + cs
        M[..., k, k] = cj * cc - ss
    else:
        M[..., i, i] = cj * ch
        M[..., j, i] = sj * sc - cs
        M[..., k, i] = sj * cc + ss
        M[..., i, j] = cj * sh
        M[..., j, j] = sj * ss + cc
        M[..., k, j] = sj * cs - sc
        M[..., i, k] = -sj
        M[..., j, k] = cj * si
        M[..., k, k] = cj * ci
    return M


def extract(M, order=ZYZ):
    """Rotation matrix -> angles (x, y, z in stored ijk layout); batched.

    Gimbal-lock-safe two-stage extraction (remove the first rotation, then
    read the remaining two off the reduced matrix)."""
    i, j, k = angle_order(order)
    axis, even, rep, stat = order_flags(order)
    M = np.asarray(M, np.float64)[..., :3, :3]
    shape = M.shape[:-2]
    if rep:
        x = np.arctan2(M[..., j, i], M[..., k, i])
        r = np.zeros(shape + (3,), np.float64)
        r[..., i] = -x if even else x
        N = _xyz_rotation(r) @ M
        sy = np.sqrt(N[..., j, i] ** 2 + N[..., k, i] ** 2)
        y = np.arctan2(sy, N[..., i, i])
        z = np.arctan2(N[..., j, k], N[..., j, j])
    else:
        x = np.arctan2(M[..., j, k], M[..., k, k])
        r = np.zeros(shape + (3,), np.float64)
        r[..., i] = -x if even else x
        N = _xyz_rotation(r) @ M
        cy = np.sqrt(N[..., i, i] ** 2 + N[..., i, j] ** 2)
        y = np.arctan2(-N[..., i, k], cy)
        z = np.arctan2(-N[..., j, i], N[..., j, j])
    if not even:
        x, y, z = -x, -y, -z
    if not stat:
        x, z = z, x
    return x, y, z


def angle_mod(angle):
    """Wrap to [-pi, pi]."""
    a = np.mod(np.asarray(angle, np.float64), 2 * np.pi)
    a = np.where(a < -np.pi, a + 2 * np.pi, a)
    return np.where(a > np.pi, a - 2 * np.pi, a)


def simple_xyz_rotation(xyz, target):
    """Adjust xyz so each component differs from target by at most pi."""
    xyz = np.asarray(xyz, np.float64)
    target = np.asarray(target, np.float64)
    return target + angle_mod(xyz - target)


def nearest_rotation(xyz, target, order=ORDERS["XYZ"]):
    """The equivalent rotation triple (either xyz or its flipped twin
    (pi+x, pi-y, pi+z)) closest to target, componentwise-wrapped."""
    a = simple_xyz_rotation(xyz, target)
    other = simple_xyz_rotation(
        np.stack([np.pi + np.asarray(xyz, np.float64)[..., 0],
                  np.pi - np.asarray(xyz, np.float64)[..., 1],
                  np.pi + np.asarray(xyz, np.float64)[..., 2]], axis=-1),
        target)
    da = np.sum((a - target) ** 2, axis=-1, keepdims=True)
    do = np.sum((other - target) ** 2, axis=-1, keepdims=True)
    return np.where(do < da, other, a)
