"""Geometry: Euler conventions, rotation matrices, alignment transforms.

Contract: Xmipp's ZYZ Euler convention (xmippCore core/geometry.h /
transformations.h, used by every angular program; SURVEY.md §1.1):
    A(rot, tilt, psi) = Rz(psi) · Ry(tilt) · Rz(rot)
with the "passive" row-rotation form Rz(t) = [[c, s, 0], [-s, c, 0], [0, 0, 1]].
Rows of A are the projection-plane axes expressed in volume coordinates; the
projection direction is A[2] (the rotated z axis).

Centered-origin convention: logical origin of an n-pixel axis sits at index
floor(n/2) (xmipp FIRST_XMIPP_INDEX = -floor(n/2)).

All functions take and return numpy arrays and are batch-friendly (leading
dims broadcast).
"""
from __future__ import annotations

import numpy as np

def euler_matrix(rot, tilt, psi, degrees: bool = True):
    """ZYZ Euler angles -> 3x3 matrix (batched over leading dims)."""
    xp = np
    rot, tilt, psi = (xp.asarray(a, dtype=xp.float32) for a in (rot, tilt, psi))
    if degrees:
        rot, tilt, psi = (xp.deg2rad(a) for a in (rot, tilt, psi))
    c1, s1 = xp.cos(rot), xp.sin(rot)
    c2, s2 = xp.cos(tilt), xp.sin(tilt)
    c3, s3 = xp.cos(psi), xp.sin(psi)
    row0 = xp.stack([c3 * c2 * c1 - s3 * s1, c3 * c2 * s1 + s3 * c1, -c3 * s2],
                    axis=-1)
    row1 = xp.stack([-s3 * c2 * c1 - c3 * s1, -s3 * c2 * s1 + c3 * c1, s3 * s2],
                    axis=-1)
    row2 = xp.stack([s2 * c1, s2 * s1, c2], axis=-1)
    return xp.stack([row0, row1, row2], axis=-2)


def matrix_to_euler(A):
    """Inverse of euler_matrix (degrees). Matches Euler_matrix2angles."""
    A = np.asarray(A, dtype=np.float64)
    abs_sb = np.sqrt(A[0, 2] ** 2 + A[1, 2] ** 2)
    if abs_sb > 16 * np.finfo(np.float64).eps:
        gamma = np.arctan2(A[1, 2], -A[0, 2])
        alpha = np.arctan2(A[2, 1], A[2, 0])
        if abs(np.sin(gamma)) < np.finfo(np.float64).eps:
            sign_sb = np.sign(-A[0, 2] / np.cos(gamma))
        else:
            sign_sb = np.sign(A[1, 2]) if np.sin(gamma) > 0 else -np.sign(A[1, 2])
        beta = np.arctan2(sign_sb * abs_sb, A[2, 2])
    else:
        if np.sign(A[2, 2]) > 0:
            alpha = 0.0
            beta = 0.0
            gamma = np.arctan2(-A[1, 0], A[0, 0])
        else:
            alpha = 0.0
            beta = np.pi
            gamma = np.arctan2(A[1, 0], -A[0, 0])
    return (np.degrees(alpha), np.degrees(beta), np.degrees(gamma))


def rotation2d_matrix(angle, degrees: bool = True):
    """2D rotation (3x3 homogeneous, image convention).

    Matches xmipp rotation2DMatrix: rotating an image by +angle rotates
    features counter-clockwise when y points down-to-up in logical coords.
    """
    xp = np
    a = np.deg2rad(angle) if degrees else angle
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]],
                    dtype=np.float32)


def translation2d_matrix(sx, sy):
    return np.array([[1.0, 0.0, sx], [0.0, 1.0, sy], [0.0, 0.0, 1.0]],
                    dtype=np.float32)


def alignment_matrix_2d(psi=0.0, shiftx=0.0, shifty=0.0, flip=False,
                        scale=1.0, degrees=True):
    """Compose the 2D alignment transform used by metadata geometry
    (anglePsi/shiftX/shiftY/flip columns): A = T(shift) · S(scale) · R(psi),
    optionally premultiplied by an x-mirror."""
    A = rotation2d_matrix(psi, degrees)
    A[:2, :] *= scale
    A = translation2d_matrix(shiftx, shifty) @ A
    if flip:
        M = np.diag([-1.0, 1.0, 1.0]).astype(np.float32)
        A = M @ A
    return A


def center_of(n: int) -> int:
    """Index of the logical origin of an n-sample axis."""
    return n // 2


def frequency_grid(shape, real: bool = True):
    """Normalized frequency grids (cycles/pixel in [-0.5, 0.5)).

    Returns (fy, fx) for 2D or (fz, fy, fx) for 3D, each of the rfft layout
    when real=True (last axis halved)."""
    axes = []
    nd = len(shape)
    for i, n in enumerate(shape):
        if real and i == nd - 1:
            f = np.fft.rfftfreq(n).astype(np.float32)
        else:
            f = np.fft.fftfreq(n).astype(np.float32)
        axes.append(f)
    return np.meshgrid(*axes, indexing="ij")


def geo_to_transformation_matrix(geo: dict, dim: int = 2,
                                 only_apply_shifts: bool = False):
    """Metadata geometry record -> homogeneous transformation matrix
    (3x3 for dim=2, 4x4 for dim=3) — the geo2TransformationMatrix contract
    (xmippCore transformations.h; roundtrip behavior pinned by
    function_tests/test_transformation_main.cpp geo2TransformationMatrix).

    geo keys (all optional): rot, tilt, psi (deg), x, y, z, scale, flip.
    Convention: linear part = scale · Fx(flip) · R, translation = shifts
    (post-rotation, like alignment_matrix_2d)."""
    psi = float(geo.get("psi", 0.0))
    scale = float(geo.get("scale", 1.0))
    flip = bool(geo.get("flip", False))
    x = float(geo.get("x", 0.0))
    y = float(geo.get("y", 0.0))
    if only_apply_shifts:
        psi, scale, flip = 0.0, 1.0, False
    if dim == 2:
        A = np.eye(3, dtype=np.float64)
        a = np.deg2rad(psi)
        c, s = np.cos(a), np.sin(a)
        R = np.array([[c, s], [-s, c]], np.float64)
        if flip:
            R = np.diag([-1.0, 1.0]) @ R
        A[:2, :2] = scale * R
        A[0, 2] = x
        A[1, 2] = y
        return A
    rot = float(geo.get("rot", 0.0))
    tilt = float(geo.get("tilt", 0.0))
    z = float(geo.get("z", 0.0))
    if only_apply_shifts:
        rot = tilt = 0.0
    A = np.eye(4, dtype=np.float64)
    from xmipp3_tpu_torch.core import euler_orders as _eo
    # float64 ZYZ (to_matrix(psi, tilt, rot) == Euler_angles2matrix(rot,
    # tilt, psi); see tests/test_golden_euler.py eulerXmippMatch)
    R = _eo.to_matrix(np.deg2rad(psi), np.deg2rad(tilt), np.deg2rad(rot),
                      _eo.ZYZ)
    if flip:
        R = np.diag([-1.0, 1.0, 1.0]) @ R
    A[:3, :3] = scale * R
    A[:3, 3] = (x, y, z)
    return A


def transformation_matrix_to_geo(A) -> dict:
    """Inverse of geo_to_transformation_matrix: decompose a homogeneous
    matrix into (rot, tilt, psi, x, y, z, scale, flip)."""
    A = np.asarray(A, np.float64)
    dim = A.shape[0] - 1
    L = A[:dim, :dim]
    det = np.linalg.det(L)
    flip = det < 0
    scale = abs(det) ** (1.0 / dim)
    R = L / scale
    if flip:
        R = np.diag([-1.0] + [1.0] * (dim - 1)) @ R
    if dim == 2:
        psi = np.degrees(np.arctan2(R[0, 1], R[0, 0]))
        return {"psi": psi, "x": A[0, 2], "y": A[1, 2],
                "scale": scale, "flip": bool(flip)}
    rot, tilt, psi = matrix_to_euler(R)
    return {"rot": rot, "tilt": tilt, "psi": psi,
            "x": A[0, 3], "y": A[1, 3], "z": A[2, 3],
            "scale": scale, "flip": bool(flip)}


def transformation_matrix_from_string(s: str, dim: int = 4):
    """Parse a transformation matrix from either a flat whitespace list of
    16 numbers or a bracketed '[[a b c d], [..], ..]' form (the reference
    string2TransformationMatrix contract). Returns (dim+? ) — a 4x4 is
    parsed, then cropped to 3x3 2D form when dim == 3 — the top-left 3x3
    of the 4x4 IS the 2D homogeneous matrix (shifts in column 2)."""
    clean = s.replace("[", " ").replace("]", " ").replace(",", " ")
    vals = [float(t) for t in clean.split()]
    if len(vals) == 9:
        return np.array(vals, np.float64).reshape(3, 3)
    if len(vals) != 16:
        raise ValueError(f"expected 9 or 16 matrix entries, got {len(vals)}")
    M = np.array(vals, np.float64).reshape(4, 4)
    if dim == 3:
        return M[:3, :3].copy()
    return M


def align_with_z(axis):
    """Rotation matrix R with R·axis_hat = z_hat (reference alignWithZ,
    xmippCore geometry.cpp semantics: row 2 is the normalized axis; used by
    transform_geometry --rotate_volume alignZ, phantom features, NMA)."""
    v = np.asarray(axis, np.float64)
    n = np.linalg.norm(v)
    if n < 1e-12:
        raise ValueError("align_with_z: null axis")
    v = v / n
    proj = np.hypot(v[1], v[2])
    if proj > 1e-12:
        return np.array([
            [proj, -v[0] * v[1] / proj, -v[0] * v[2] / proj],
            [0.0, v[2] / proj, -v[1] / proj],
            [v[0], v[1], v[2]]], np.float64)
    # axis along +-x
    s = 1.0 if v[0] > 0 else -1.0
    return np.array([[0.0, 0.0, -s], [0.0, 1.0, 0.0],
                     [s, 0.0, 0.0]], np.float64)


def ico_setting_rotation(ico_from: str, ico_to: str):
    """Rotation taking an icosahedral volume from one standard setting to
    another (reference rotation3DMatrixFromIcoOrientations; settings i1-i4
    defined by the same reorientations core.sym uses for the symmetry
    groups: a volume with symmetry Q_f·G·Q_f^T rotated by Q_t·Q_f^T has
    symmetry Q_t·G·Q_t^T)."""
    from xmipp3_tpu_torch.core import euler_orders as _eo

    def _setting(name):
        name = name.strip().lower()
        if name not in ("i1", "i2", "i3", "i4"):
            raise ValueError(f"icosahedral setting must be i1..i4: {name}")
        tilts = {"i1": 90.0, "i2": 0.0, "i3": 31.7174745559,
                 "i4": -31.7174745559}
        return _eo.to_matrix(0.0, np.deg2rad(tilts[name]), 0.0, _eo.ZYZ)

    return _setting(ico_to) @ _setting(ico_from).T


def md_pose_from_matrix(M):
    """Decompose a 2-D homogeneous registration matrix into the metadata
    pose contract M = M_x^flip · R(-psi) · S(scale) · T(sx, sy)
    (ops.geo.metadata_alignment_matrices with scale). Returns dict with
    psi (deg), x, y, scale, flip."""
    M = np.asarray(M, np.float64)
    L = M[:2, :2]
    t = M[:2, 2]
    det = np.linalg.det(L)
    flip = det < 0
    scale = np.sqrt(abs(det))
    R = L / scale
    if flip:
        R = np.diag([-1.0, 1.0]) @ R
    # R = R(-psi) with R(psi) = [[c, s], [-s, c]]
    psi = np.degrees(np.arctan2(R[1, 0], R[0, 0]))
    s = np.linalg.solve(L, t)
    return {"psi": psi, "x": s[0], "y": s[1], "scale": scale,
            "flip": bool(flip)}


def rotation3d_matrix(angle_deg, axis):
    """Rotation about an arbitrary axis, xmipp image (passive) convention —
    rotation3DMatrix(ang, axis, M, homogeneous=false). Pinned by
    function_tests/test_geometry_main.cpp rotateAngleAroundAxis: +90 about
    X gives M[1,2]=+1, M[2,1]=-1 (the transpose of the active Rodrigues
    matrix)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    t = np.deg2rad(angle_deg)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(t) * K + (1 - np.cos(t)) * (K @ K)
    return R.T
