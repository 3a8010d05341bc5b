"""Point-group symmetries: parse symmetry strings -> rotation matrix lists.

Rebuilds the xmippCore SymList surface used throughout the reference
(core/symmetries.h include count 25, SURVEY.md §1.1; R_repository construction
in reconstruction/reconstruct_fourier.cpp:271-289). Supported groups follow
the Xmipp naming: cN, cNh/cNv (treated as cN for projection purposes since
mirror elements don't apply to projection direction expansion), dN, t, o,
i1/i2/i3/i4 (icosahedral in different standard orientations), plus 'sn'.

Matrices are proper rotations (det=+1) acting on volume coordinates; the
identity is always element 0.
"""
from __future__ import annotations

import re

import numpy as np


def _rz(deg):
    t = np.deg2rad(deg)
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def _ry(deg):
    t = np.deg2rad(deg)
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def _rx(deg):
    t = np.deg2rad(deg)
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def _axis_rot(axis, deg):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    t = np.deg2rad(deg)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(t) * K + (1 - np.cos(t)) * (K @ K)


def _close_group(gens: list[np.ndarray], max_order: int = 120) -> list[np.ndarray]:
    """Generate the full rotation group from generators."""
    elems = [np.eye(3)]

    def key(M):
        return tuple(np.round(M, 6).ravel())

    seen = {key(np.eye(3))}
    frontier = list(gens)
    while frontier:
        nxt = []
        for g in frontier:
            for e in list(elems):
                for M in (g @ e, e @ g):
                    k = key(M)
                    if k not in seen:
                        seen.add(k)
                        elems.append(M)
                        nxt.append(M)
                        if len(elems) > max_order:
                            raise ValueError("symmetry group too large")
        frontier = nxt
    return elems


_GOLDEN = (1 + np.sqrt(5)) / 2


def symmetry_matrices(sym: str) -> np.ndarray:
    """Rotation matrices (S,3,3) for a symmetry string (identity first)."""
    s = sym.strip().lower()
    if s in ("", "c1", "cn1", "i0"):
        return np.eye(3)[None].astype(np.float64)

    m = re.fullmatch(r"c(\d+)[hv]?", s)
    if m:
        n = int(m.group(1))
        mats = [_rz(360.0 * k / n) for k in range(n)]
        return np.stack(mats).astype(np.float64)

    m = re.fullmatch(r"d(\d+)[hv]?", s)
    if m:
        n = int(m.group(1))
        mats = [_rz(360.0 * k / n) for k in range(n)]
        flip = _axis_rot([1, 0, 0], 180.0)
        mats += [M @ flip for M in mats[:n]]
        return np.stack(mats).astype(np.float64)

    m = re.fullmatch(r"sn?(\d+)", s)
    if m:  # improper Sn: keep proper subgroup rotations
        n = int(m.group(1)) // 2
        return np.stack([_rz(360.0 * k / max(n, 1))
                         for k in range(max(n, 1))]).astype(np.float64)

    if s in ("t", "td", "th"):
        # tetrahedral: generated by 2-fold about z and 3-fold about (1,1,1)
        g1 = _axis_rot([0, 0, 1], 180.0)
        g2 = _axis_rot([1, 1, 1], 120.0)
        return np.stack(_close_group([g1, g2])).astype(np.float64)

    if s in ("o", "oh"):
        # octahedral: 4-fold about z, 3-fold about (1,1,1)
        g1 = _axis_rot([0, 0, 1], 90.0)
        g2 = _axis_rot([1, 1, 1], 120.0)
        return np.stack(_close_group([g1, g2])).astype(np.float64)

    m = re.fullmatch(r"i(\d?)[h]?", s)
    if m:
        variant = m.group(1) or "2"
        # icosahedral group in the reference's I2 standard orientation:
        # 2-folds on x/y/z, the two front 5-fold axes in the x-z plane at
        # +-31.7175 deg from z (their cross product is the y axis — the
        # pg_I2H asymmetric-unit plane (0,1,0), sampling.cpp:1077-1084).
        theta = np.degrees(np.arctan2(1.0, _GOLDEN))
        five_axis = np.array([np.sin(np.deg2rad(theta)), 0.0,
                              np.cos(np.deg2rad(theta))])
        g1 = _axis_rot(five_axis, 72.0)
        g2 = _axis_rot([0, 0, 1], 180.0)
        mats = _close_group([g1, g2])
        if len(mats) != 60:
            raise ValueError(f"icosahedral closure got {len(mats)} elements")
        # variants = conjugations by the same Euler matrices the reference
        # uses for the corresponding asymmetric-unit planes
        # (sampling.cpp:1111 i1: EM(0,90,0); :1144 i3: EM(0,31.717,0);
        # :1181 i4: EM(0,-31.717,0)); orbit parity with the reference's
        # i3h L-R repository pinned by tests/test_golden_sampling.py.
        from xmipp3_tpu_torch.core import euler_orders as _eo

        def _em_tilt(t):
            return _eo.to_matrix(0.0, np.deg2rad(t), 0.0, _eo.ZYZ)

        reorient = {
            "1": _em_tilt(90.0),
            "2": np.eye(3),
            "3": _em_tilt(31.7174745559),
            "4": _em_tilt(-31.7174745559),
        }[variant]
        out = [reorient @ M @ reorient.T for M in mats]
        return np.stack(out).astype(np.float64)

    raise ValueError(f"unknown symmetry '{sym}'")


class SymList:
    """Symmetry matrix repository (mirrors the xmippCore SymList role)."""

    def __init__(self, sym: str = "c1"):
        self.sym_string = sym
        self.matrices = symmetry_matrices(sym)

    def __len__(self) -> int:
        return len(self.matrices)

    @property
    def true_sym_no(self) -> int:
        return len(self.matrices)

    def sym_matrices(self) -> np.ndarray:
        return self.matrices

    def true_syms_no(self) -> int:
        """Reference SymList::trueSymsNo: total group order including
        improper elements, minus the identity (i3h -> 119)."""
        return group_order(self.sym_string) - 1

    def compute_distance(self, rot1, tilt1, psi1, rot2, tilt2, psi2,
                         projdir_mode=False, check_mirrors=False,
                         object_rotation=False):
        """Minimal angular distance between two orientations over all
        symmetry-equivalent versions of the second: mean of the three
        per-axis angles (or the projection-direction angle alone when
        projdir_mode). Returns (distance_deg, (rot2', tilt2', psi2')) with
        the best equivalent. Value parity: test_golden_symmetries.py pins
        i3h (1,2,3)-(6,5,4) -> 5.23652 (test_symmetries_main.cpp:53-63)."""
        from xmipp3_tpu_torch.core.geometry import matrix_to_euler
        E1 = _euler_f64(rot1, tilt1, psi1)
        E2 = _euler_f64(rot2, tilt2, psi2)
        best, best_E = np.inf, E2
        for L in np.asarray(self.matrices, np.float64):
            cands = [E2 @ L.T]
            if check_mirrors:
                cands.append(np.diag([1.0, -1.0, -1.0]) @ E2 @ L.T)
            for cand in cands:
                d = _matrix_dist_deg(E1, cand, projdir_mode)
                if d < best:
                    best, best_E = d, cand
        r2, t2, p2 = matrix_to_euler(best_E)
        return best, (r2, t2, p2)

    def break_symmetry(self, rot, tilt, psi, rng=None):
        """Replace an orientation by a random symmetry-equivalent one
        (reference SymList::breakSymmetry — distance to the original under
        compute_distance stays 0)."""
        from xmipp3_tpu_torch.core.geometry import matrix_to_euler
        rng = np.random.default_rng() if rng is None else rng
        E = _euler_f64(rot, tilt, psi)
        L = np.asarray(self.matrices, np.float64)[
            rng.integers(len(self.matrices))]
        return matrix_to_euler(E @ L.T)

    def expand_euler(self, rot, tilt, psi):
        """All symmetry-equivalent Euler triplets of a projection direction."""
        from xmipp3_tpu_torch.core.geometry import euler_matrix, matrix_to_euler
        A = np.asarray(euler_matrix(rot, tilt, psi), np.float64)
        out = []
        for M in self.matrices:
            out.append(matrix_to_euler(A @ M.T))
        return out


# ---------------------------------------------------------------------------
# Symmetry-group classification + distances (xmippCore SymList surface;
# behavior pinned by function_tests/test_symmetries_main.cpp /
# test_sampling_main.cpp transliterations in tests/test_golden_symmetries.py)
# ---------------------------------------------------------------------------

def is_symmetry_group(name: str):
    """Classify a symmetry string -> (group_type, order) like the reference
    SymList::isSymmetryGroup: 'c5' -> ('CN', 5), 'i3h' -> ('I3H', -1).
    Groups without a numeric order report -1."""
    s = name.strip().lower()
    m = re.fullmatch(r"c(\d+)", s)
    if m:
        return "CN", int(m.group(1))
    m = re.fullmatch(r"c(\d+)h", s)
    if m:
        return "CNH", int(m.group(1))
    m = re.fullmatch(r"c(\d+)v", s)
    if m:
        return "CNV", int(m.group(1))
    m = re.fullmatch(r"d(\d+)", s)
    if m:
        return "DN", int(m.group(1))
    m = re.fullmatch(r"d(\d+)h", s)
    if m:
        return "DNH", int(m.group(1))
    m = re.fullmatch(r"d(\d+)v", s)
    if m:
        return "DNV", int(m.group(1))
    m = re.fullmatch(r"sn?(\d+)", s)
    if m:
        return "SN", int(m.group(1))
    fixed = {"ci": ("CI", -1), "cs": ("CS", -1), "t": ("T", -1),
             "td": ("TD", -1), "th": ("TH", -1), "o": ("O", -1),
             "oh": ("OH", -1),
             "i": ("I2", -1), "i1": ("I1", -1), "i2": ("I2", -1),
             "i3": ("I3", -1), "i4": ("I4", -1), "i5": ("I5", -1),
             "ih": ("I2H", -1), "i1h": ("I1H", -1), "i2h": ("I2H", -1),
             "i3h": ("I3H", -1), "i4h": ("I4H", -1), "i5h": ("I5H", -1)}
    if s in fixed:
        return fixed[s]
    raise ValueError(f"unknown symmetry group '{name}'")


def group_order(name: str) -> int:
    """Total group order INCLUDING improper elements (mirrors/inversions)."""
    s = name.strip().lower()
    proper = len(symmetry_matrices(re.sub(r"[hv]$", "", s) or "c1"))
    if re.search(r"[hv]$", s) or s in ("th", "td", "oh", "ci", "cs"):
        return 2 * proper
    return proper


def _euler_f64(rot, tilt, psi):
    from xmipp3_tpu_torch.core import euler_orders as _eo
    return _eo.to_matrix(np.deg2rad(psi), np.deg2rad(tilt), np.deg2rad(rot),
                         _eo.ZYZ)


def _matrix_dist_deg(A, B, projdir_mode=False):
    if projdir_mode:
        return float(np.degrees(np.arccos(np.clip(np.dot(A[2], B[2]), -1, 1))))
    angs = [np.degrees(np.arccos(np.clip(np.dot(A[i], B[i]), -1, 1)))
            for i in range(3)]
    return float(np.mean(angs))
