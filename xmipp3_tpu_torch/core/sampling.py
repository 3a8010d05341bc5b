"""Even angular sampling of the projection sphere with symmetry pruning.

Rebuilds the reference Sampling surface (data/sampling.h:46,
computeSamplingPoints :143, removeRedundantPoints :176, computeNeighbors :203)
used by angular_project_library and projection matching.

Sampling scheme: tilt rings every `rate` degrees; within a ring, rot step =
rate / sin(tilt) (equal arc length), the same construction the reference uses.
"""
from __future__ import annotations

import numpy as np

from xmipp3_tpu_torch.core.geometry import euler_matrix
from xmipp3_tpu_torch.core.sym import SymList


def compute_sampling_points(rate_deg: float, tilt_min: float = 0.0,
                            tilt_max: float = 180.0) -> np.ndarray:
    """Quasi-even (rot, tilt) grid; returns (N, 2) degrees."""
    out = []
    n_tilt = max(int(round(180.0 / rate_deg)), 1)
    for i in range(n_tilt + 1):
        tilt = 180.0 * i / n_tilt
        if tilt < tilt_min - 1e-6 or tilt > tilt_max + 1e-6:
            continue
        st = np.sin(np.deg2rad(tilt))
        if st < 1e-6:
            out.append((0.0, tilt))
            continue
        n_rot = max(int(round(360.0 * st / rate_deg)), 1)
        for j in range(n_rot):
            out.append((360.0 * j / n_rot - 180.0, tilt))
    return np.array(out, np.float64)


def directions_from_angles(angles: np.ndarray) -> np.ndarray:
    """(rot, tilt) -> unit direction vectors (the rotated z axis, A[2])."""
    rot, tilt = angles[:, 0], angles[:, 1]
    A = np.asarray(euler_matrix(rot, tilt, np.zeros_like(rot)), np.float64)
    return A[:, 2, :]


def remove_redundant_points(angles: np.ndarray, sym: SymList) -> np.ndarray:
    """Keep one representative per symmetry orbit (asymmetric unit)."""
    if len(sym) == 1:
        return angles
    dirs = directions_from_angles(angles)
    mats = sym.sym_matrices().astype(np.float64)          # (S,3,3)
    # orbit of each direction: d @ M.T for each symmetry M
    orbit = np.einsum("sij,nj->nsi", mats, dirs)          # (N,S,3)
    # canonical representative = lexicographically largest (z, y, x) tuple
    keys = np.round(orbit[..., [2, 1, 0]], 5)             # (N,S,3)
    flat = keys.reshape(len(angles), len(mats), 3)
    # a point is kept if its own key is the orbit maximum
    own = np.round(dirs[:, [2, 1, 0]], 5)
    best = np.array([max(map(tuple, flat[i])) for i in range(len(angles))])
    keep = np.all(np.isclose(own, best, atol=2e-5), axis=1)
    # dedupe identical orbit representatives (points mapped onto each other)
    seen = set()
    out = []
    for i in np.where(keep)[0]:
        k = tuple(best[i])
        if k not in seen:
            seen.add(k)
            out.append(angles[i])
    return np.array(out)


def angular_distance_deg(d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """Pairwise angular distance (degrees) between direction sets."""
    cosang = np.clip(d1 @ d2.T, -1.0, 1.0)
    return np.degrees(np.arccos(cosang))


def compute_neighbors(angles: np.ndarray, ref_angles: np.ndarray,
                      max_dist_deg: float, sym: SymList | None = None,
                      check_mirrors: bool = False):
    """For each row of `angles`, indices of ref_angles within max_dist_deg
    (considering symmetry if given; check_mirrors also accepts antipodal
    directions — reference angular_neighbourhood --check_mirrors).
    Returns list of index arrays."""
    d_exp = directions_from_angles(angles)
    d_ref = directions_from_angles(ref_angles)
    if sym is not None and len(sym) > 1:
        mats = sym.sym_matrices().astype(np.float64)
        d_exp_orbit = np.einsum("sij,nj->nsi", mats, d_exp)  # (N,S,3)
        cos = np.einsum("nsi,mi->nsm", d_exp_orbit, d_ref)
        if check_mirrors:
            cos = np.maximum(cos, -cos)
        cos = cos.max(axis=1)
    else:
        cos = d_exp @ d_ref.T
        if check_mirrors:
            cos = np.maximum(cos, -cos)
    ang = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    return [np.where(ang[i] <= max_dist_deg)[0] for i in range(len(angles))]


class Sampling:
    """High-level even sampling of the asymmetric unit."""

    def __init__(self, rate_deg: float, sym: str = "c1",
                 tilt_range=(0.0, 180.0)):
        self.rate_deg = rate_deg
        self.sym = SymList(sym)
        pts = compute_sampling_points(rate_deg, *tilt_range)
        self.angles = remove_redundant_points(pts, self.sym)

    def __len__(self):
        return len(self.angles)

    @property
    def directions(self):
        return directions_from_angles(self.angles)


# ---------------------------------------------------------------------------
# Reference-exact sampling construction (data/sampling.cpp:32-670):
# icosahedron-edge subdivision with slerp fill, producing the identical
# point list (order included) as the reference's computeSamplingPoints —
# pinned against the reference's own resources/test/sampling fixtures by
# tests/test_golden_sampling.py.
# ---------------------------------------------------------------------------

_CTE_W = 1.107149   # icosahedron half-edge angle used by the reference

_ICO_VERTICES = np.array([
    [0., 0., 1.],
    [0.723606900230461, -0.525731185781806, 0.447213343087301],
    [0.723606900230461, 0.525731185781806, 0.447213343087301],
    [-0.276393239417711, 0.850650928976665, 0.447213343087301],
    [-0.8944273172062, 0., 0.447213343087301],
    [-0.276393239417711, -0.850650928976665, 0.447213343087301],
    [0.8944273172062, 0., -0.447213343087301],
    [0.276393242471372, 0.850650927984471, -0.447213343087301],
    [-0.723606898343194, 0.525731188379405, -0.447213343087301],
    [-0.723606898343194, -0.525731188379405, -0.447213343087301],
    [0.276393242471372, -0.850650927984471, -0.447213343087301],
    [0., 0., -1.],
])

# (a_first, a_second, b_first, b_second) vertex-index pairs per face row;
# each entry: fillEdge(start->end, END_FLAG)
_ICO_EDGES = [
    # a edges                      b edges
    (((0, 1, False), (6, 1, True)), ((0, 2, False), (6, 2, True))),    # 01
    (((0, 2, False), (7, 2, True)), ((0, 3, False), (7, 3, True))),    # 02
    (((0, 3, False), (8, 3, True)), ((0, 4, False), (8, 4, True))),    # 03
    (((0, 4, False), (9, 4, True)), ((0, 5, False), (9, 5, True))),    # 04
    (((0, 5, False), (10, 5, True)), ((0, 1, False), (10, 1, True))),  # 05
    (((11, 10, False), (5, 10, True)), ((11, 9, False), (5, 9, True))),  # 06
    (((11, 9, False), (4, 9, True)), ((11, 8, False), (4, 8, True))),  # 07
    (((11, 8, False), (3, 8, True)), ((11, 7, False), (3, 7, True))),  # 08
    (((11, 7, False), (2, 7, True)), ((11, 6, False), (2, 6, True))),  # 09
    (((11, 6, False), (1, 6, True)), ((11, 10, False), (1, 10, True))),  # 10
]


def _slerp_points(p, q, n_samples, skip_last):
    """fillEdge: slerp samples i/(n-1) for i=1..n-1 (END_FLAG drops the
    final point)."""
    ups = np.arccos(np.clip(np.dot(p, q), -1, 1))
    out = []
    for i1 in range(1, n_samples):
        g = i1 / (n_samples - 1)
        v = (np.sin((1 - g) * ups) * p + np.sin(g * ups) * q) / np.sin(ups)
        v = v / np.linalg.norm(v)
        if skip_last and np.sin(g * ups) / np.sin(ups) > 0.9999:
            continue
        out.append(v)
    return out


def compute_sampling_points_reference(rate_deg: float,
                                      only_half_sphere: bool = False,
                                      max_tilt: float = 180.0,
                                      min_tilt: float = 0.0):
    """The reference computeSamplingPoints, point-for-point. Returns
    (angles_deg (N,3) [rot, tilt, 0], vectors (N,3))."""
    rate_rad = np.deg2rad(rate_deg)
    n_samp = int(np.floor(_CTE_W / rate_rad + 0.5)) + 1
    if n_samp < 3:
        raise ValueError("angular sampling rate too coarse")
    max_z = np.cos(np.deg2rad(max_tilt))
    min_z = np.cos(np.deg2rad(min_tilt))
    if min_z > max_z:
        min_z, max_z = max_z, min_z

    V = _ICO_VERTICES
    edge_start, edge_end = [], []
    for (a_edges, b_edges) in _ICO_EDGES:
        for (s, e, flag) in a_edges:
            edge_start.extend(_slerp_points(V[s], V[e], n_samp, flag))
        for (s, e, flag) in b_edges:
            edge_end.extend(_slerp_points(V[s], V[e], n_samp, flag))

    def in_range(v):
        if only_half_sphere and v[2] < 0.0:
            return False
        return min_z <= v[2] <= max_z

    pts = []
    for idx in (11, 0):
        if in_range(V[idx]):
            pts.append(V[idx].copy())
    for i, _ in enumerate(edge_start):
        v = edge_start[i] if i < n_samp * 10 - 15 else edge_end[i]
        if in_range(v):
            pts.append(v)

    # in-between points (fillDistance with the reference's j-cycling)
    j = 0
    j_flag = False
    for i in range(len(edge_start)):
        if j % (n_samp - 1) == 0 and j != 0:
            j = 0
            j_flag = True
        if j % (n_samp - 2) == 0 and j != 0 and j_flag:
            j = 0
            j_flag = False
        my_n = (j + 1) % n_samp
        p, q = edge_start[i], edge_end[i]
        ups = np.arccos(np.clip(np.dot(p, q), -1, 1))
        for i1 in range(1, my_n):
            g = i1 / my_n
            v = (np.sin((1 - g) * ups) * p
                 + np.sin(g * ups) * q) / np.sin(ups)
            v = v / np.linalg.norm(v)
            if in_range(v):
                pts.append(v)
        j += 1

    vectors = np.array(pts)
    rot = np.degrees(np.arctan2(vectors[:, 1], vectors[:, 0]))
    tilt = np.degrees(np.arccos(np.clip(vectors[:, 2], -1, 1)))
    angles = np.stack([rot, tilt, np.zeros_like(rot)], axis=1)
    return angles, vectors


def _asu_planes(group: str):
    """Outward normals of the asymmetric-unit half-spaces for the icosahedral
    'h' groups (reference removeRedundantPoints, sampling.cpp:1018-1200)."""
    from xmipp3_tpu_torch.core import euler_orders as _eo

    def EM(rot, tilt, psi):
        return _eo.to_matrix(np.deg2rad(psi), np.deg2rad(tilt),
                             np.deg2rad(rot), _eo.ZYZ)

    if group in ("IH", "I2H"):
        return [np.array([0., 1., 0.]),
                _unit([-0.4999999839058737, -0.8090170074556163,
                       0.3090169861701543]),
                _unit([0.4999999839058737, -0.8090170074556163,
                       0.3090169861701543]),
                np.array([1., 0., 0.])]
    if group == "I1H":
        A = EM(0., 90., 0.)
        return [_unit(A @ v) for v in (
            np.array([0., 1., 0.]),
            _unit([-0.4999999839058737, -0.8090170074556163,
                   0.3090169861701543]),
            _unit([0.4999999839058737, -0.8090170074556163,
                   0.3090169861701543]),
            A.T @ np.array([1., 0., 0.]))][:3] + [
            _unit(A @ np.array([1., 0., 0.]))]
    if group == "I3H":
        A = EM(0., 31.7174745559, 0.)
        return [_unit(A @ np.array([0.187592467856686, -0.303530987314591,
                                    -0.491123477863004])),
                _unit(A @ np.array([0.187592467856686, 0.303530987314591,
                                    -0.491123477863004])),
                _unit(A @ np.array([0., 0., 1.])),
                np.array([0., 1., 0.])]
    if group == "I4H":
        A = EM(0., -31.7174745559, 0.)
        return [_unit(A @ np.array([0.187592467856686, -0.303530987314591,
                                    -0.491123477863004])),
                _unit(A @ np.array([0.187592467856686, 0.303530987314591,
                                    -0.491123477863004])),
                _unit(A @ np.array([0., 0., 1.])),
                np.array([0., 1., 0.])]
    raise ValueError(group)


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def remove_redundant_points_reference(angles, vectors, sym_name: str):
    """The reference removeRedundantPoints for the groups its tests pin:
    CN (rot window), CI/CS (northern hemisphere), CNV/CNH/SN, and the
    icosahedral-h plane tests. Returns (angles, vectors) of the asymmetric
    unit, original order preserved."""
    from xmipp3_tpu_torch.core.sym import is_symmetry_group
    group, order = is_symmetry_group(sym_name)
    rot, tilt = angles[:, 0], angles[:, 1]
    if group == "CN":
        keep = (rot >= -180.0 / order) & (rot <= 180.0 / order)
    elif group in ("CI", "CS"):
        keep = tilt <= 90.0
    elif group == "CNV":
        keep = (rot >= 0.0) & (rot <= 180.0 / order)
    elif group == "CNH":
        keep = ((rot >= -180.0 / order) & (rot <= 180.0 / order)
                & (tilt <= 90.0))
    elif group == "SN":
        keep = ((rot >= -360.0 / order) & (rot <= 360.0 / order)
                & (tilt <= 90.0))
    elif group in ("IH", "I2H", "I1H", "I3H", "I4H"):
        planes = _asu_planes(group)
        keep = np.all(np.stack([vectors @ p >= 0 for p in planes]), axis=0)
    else:
        raise ValueError(f"asymmetric unit for '{sym_name}' not implemented "
                         "in the reference-exact path")
    return angles[keep], vectors[keep]


def exp_directions_by_symmetry(exp_angles, sym_name: str):
    """Experimental projection directions expanded by the symmetry group
    (reference fillExpDataProjectionDirectionByLR): for each (rot, tilt,
    psi) the direction orbit under the group's L/R pairs. Proper rotations
    give {R d}; the improper half of the 'h' (centrosymmetric) groups adds
    {-R d}. Returns (M, 3)."""
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    from xmipp3_tpu_torch.core.sym import SymList, group_order
    rot = exp_angles[:, 0]
    tilt = exp_angles[:, 1]
    psi = exp_angles[:, 2] if exp_angles.shape[1] > 2 else np.zeros_like(rot)
    A = np.asarray(euler_matrix(rot, tilt, psi), np.float64)
    dirs = A[:, 2, :]
    SL = SymList(sym_name)
    mats = SL.sym_matrices().astype(np.float64)
    out = []
    improper = group_order(sym_name) > len(mats)
    for d in dirs:
        orb = [M @ d for M in mats]
        if improper:
            orb += [-M @ d for M in mats]
        out.extend(orb)
    return np.array(out)


def remove_points_far_from_exp(angles, vectors, exp_dirs,
                               radius_deg: float, return_index=False):
    """Reference removePointsFarAwayFromExperimentalData INCLUDING its
    swap-delete reordering (sampling.cpp:1928-1955: deletion swaps the last
    element into the hole, so the surviving order is permuted
    deterministically). With return_index, also returns each survivor's
    index in the input (the no_redundant_sampling_points_index the
    reference threads into computeNeighbors)."""
    cosr = np.cos(np.deg2rad(radius_deg))
    ang = [a for a in angles]
    vec = [v for v in vectors]
    idx = list(range(len(vec)))
    i = 0
    while i < len(vec):
        if np.max(exp_dirs @ vec[i]) > cosr:
            i += 1
        else:
            ang[i] = ang[-1]
            vec[i] = vec[-1]
            idx[i] = idx[-1]
            ang.pop()
            vec.pop()
            idx.pop()
    if return_index:
        return np.array(ang), np.array(vec), idx
    return np.array(ang), np.array(vec)


def compute_neighbors_reference(vectors, point_index, exp_angles,
                                radius_deg: float):
    """Reference computeNeighbors for the identity-repository case (C1):
    per experimental image, the ORIGINAL asymmetric-unit indices
    (`point_index`, from remove_points_far_from_exp) of sampling points
    within the neighborhood radius — value parity with the reference's
    neigh_ref_c1_exp fixture pinned by tests/test_golden_sampling.py."""
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    cosr = np.cos(np.deg2rad(radius_deg))
    rot, tilt = exp_angles[:, 0], exp_angles[:, 1]
    psi = exp_angles[:, 2] if exp_angles.shape[1] > 2 else np.zeros_like(rot)
    A = np.asarray(euler_matrix(rot, tilt, psi), np.float64)
    dirs = A[:, 2, :]
    V = np.asarray(vectors)
    out = []
    for d in dirs:
        sel = np.where(V @ d > cosr)[0]
        out.append(sorted((point_index[s] for s in sel), reverse=True))
    return out


def save_sampling_file(root: str, angles, vectors, sampling_rate_rad: float,
                       neighborhood_radius_rad: float = 0.0,
                       neighbors=None) -> str:
    """Write the reference Sampling::saveSamplingFile layout
    (<root>_sampling.xmd: data_extra scalars + optional data_neighbors
    quoted index lists + data_projectionDirections loop)."""
    fn = root + "_sampling.xmd"
    lines = ["# XMIPP_STAR_1 * ", "# ", "data_extra",
             f" _sampling_rate {sampling_rate_rad:.6g}",
             f" _neighborhoodRadius {neighborhood_radius_rad:.6g}"]
    if neighbors is not None:
        lines += ["data_neighbors", "loop_", " _neighbor", " _neighbors"]
        for i, ns in enumerate(neighbors):
            lst = " ".join(str(v) for v in ns)
            lines.append(f"{i + 1:>10} ' {lst} ' ")
    lines += ["data_projectionDirections", "loop_", " _neighbor",
              " _angleRot", " _angleTilt", " _anglePsi",
              " _X", " _Y", " _Z"]
    angles = np.asarray(angles, np.float64)
    vectors = np.asarray(vectors, np.float64)
    psi = angles[:, 2] if angles.shape[1] > 2 else np.zeros(len(angles))
    for i in range(len(angles)):
        lines.append(f"{i + 1:>10} {angles[i, 0]:12.6f} "
                     f"{angles[i, 1]:12.6f} {psi[i]:12.6f} "
                     f"{vectors[i, 0]:12.6f} {vectors[i, 1]:12.6f} "
                     f"{vectors[i, 2]:12.6f} ")
    with open(fn, "w") as f:
        f.write("\n".join(lines) + "\n")
    return fn


def read_sampling_file(root: str) -> dict:
    """Read a <root>_sampling.xmd written by save_sampling_file (or by
    the reference saveSamplingFile — the fixtures in
    resources/test/sampling/ parse with this reader)."""
    import re
    fn = root if root.endswith("_sampling.xmd") else root + "_sampling.xmd"
    text = open(fn).read()
    out = {"sampling_rate": 0.0, "neighborhood_radius": 0.0,
           "neighbors": None}
    m = re.search(r"_sampling_rate\s+([-\d.eE+]+)", text)
    if m:
        out["sampling_rate"] = float(m.group(1))
    m = re.search(r"_neighborhoodRadius\s+([-\d.eE+]+)", text)
    if m:
        out["neighborhood_radius"] = float(m.group(1))
    m = re.search(r"data_neighbors(.*?)(?:data_\w+|$)", text, re.S)
    if m and "loop_" in m.group(1):
        neigh = []
        for line in m.group(1).splitlines():
            q = re.search(r"'([\d\s]*)'", line)
            if q:
                neigh.append([int(v) for v in q.group(1).split()])
        out["neighbors"] = neigh
    m = re.search(r"data_projectionDirections(.*?)(?:data_\w+|$)", text,
                  re.S)
    rows = []
    if m:
        for line in m.group(1).splitlines():
            t = line.split()
            if len(t) == 7 and re.match(r"^-?\d+$", t[0]):
                rows.append([float(x) for x in t[1:]])
    arr = np.asarray(rows, np.float64).reshape(-1, 6)
    out["angles"] = arr[:, :3]
    out["vectors"] = arr[:, 3:6]
    return out
