"""Plain reference of the gallery's directions: the even sampling of the
projection sphere at a rate, kept to one asymmetric unit of a point group,
as `angular_project_library --sampling_rate <rate> --sym <sym>` defines
it. Imports nothing of the program.

Sampling: tilt rings every `rate` degrees from 0 to 180 (180/rate rounded
rings apart); a pole is one point at rot 0; a ring of tilt t holds
round(360 sin t / rate) points, rot = 360 j / count - 180 (equal arc
length along the ring).

Asymmetric unit: a direction d = (sin t cos r, sin t sin r, cos t) is
kept when no image g d under the group is larger in the order of (z, y,
x), compared one component after the other with ties within `TOL`; of
kept directions that are images of one another, the first in the ring
order stays.
"""
from __future__ import annotations

import numpy as np

from cryobench.symmetry import group

TOL = 1e-9


def rings(rate_deg: float) -> np.ndarray:
    """(N, 2) float64 (rot, tilt) in degrees over the whole sphere."""
    out = []
    count = max(int(round(180.0 / rate_deg)), 1)
    for i in range(count + 1):
        tilt = 180.0 * i / count
        st = np.sin(np.radians(tilt))
        if st < 1e-6:
            out.append((0.0, tilt))
            continue
        per = max(int(round(360.0 * st / rate_deg)), 1)
        out += [(360.0 * j / per - 180.0, tilt) for j in range(per)]
    return np.array(out, np.float64)


def unit_vectors(angles: np.ndarray) -> np.ndarray:
    """(N, 3) projection directions of (rot, tilt) rows in degrees."""
    r, t = np.radians(angles[:, 0]), np.radians(angles[:, 1])
    return np.stack([np.sin(t) * np.cos(r), np.sin(t) * np.sin(r),
                     np.cos(t)], axis=1)


def _larger(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per row, whether a is larger than b in the order of (z, y, x)."""
    out = np.zeros(len(a), bool)
    decided = np.zeros(len(a), bool)
    for k in (2, 1, 0):
        diff = a[:, k] - b[:, k]
        here = ~decided & (np.abs(diff) > TOL)
        out |= here & (diff > 0)
        decided |= here
    return out


def directions(rate_deg: float, sym: str) -> np.ndarray:
    """(N, 2) float64 (rot, tilt) of the gallery: the sampling's points in
    the asymmetric unit of `sym`, in the ring order."""
    pts = rings(rate_deg)
    d = unit_vectors(pts)
    G = group(sym)
    keep = np.ones(len(pts), bool)
    for g in G[1:]:
        keep &= ~_larger(d @ g.T, d)
    idx = np.flatnonzero(keep)
    D = d[idx]
    images = np.einsum("sij,kj->ksi", G, D)              # (K, S, 3)
    same = (np.abs(images[:, :, None] - D[None, None]).max(-1)
            < 1e-6).any(axis=1)                          # (K, K)
    first = ~np.tril(same, -1).any(axis=1)
    return pts[idx[first]]


def pair(program: np.ndarray, reference: np.ndarray, tol_deg: float):
    """(order, unmatched): for each program (rot, tilt) row the index of the
    reference direction nearest it, and the number of program directions
    farther than `tol_deg` from every reference one, or sharing their
    nearest with another, plus the reference directions nearest to
    none."""
    a = unit_vectors(np.asarray(program, np.float64))
    b = unit_vectors(np.asarray(reference, np.float64))
    cos = np.clip(a @ b.T, -1.0, 1.0)
    order = cos.argmax(axis=1)
    near = np.degrees(np.arccos(cos[np.arange(len(a)), order])) <= tol_deg
    hits = np.bincount(order[near], minlength=len(b))
    shared = hits.sum() - (hits > 0).sum()
    return order, int((~near).sum() + shared + (hits == 0).sum())
