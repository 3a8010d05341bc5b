"""Kaiser-Bessel blob bases and reconstruction grids.

Contract: reference data/blobs.{h,cpp} (kaiser_value /
kaiser_Fourier_value, blob footprints, blobs<->voxels) and data/grids.h
(CC/BCC/FCC SimpleGrid). Host numpy/scipy, as in the reference package's
ops/basis.py: the reconstruction builds its grid-sampled blob kernel and
deapodization table from the profiles once; the Blob family (footprints,
lattices, blobs<->voxels) serves the tests and user scripts.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy import special


@dataclass
class Blob:
    """Kaiser-Bessel blob parameters (reference struct blobtype,
    blobs.h:112; defaults = the classic ART blob a=2, m=2, alpha=10.4)."""
    radius: float = 2.0
    order: int = 2
    alpha: float = 10.4


def kaiser_value(r, a=2.0, alpha=10.4, m=2):
    """Blob profile b(r) (reference kaiser_value, blobs.h:142):
    b(r) = (sqrt(1-(r/a)^2))^m * I_m(alpha*sqrt(1-(r/a)^2)) / I_m(alpha)."""
    r = np.asarray(r, np.float64)
    w = 1 - (r / a) ** 2
    w = np.clip(w, 0.0, None)
    rt = np.sqrt(w)
    return np.where(r <= a,
                    rt ** m * special.iv(m, alpha * rt)
                    / special.iv(m, alpha), 0.0)


def kaiser_fourier_value(w, a=2.0, alpha=10.4, m=2):
    """Radial Fourier transform of the 3D blob (reference
    kaiser_Fourier_value, blobs.cpp:144; Lewitt 1990 closed forms for
    m=0 and m=2 — the orders the reference supports)."""
    w = np.asarray(w, np.float64)
    sigma = 2 * np.pi * a * w
    t = np.sqrt(np.abs(alpha ** 2 - sigma ** 2))
    inside = sigma <= alpha
    if m == 2:
        # (2*pi)^{3/2} a^3 alpha^2 / I_2(alpha) * I_{7/2}(t)/t^{7/2} inside,
        # J_{7/2} outside
        c = (2 * np.pi) ** 1.5 * a ** 3 * alpha ** 2 / special.iv(2, alpha)
        nu = 3.5
    elif m == 0:
        # (2*pi)^{3/2} a^3 / I_0(alpha) * I_{3/2}(t)/t^{3/2} inside,
        # J_{3/2} outside (reference blobs.cpp:158-166)
        c = (2 * np.pi) ** 1.5 * a ** 3 / special.iv(0, alpha)
        nu = 1.5
    else:
        raise NotImplementedError("analytic form implemented for m in {0,2}")
    with np.errstate(invalid="ignore", divide="ignore"):
        vin = c * special.iv(nu, t) / np.power(t, nu)
        vout = c * special.jv(nu, t) / np.power(t, nu)
    v0 = c * (1 / (special.gamma(nu + 1) * 2 ** nu))   # limit t -> 0
    out = np.where(inside, vin, vout)
    return np.where(np.abs(t) < 1e-8, v0, out)


def blob_footprint(blob: Blob, sampling: float = 1.0, oversample: int = 1):
    """Cubic voxel footprint of a blob centered at the origin."""
    r_vox = blob.radius / sampling
    n = int(np.ceil(r_vox)) * 2 + 1
    half = n // 2
    g = (np.arange(n) - half) * sampling
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt(xx ** 2 + yy ** 2 + zz ** 2)
    return kaiser_value(r, blob.radius, blob.alpha, blob.order
                        ).astype(np.float32)


# ---------------------------------------------------------------------------
# grids (reference data/grids.h: CC / BCC / FCC sample lattices)
# ---------------------------------------------------------------------------

def grid_points(kind: str, size: int, spacing: float = 1.0):
    """Lattice points of a centered grid inside a cube of `size` voxels.

    kind: "cc" (simple cubic), "bcc" (body-centered), "fcc" (face-centered).
    Returns (N, 3) float coordinates in voxel units, origin at the center.
    BCC uses the reference's convention: a second CC lattice offset by half
    the spacing in all axes."""
    half = size / 2.0
    base = np.arange(-half, half + 1e-6, spacing)
    zz, yy, xx = np.meshgrid(base, base, base, indexing="ij")
    cc = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=1)
    if kind == "cc":
        pts = cc
    elif kind == "bcc":
        pts = np.concatenate([cc, cc + spacing / 2.0])
    elif kind == "fcc":
        o = spacing / 2.0
        pts = np.concatenate([cc, cc + [o, o, 0], cc + [o, 0, o],
                              cc + [0, o, o]])
    else:
        raise ValueError(f"unknown grid kind {kind!r}")
    keep = (np.abs(pts) <= half).all(axis=1)
    return pts[keep]


def blobs_to_voxels(coeffs, points, blob: Blob, size: int,
                    sampling: float = 1.0):
    """Voxelize a blob expansion: sum of footprints scaled by coefficients
    (reference changeToVoxels role)."""
    fp = blob_footprint(blob, sampling)
    n = fp.shape[0]
    half = n // 2
    vol = np.zeros((size + 2 * half,) * 3, np.float64)
    pts = np.asarray(points, np.float64) / sampling + size // 2 + half
    for c, p in zip(np.asarray(coeffs, np.float64), pts):
        iz, iy, ix = (int(round(v)) for v in (p[2], p[1], p[0]))
        if not all(half <= v < size + half for v in (iz, iy, ix)):
            continue
        vol[iz - half:iz + half + 1, iy - half:iy + half + 1,
            ix - half:ix + half + 1] += c * fp
    return vol[half:half + size, half:half + size,
               half:half + size].astype(np.float32)


def voxels_to_blobs(vol, points, blob: Blob, sampling: float = 1.0,
                    n_iters: int = 10, lam: float = 1.0):
    """Fit blob coefficients reproducing a voxel volume (reference
    voxels->blobs conversion) by damped Richardson iterations:
    c <- c + lam * footprint-weighted residual sampling."""
    vol = np.asarray(vol, np.float64)
    size = vol.shape[0]
    fp = blob_footprint(blob, sampling)
    norm = float((fp ** 2).sum())
    coeffs = np.zeros(len(points))
    for _ in range(n_iters):
        cur = blobs_to_voxels(coeffs, points, blob, size, sampling)
        resid = vol - cur
        # correlate residual with each footprint (gather local patches)
        half = fp.shape[0] // 2
        pad = np.pad(resid, half)
        upd = np.zeros_like(coeffs)
        pts = np.asarray(points, np.float64) / sampling + size // 2 + half
        for i, p in enumerate(pts):
            iz, iy, ix = (int(round(v)) for v in (p[2], p[1], p[0]))
            if not all(half <= v < size + half for v in (iz, iy, ix)):
                continue
            patch = pad[iz - half:iz + half + 1, iy - half:iy + half + 1,
                        ix - half:ix + half + 1]
            upd[i] = (patch * fp).sum() / norm
        coeffs = coeffs + lam * upd
    return coeffs
