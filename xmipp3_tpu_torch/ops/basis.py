"""Kaiser-Bessel blob profiles (the subset of the reference package's
ops/basis.py that Fourier reconstruction needs).

Contract: reference data/blobs.{h,cpp} (kaiser_value /
kaiser_Fourier_value). Host numpy/scipy: the reconstruction uses them to
build the grid-sampled blob kernel and the deapodization table once.
"""
from __future__ import annotations

import numpy as np
from scipy import special


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
