"""2-D causal ARMA spectral PSD model.

Contract: reference CausalARMA (ctf_estimate_psd_with_arma.cpp:92) — AR
part by Yule-Walker normal equations over a causal half-plane support, MA
part from the AR-whitened autocovariance. Shared by
xmipp_ctf_estimate_psd_with_arma and the micrograph program's
--psd_estimator ARMA mode (ctf_estimate_from_micrograph.cpp:54).
A copy of the reference package's ops/arma.py: host numpy in float64.
"""
from __future__ import annotations

import numpy as np


def causal_arma_psd(tiles, p: int, Nh: int = 12, Nv: int = 12,
                    N_MA: int = 6, M_MA: int = 6) -> np.ndarray:
    """ARMA PSD (p, p), non-centered fft layout, from the tile-averaged
    autocorrelation of `tiles` (iterable of 2-D float arrays)."""
    tiles = list(tiles)
    acf = np.zeros((2 * Nv + 1, 2 * Nh + 1))
    for t in tiles:
        tt = np.asarray(t, np.float64)
        tt = tt - tt.mean()
        Ft = np.fft.rfft2(tt)
        ac = np.fft.irfft2(np.abs(Ft) ** 2, s=tt.shape) / tt.size
        block = np.zeros_like(acf)
        block[Nv:, Nh:] = ac[:Nv + 1, :Nh + 1]
        block[:Nv, Nh:] = ac[-Nv:, :Nh + 1]
        block[Nv:, :Nh] = ac[:Nv + 1, -Nh:]
        block[:Nv, :Nh] = ac[-Nv:, -Nh:]
        acf += block
    acf /= max(len(tiles), 1)
    # causal AR support: (dy, dx) with dy>0 or (dy==0 and dx>0)
    support = [(dy, dx) for dy in range(0, Nv + 1)
               for dx in range(-Nh, Nh + 1)
               if (dy > 0 or dx > 0)]
    K = len(support)
    R = np.zeros((K, K))
    rvec = np.zeros(K)

    def ac(dy, dx):
        return acf[Nv + dy if abs(dy) <= Nv else 0,
                   Nh + dx if abs(dx) <= Nh else 0] \
            if abs(dy) <= Nv and abs(dx) <= Nh else 0.0

    for i, (iy, ix) in enumerate(support):
        rvec[i] = ac(iy, ix)
        for j, (jy, jx) in enumerate(support):
            R[i, j] = ac(iy - jy, ix - jx)
    coeffs = np.linalg.solve(R + 1e-8 * np.trace(R) / K * np.eye(K), rvec)
    sigma2 = ac(0, 0) - coeffs @ rvec
    fy = np.fft.fftfreq(p)[:, None]
    fx = np.fft.fftfreq(p)[None, :]
    denom = np.ones((p, p), np.complex128)
    for (dy, dx), a in zip(support, coeffs):
        denom -= a * np.exp(-2j * np.pi * (fy * dy + fx * dx))
    if N_MA > 0 and M_MA > 0:
        # MA numerator: autocovariance of the AR-whitened process,
        # c_e(l) = sum_m Ra(m) gamma(l - m) with Ra = autocorrelation of
        # the AR coefficient array (a_(0,0) = -1) — i.e. conv(Ra, gamma)
        # (no refiltering); numerator spectrum = DFT of c_e over the MA
        # support
        from scipy.signal import fftconvolve
        A = np.zeros((Nv + 1, 2 * Nh + 1))
        A[0, Nh] = -1.0
        for (dy, dx), a in zip(support, coeffs):
            A[dy, Nh + dx] = a
        Ra = fftconvolve(A, A[::-1, ::-1])        # (2Nv+1, 4Nh+1)
        ce = fftconvolve(Ra, acf)                 # lags around center
        cy, cx = (ce.shape[0] - 1) // 2, (ce.shape[1] - 1) // 2
        num = np.zeros((p, p), np.complex128)
        for ly in range(-N_MA, N_MA + 1):
            for lx in range(-M_MA, M_MA + 1):
                num += ce[cy + ly, cx + lx] * np.exp(
                    -2j * np.pi * (fy * ly + fx * lx))
        psd = np.maximum(np.real(num), 1e-12 * abs(sigma2)) / \
            np.maximum(np.abs(denom) ** 2, 1e-12)
    else:
        psd = np.abs(sigma2) / np.maximum(np.abs(denom) ** 2, 1e-12)
    return psd, float(abs(sigma2))
