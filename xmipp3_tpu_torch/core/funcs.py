"""Numeric function library + histograms: densities, CDFs, Histogram1D/2D,
Otsu thresholds; the port's own copy of the reference package's
core/funcs.py (host numpy and scipy, no device code).

Contract: xmippCore histogram/funcs (reference Histogram1D/2D with
percentil/entropy, OtsuSegmentation in data/filters.h:216). Vectorized
numpy: host-side helpers feeding device batches."""
from __future__ import annotations

import numpy as np
from scipy import special


# ---------------------------------------------------------------------------
# densities / distributions
# ---------------------------------------------------------------------------

def gaussian1d(x, sigma=1.0, mu=0.0):
    x = (np.asarray(x, np.float64) - mu) / sigma
    return np.exp(-0.5 * x * x) / (np.sqrt(2 * np.pi) * sigma)


def gaussian2d(x, y, sx=1.0, sy=1.0, ang_deg=0.0, mx=0.0, my=0.0):
    a = np.deg2rad(ang_deg)
    xr = (np.asarray(x) - mx) * np.cos(a) + (np.asarray(y) - my) * np.sin(a)
    yr = -(np.asarray(x) - mx) * np.sin(a) + (np.asarray(y) - my) * np.cos(a)
    return np.exp(-0.5 * ((xr / sx) ** 2 + (yr / sy) ** 2)) / \
        (2 * np.pi * sx * sy)


def tstudent1d(x, df, sigma=1.0, mu=0.0):
    t = (np.asarray(x, np.float64) - mu) / sigma
    return (special.gamma((df + 1) / 2)
            / (np.sqrt(df * np.pi) * special.gamma(df / 2) * sigma)
            * np.power(1 + t * t / df, -(df + 1) / 2))


def lognormal1d(x, sigma=1.0, mu=0.0):
    x = np.asarray(x, np.float64)
    out = np.zeros_like(x)
    pos = x > 0
    out[pos] = np.exp(-0.5 * ((np.log(x[pos]) - mu) / sigma) ** 2) / \
        (x[pos] * sigma * np.sqrt(2 * np.pi))
    return out


def cdf_gauss(z):
    return 0.5 * (1 + special.erf(np.asarray(z, np.float64) / np.sqrt(2)))


def icdf_gauss(p):
    return np.sqrt(2) * special.erfinv(2 * np.asarray(p, np.float64) - 1)


def cdf_tstudent(t, df):
    t = np.asarray(t, np.float64)
    x = df / (df + t * t)
    ib = 0.5 * special.betainc(df / 2.0, 0.5, x)
    return np.where(t > 0, 1 - ib, ib)


def chi2_cdf(x, df):
    return special.gammainc(df / 2.0, np.asarray(x, np.float64) / 2.0)


# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------

class Histogram1D:
    """Value histogram with percentile/entropy queries (reference
    Histogram1D contract: init(min,max,steps), insert values, percentil)."""

    def __init__(self, data=None, nbins: int = 256, vmin=None, vmax=None):
        self.nbins = nbins
        self.hist = np.zeros(nbins)
        self.vmin = vmin
        self.vmax = vmax
        if data is not None:
            self.build(data, nbins, vmin, vmax)

    def build(self, data, nbins=None, vmin=None, vmax=None):
        data = np.asarray(data).ravel()
        self.nbins = nbins or self.nbins
        self.vmin = float(data.min()) if vmin is None else vmin
        self.vmax = float(data.max()) if vmax is None else vmax
        self.hist, self.edges = np.histogram(
            data, bins=self.nbins, range=(self.vmin, self.vmax))
        return self

    @property
    def centers(self):
        return 0.5 * (self.edges[:-1] + self.edges[1:])

    def percentil(self, pct: float) -> float:
        """Value below which pct% of the mass lies."""
        c = np.cumsum(self.hist)
        total = c[-1]
        if total == 0:
            return self.vmin
        idx = np.searchsorted(c, pct / 100.0 * total)
        idx = min(idx, self.nbins - 1)
        return float(self.centers[idx])

    def mass_below(self, value: float) -> float:
        idx = np.searchsorted(self.edges, value) - 1
        idx = np.clip(idx, 0, self.nbins - 1)
        return float(self.hist[:idx + 1].sum() / max(self.hist.sum(), 1))

    def entropy(self) -> float:
        p = self.hist / max(self.hist.sum(), 1)
        p = p[p > 0]
        return float(-(p * np.log2(p)).sum())


class Histogram2D:
    def __init__(self, x, y, nbins=(64, 64), ranges=None):
        self.hist, self.xedges, self.yedges = np.histogram2d(
            np.asarray(x).ravel(), np.asarray(y).ravel(), bins=nbins,
            range=ranges)

    def entropy(self) -> float:
        p = self.hist / max(self.hist.sum(), 1)
        p = p[p > 0]
        return float(-(p * np.log2(p)).sum())


def otsu_threshold(data, nbins: int = 256) -> float:
    """Otsu's between-class-variance threshold (reference OtsuSegmentation,
    data/filters.h:216)."""
    data = np.asarray(data).ravel()
    hist, edges = np.histogram(data, bins=nbins)
    centers = 0.5 * (edges[:-1] + edges[1:])
    p = hist / max(hist.sum(), 1)
    w0 = np.cumsum(p)
    w1 = 1 - w0
    mu = np.cumsum(p * centers)
    mu_t = mu[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        var_between = (mu_t * w0 - mu) ** 2 / np.maximum(w0 * w1, 1e-12)
    var_between[(w0 == 0) | (w1 == 0)] = 0
    return float(centers[int(np.argmax(var_between))])


def entropy_otsu_threshold(data, nbins: int = 256) -> float:
    """Combined entropy+Otsu criterion (reference EntropyOtsuSegmentation):
    maximize between-class variance times the split-entropy term."""
    data = np.asarray(data).ravel()
    hist, edges = np.histogram(data, bins=nbins)
    centers = 0.5 * (edges[:-1] + edges[1:])
    p = hist / max(hist.sum(), 1)
    w0 = np.cumsum(p)
    w1 = 1 - w0
    mu = np.cumsum(p * centers)
    mu_t = mu[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        var_b = (mu_t * w0 - mu) ** 2 / np.maximum(w0 * w1, 1e-12)
        Hw = -(w0 * np.log(np.maximum(w0, 1e-12))
               + w1 * np.log(np.maximum(w1, 1e-12)))
    crit = var_b * Hw
    crit[(w0 == 0) | (w1 == 0)] = 0
    return float(centers[int(np.argmax(crit))])


# ---------------------------------------------------------------------------
# polynomials
# ---------------------------------------------------------------------------

def legendre(n: int, x):
    return special.eval_legendre(n, np.asarray(x, np.float64))


def zernike2d(n: int, m: int, rho, theta):
    """Real 2D Zernike polynomial Z_n^m on the unit disk (the PSD-fitting
    basis; reference polynomials code)."""
    rho = np.asarray(rho, np.float64)
    theta = np.asarray(theta, np.float64)
    am = abs(m)
    R = np.zeros_like(rho)
    for k in range((n - am) // 2 + 1):
        c = ((-1) ** k * special.factorial(n - k)
             / (special.factorial(k) * special.factorial((n + am) // 2 - k)
                * special.factorial((n - am) // 2 - k)))
        R += c * rho ** (n - 2 * k)
    R = np.where(rho <= 1.0, R, 0.0)
    if m >= 0:
        return R * np.cos(am * theta)
    return R * np.sin(am * theta)


def radial_average_noncubic(vol, rounding: bool = False):
    """Radial average of a (possibly non-cubic) volume over in-plane (x, y)
    distance from the centered origin, all z-slices pooled (the reference
    radialAverageNonCubic with a 2-D center; behavior pinned by
    tests/test_golden_multidim.py on the reference's smallVolume.vol:
    len 46 / count[0]==4 without rounding, len 47 with rounding).

    Bin = round(r) when `rounding` else floor(r); the output length comes
    from the geometric maximum sqrt((X/2)^2 + (Y/2)^2), so trailing bins
    may be empty (mean 0). Returns (radial_mean, radial_count)."""
    v = np.asarray(vol, np.float64)
    if v.ndim == 2:
        v = v[None]
    Z, H, W = v.shape
    y = np.arange(H) - H // 2
    x = np.arange(W) - W // 2
    r = np.sqrt(y[:, None] ** 2.0 + x[None, :] ** 2.0)
    rmax = np.sqrt((H // 2) ** 2.0 + (W // 2) ** 2.0)
    n = int(np.ceil(rmax) if rounding else np.floor(rmax)) + 1
    idx = (np.round(r) if rounding else np.floor(r)).astype(np.int64)
    idx = np.minimum(idx, n - 1)
    count = np.bincount(idx.ravel(), minlength=n) * Z
    sums = np.zeros(n)
    for k in range(Z):
        sums += np.bincount(idx.ravel(), weights=v[k].ravel(), minlength=n)
    mean = np.where(count > 0, sums / np.maximum(count, 1), 0.0)
    return mean, count


def compare_two_files(fn1: str, fn2: str, offset: int = 0) -> bool:
    """Byte-wise file equality skipping the first `offset` bytes (reference
    core/xmipp_funcs compareTwoFiles, exercised by
    applications/tests/function_tests/test_funcs_main.cpp)."""
    import os
    s1, s2 = os.path.getsize(fn1), os.path.getsize(fn2)
    if s1 != s2:
        return False
    with open(fn1, "rb") as f1, open(fn2, "rb") as f2:
        f1.seek(offset)
        f2.seek(offset)
        while True:
            b1 = f1.read(1 << 20)
            b2 = f2.read(1 << 20)
            if b1 != b2:
                return False
            if not b1:
                return True
