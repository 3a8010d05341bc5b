"""Real-space filter family for xmipp_transform_filter.

Counterpart of the reference package's ops/spatial_filters.py (reference
data/filters.{h,cpp}: medianFilter3x3, boundMedianFilter, pixelDesvFilter,
forcePositive, logFilter, substractBackgroundRollingBall, smoothingShah,
RetinexFilter, BasisFilter, and reconstruction/mean_shift.cpp).

The batched filters (median, log, basis, mean shift, Shah diffusion) run on
the images' device; Shah runs Jacobi sweeps, as the reference package does
(the C++ Gauss-Seidel reaches the same fixed point). The bad-pixel repair
family, the rolling ball and retinex run on the host in numpy/scipy, where
the reference package runs them.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from xmipp3_tpu_torch.device import as_tensor

__all__ = [
    "median_3x3", "log_filter", "bound_median_filter", "force_positive",
    "pixel_desv_filter", "rolling_ball_background", "mean_shift_filter",
    "retinex_filter", "basis_filter", "smoothing_shah",
]


# ---------------------------------------------------------------------------
# median 3x3 (filters.h medianFilter3x3)
# ---------------------------------------------------------------------------

def median_3x3(imgs, device=None):
    """3x3 median with edge replication, batched over the leading axis."""
    x = as_tensor(imgs, device)
    single = x.ndim == 2
    if single:
        x = x[None]
    H, W = x.shape[-2:]
    p = F.pad(x[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    stack = torch.stack([p[:, 1 + dy:H + 1 + dy, 1 + dx:W + 1 + dx]
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)], dim=0)
    out = stack.median(dim=0).values      # 9 values: the middle one
    return out[0] if single else out


# ---------------------------------------------------------------------------
# log filter (filters.h logFilter): a - b*log(x + c)
# ---------------------------------------------------------------------------

def log_filter(imgs, a: float, b: float, c: float, device=None):
    x = as_tensor(imgs, device)
    return a - b * torch.log(x + c)


# ---------------------------------------------------------------------------
# bad-pixel repair (filters.h boundMedianFilter / pixelDesvFilter,
# filters.cpp forcePositive), host numpy
# ---------------------------------------------------------------------------

def bound_median_filter(img, mask):
    """Replace masked pixels by the median of their UNMASKED 5x5
    neighbours; repeat (shrinking the mask) until none remain.  Works on
    2-D or 3-D arrays, same repair rule as the reference's
    boundMedianFilter (5x5x5 neighbourhood in 3-D)."""
    import warnings
    out = np.array(img, np.float32, copy=True)
    bad = np.asarray(mask, bool).copy()
    if out.ndim == 2:
        out3 = out[None]
        bad3 = bad[None]
    else:
        out3, bad3 = out, bad
    Z, H, W = out3.shape
    offs = [(dz, dy, dx)
            for dz in (range(-2, 3) if Z > 1 else (0,))
            for dy in range(-2, 3) for dx in range(-2, 3)
            if not (dz == 0 and dy == 0 and dx == 0)]
    while bad3.any():
        vals = np.full((len(offs),) + out3.shape, np.nan, np.float32)
        for n, (dz, dy, dx) in enumerate(offs):
            src_z = slice(max(0, -dz), Z - max(0, dz))
            dst_z = slice(max(0, dz), Z - max(0, -dz))
            src_y = slice(max(0, -dy), H - max(0, dy))
            dst_y = slice(max(0, dy), H - max(0, -dy))
            src_x = slice(max(0, -dx), W - max(0, dx))
            dst_x = slice(max(0, dx), W - max(0, -dx))
            v = out3[src_z, src_y, src_x].copy()
            v[bad3[src_z, src_y, src_x]] = np.nan
            vals[n, dst_z, dst_y, dst_x] = v
        with np.errstate(all="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            med = np.nanmedian(vals, axis=0)
        fixable = bad3 & np.isfinite(med)
        if not fixable.any():
            break  # fully surrounded by bad pixels and image is all bad
        out3[fixable] = med[fixable]
        bad3 &= ~fixable
    return out if out.ndim == np.ndim(img) else out3[0]


def force_positive(img):
    """Repair non-positive pixels with the boundaries median filter
    (filters.cpp forcePositive)."""
    img = np.asarray(img, np.float32)
    return bound_median_filter(img, img <= 0)


def pixel_desv_filter(img, factor: float):
    """Repair pixels outside [mean - factor*std, mean + factor*std]
    (filters.h pixelDesvFilter)."""
    img = np.asarray(img, np.float32)
    if factor <= 0:
        return img.copy()
    avg, std = float(img.mean()), float(img.std())
    bad = (img < avg - factor * std) | (img > avg + factor * std)
    return bound_median_filter(img, bad)


# ---------------------------------------------------------------------------
# rolling-ball background (filters.cpp substractBackgroundRollingBall)
# ---------------------------------------------------------------------------

def rolling_ball_background(img, radius: int):
    """Subtract an ImageJ-style rolling-ball background: shrink by
    min-pooling, morphological opening with the ball height profile,
    bilinear re-expansion, then subtract.  Same shrink factors and arc
    trims as the reference. Host numpy/scipy."""
    from scipy.ndimage import grey_dilation, grey_erosion, zoom
    img = np.asarray(img, np.float64)
    if radius <= 10:
        shrink, trim = 1, 24
    elif radius <= 30:
        shrink, trim = 2, 24
    elif radius <= 100:
        shrink, trim = 4, 32
    else:
        shrink, trim = 8, 40
    small_r = max(1.0, radius / shrink)
    half = int(round(small_r - int(trim * small_r) / 100))
    w = 2 * half + 1
    yy, xx = np.mgrid[0:w, 0:w].astype(np.float64) - half
    t = small_r * small_r - yy * yy - xx * xx
    ball = np.where(t > 0, np.sqrt(np.maximum(t, 0)), 0.0)
    H, W = img.shape
    sh, sw = (H + shrink - 1) // shrink, (W + shrink - 1) // shrink
    if shrink > 1:
        pad_h, pad_w = sh * shrink - H, sw * shrink - W
        p = np.pad(img, ((0, pad_h), (0, pad_w)), mode="edge")
        shrunk = p.reshape(sh, shrink, sw, shrink).min(axis=(1, 3))
    else:
        shrunk = img
    bg_small = grey_dilation(grey_erosion(shrunk, structure=ball),
                             structure=ball)
    if shrink > 1:
        bg = zoom(bg_small, shrink, order=1)[:H, :W]
    else:
        bg = bg_small
    return (img - bg).astype(np.float32)


# ---------------------------------------------------------------------------
# mean shift (reconstruction/mean_shift.cpp)
# ---------------------------------------------------------------------------

def _mean_shift(x, hr: float, hs_i: int, iters: int, fast: bool):
    offs = [(dy, dx) for dy in range(-hs_i, hs_i + 1)
            for dx in range(-hs_i, hs_i + 1)]
    offs_a = torch.tensor(offs, dtype=torch.int32, device=x.device)
    sw = (torch.exp(-(offs_a[:, 0] ** 2 + offs_a[:, 1] ** 2)
                    / (2.0 * max(hs_i, 1) ** 2))
          if not fast else torch.ones(len(offs), device=x.device))
    inv_2r2 = 1.0 / (2.0 * hr * hr)
    img = x
    for _ in range(iters):
        num = torch.zeros_like(img)
        den = torch.zeros_like(img)
        for i, (dy, dx) in enumerate(offs):
            nb = torch.roll(img, (-dy, -dx), dims=(1, 2))
            if fast:
                wr = ((nb - img).abs() <= 3.0 * hr).to(img.dtype)
            else:
                wr = torch.exp(-(nb - img) ** 2 * inv_2r2)
            w = wr * sw[i]
            num = num + w * nb
            den = den + w
        img = num / den.clamp(min=1e-30)
    return img


def mean_shift_filter(imgs, hr: float, hs: float, iters: int = 1,
                      fast: bool = False, device=None):
    """Iterated spatial/range mean-shift smoothing.  `hr`/`hs` are the
    range/spatial sigmas as in the reference (which divides both by 3 in
    the exact mode to get the gaussian sigma from the window size)."""
    x = as_tensor(imgs, device)
    single = x.ndim == 2
    if single:
        x = x[None]
    if fast:
        hs_i, hr_eff = max(1, int(np.ceil(hs))), hr
    else:
        hs_i, hr_eff = max(1, int(np.ceil(hs / 3.0))), hr / 3.0
    out = _mean_shift(x, float(hr_eff), hs_i * (3 if not fast else 1),
                      int(iters), bool(fast))
    return out[0] if single else out


# ---------------------------------------------------------------------------
# retinex (filters.cpp RetinexFilter)
# ---------------------------------------------------------------------------

def retinex_filter(img, percentile: float = 0.9, mask=None,
                   eps: float = 1.0):
    """Forward discrete Laplacian in Fourier space, zero all values whose
    |value| is below the given percentile (computed outside the mask if
    one is given), inverse Laplacian back. Host numpy."""
    img = np.asarray(img, np.float32)
    axes_n = img.shape

    def lap_gain(direct):
        gain = np.zeros(axes_n, np.float64) + (len(axes_n) * 2 + eps)
        for ax, n in enumerate(axes_n):
            f = np.fft.fftfreq(n)
            shape = [1] * len(axes_n)
            shape[ax] = n
            gain = gain - 2 * np.cos(2 * np.pi * f).reshape(shape)
        if not direct:
            gain = np.where(gain > 0, 1.0 / gain, gain)
        return gain

    F_ = np.fft.fftn(img)
    lap = np.real(np.fft.ifftn(F_ * lap_gain(True))).astype(np.float32)
    sel = (np.abs(lap) if mask is None
           else np.abs(lap)[np.asarray(mask) == 0])
    vals = np.sort(sel.ravel())
    thr = vals[min(len(vals) - 1, int(percentile * len(vals)))]
    lap = np.where(np.abs(lap) < thr, 0.0, lap)
    out = np.real(np.fft.ifftn(np.fft.fftn(lap) * lap_gain(False)))
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# basis projection (filters.cpp BasisFilter)
# ---------------------------------------------------------------------------

def basis_filter(imgs, basis, device=None):
    """Project each image onto the (non-orthogonalized) basis stack and
    re-synthesize: out = sum_n <img, b_n> b_n."""
    x = as_tensor(imgs, device)
    b = as_tensor(basis, x.device)
    single = x.ndim == 2
    if single:
        x = x[None]
    coef = torch.einsum("byx,nyx->bn", x, b)
    out = torch.einsum("bn,nyx->byx", coef, b)
    return out[0] if single else out


# ---------------------------------------------------------------------------
# Shah anisotropic diffusion (filters.cpp smoothingShah)
# ---------------------------------------------------------------------------

def _shah(img, w, outer: int, inner: int, refinement: int):
    f0 = img
    inner_m = torch.zeros_like(img)
    inner_m[1:-1, 1:-1] = 1.0        # the reference sweeps interior pixels

    def surface_update(fs, s):
        sx = 0.5 * (torch.roll(s, -1, 1) - torch.roll(s, 1, 1))
        sy = 0.5 * (torch.roll(s, -1, 0) - torch.roll(s, 1, 0))
        ns2 = (1 - s) ** 2
        fxp = torch.roll(fs, -1, 1)
        fxm = torch.roll(fs, 1, 1)
        fyp = torch.roll(fs, -1, 0)
        fym = torch.roll(fs, 1, 0)
        fx = 0.5 * (fxp - fxm)
        fy = 0.5 * (fyp - fym)
        wfx = 4 * w[1] * (1 - s) * sx
        wfy = 4 * w[1] * (1 - s) * sy
        wfxx = -2 * w[1] * ns2
        constant = -2 * w[0] * f0
        central = -2 * w[0] + 4 * wfxx
        neigh = wfx * fx + wfy * fy + wfxx * (fxp + fxm) + wfxx * (fyp + fym)
        new = torch.where(central.abs() > 1e-12,
                          (constant + neigh) / central, f0)
        new = new.clamp(0.0, 1.0)
        return fs * (1 - inner_m) + new * inner_m

    def edge_update(fs, s, k):
        fx = 0.5 * (torch.roll(fs, -1, 1) - torch.roll(fs, 1, 1))
        fy = 0.5 * (torch.roll(fs, -1, 0) - torch.roll(fs, 1, 0))
        constant = w[1] * (fx * fx + fy * fy)
        central = w[2] * k + w[3] / k * 4
        neigh = (w[3] / k) * (torch.roll(s, 1, 0) + torch.roll(s, -1, 0)
                              + torch.roll(s, 1, 1) + torch.roll(s, -1, 1))
        new = (constant + neigh) / (constant + central)
        new = torch.where(new < 0, s * 0.5,
                          torch.where(new > 1, 0.5 * (s + 1), new))
        return s * (1 - inner_m) + new * inner_m

    fs = img
    s = torch.zeros_like(img)
    for k in range(1, refinement + 1):
        s = torch.zeros_like(img)
        for _ in range(outer):
            for _ in range(inner):
                fs = surface_update(fs, s)
            for _ in range(inner):
                s = edge_update(fs, s, float(k))
    return fs, s


def smoothing_shah(img, weights=(0.0, 50.0, 50.0, 0.02), outer: int = 10,
                   inner: int = 1, refinement: int = 1,
                   adjust_range: bool = True, device=None):
    """Mumford-Shah surface/edge smoothing of one image on its device.
    Returns (surface, edge) tensors. Jacobi sweeps (the reference's
    Gauss-Seidel reaches the same fixed point)."""
    x = as_tensor(img, device)
    if adjust_range:
        lo, hi = float(x.min()), float(x.max())
        x = (x - lo) / (hi - lo) if hi > lo else x * 0.0
    w = as_tensor(weights, x.device)
    return _shah(x, w, int(outer), int(inner), int(refinement))
