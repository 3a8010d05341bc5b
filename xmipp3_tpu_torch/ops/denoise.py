"""Denoising ops: total-variation (Chambolle), Haar and Daubechies wavelet
filters, on the images' device.

Counterpart of the reference package's ops/denoise.py (reference
DenoiseTVFilter, data/filters.h:1441-1596; the WaveletFilter family of
reconstruction/denoise.{h,cpp}): pyramids of batched periodic separable
convolutions with exact inverses.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor
from xmipp3_tpu_torch.ops.normalize import _median

_SQRT2 = float(np.sqrt(2))


def _median_all(x):
    """The median of every element (numpy's convention)."""
    return _median(x.reshape(-1), 0)


def _percentile(x, q: float):
    """numpy's default (linear) percentile q (0-100) of every element."""
    s = x.reshape(-1).sort().values
    pos = (q / 100.0) * (s.numel() - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, s.numel() - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def tv_denoise_2d(imgs, weight: float = 0.1, n_iters: int = 50,
                  device=None):
    """Rudin-Osher-Fatemi TV denoising via Chambolle's dual projection.

    imgs (B,H,W); weight = regularization strength (bigger = smoother)."""
    imgs = as_tensor(imgs, device)
    single = imgs.ndim == 2
    if single:
        imgs = imgs[None]
    tau = 0.25

    def grad(u):
        gx = torch.diff(u, dim=-1, append=u[..., -1:])
        gy = torch.diff(u, dim=-2, append=u[..., -1:, :])
        return gx, gy

    def div(px, py):
        dx = px - torch.roll(px, 1, dims=-1)
        dx[..., 0] = px[..., 0]
        dx[..., -1] = -px[..., -2]
        dy = py - torch.roll(py, 1, dims=-2)
        dy[..., 0, :] = py[..., 0, :]
        dy[..., -1, :] = -py[..., -2, :]
        return dx + dy

    px = torch.zeros_like(imgs)
    py = torch.zeros_like(imgs)
    for _ in range(n_iters):
        # Chambolle 2004: p <- (p + tau*grad(div p - f/lambda)) /
        #                      (1 + tau*|grad(div p - f/lambda)|)
        gx, gy = grad(div(px, py) - imgs / weight)
        mag = torch.sqrt(gx * gx + gy * gy)
        px = (px + tau * gx) / (1 + tau * mag)
        py = (py + tau * gy) / (1 + tau * mag)
    out = imgs - weight * div(px, py)
    return out[0] if single else out


def _haar_dwt2(x):
    """One Haar DWT level: (B, H, W) -> (LL, (LH, HL, HH))."""
    a = (x[..., 0::2, :] + x[..., 1::2, :]) / _SQRT2
    d = (x[..., 0::2, :] - x[..., 1::2, :]) / _SQRT2
    ll = (a[..., :, 0::2] + a[..., :, 1::2]) / _SQRT2
    lh = (a[..., :, 0::2] - a[..., :, 1::2]) / _SQRT2
    hl = (d[..., :, 0::2] + d[..., :, 1::2]) / _SQRT2
    hh = (d[..., :, 0::2] - d[..., :, 1::2]) / _SQRT2
    return ll, (lh, hl, hh)


def _interleave(even, odd, dim):
    """even and odd samples merged along `dim` (even first)."""
    d = dim % even.ndim
    return torch.stack([even, odd], dim=d + 1).flatten(d, d + 1)


def _haar_idwt2(ll, bands):
    lh, hl, hh = bands
    a = _interleave((ll + lh) / _SQRT2, (ll - lh) / _SQRT2, -1)
    d = _interleave((hl + hh) / _SQRT2, (hl - hh) / _SQRT2, -1)
    return _interleave((a + d) / _SQRT2, (a - d) / _SQRT2, -2)


def dwt3(vol, device=None):
    """One 3D Haar DWT level: (Z, Y, X) -> list of 8 subbands ordered
    [lll, llh, lhl, lhh, hll, hlh, hhl, hhh] (z-axis split first)."""
    x = as_tensor(vol, device)

    def split(u, axis):
        ev = u[(slice(None),) * axis + (slice(0, None, 2),)]
        od = u[(slice(None),) * axis + (slice(1, None, 2),)]
        return (ev + od) / _SQRT2, (ev - od) / _SQRT2

    bands = [x]
    for axis in (0, 1, 2):
        bands = [b for u in bands for b in split(u, axis)]
    return bands


def idwt3(bands, device=None):
    """Inverse of dwt3."""
    bands = [as_tensor(b, device) for b in bands]

    def merge(lo, hi, axis):
        return _interleave((lo + hi) / _SQRT2, (lo - hi) / _SQRT2, axis)

    for axis in (2, 1, 0):
        bands = [merge(bands[i], bands[i + 1], axis)
                 for i in range(0, len(bands), 2)]
    return bands[0]


def wavelet_denoise_2d(imgs, threshold_sigmas: float = 2.5, levels: int = 3,
                       device=None):
    """Haar DWT soft-threshold denoising (reference ProgFilter wavelet modes).

    Noise sigma estimated from the finest HH band (MAD over the batch)."""
    imgs = as_tensor(imgs, device)
    single = imgs.ndim == 2
    if single:
        imgs = imgs[None]
    lls, bandss = [], []
    x = imgs
    for _ in range(levels):
        x, bands = _haar_dwt2(x)
        lls.append(x)
        bandss.append(bands)
    sigma = _median_all(bandss[0][2].abs()) / 0.6745
    th = threshold_sigmas * sigma

    def soft(v):
        return torch.sign(v) * (v.abs() - th).clamp(min=0.0)

    rec = lls[-1]
    for lvl in range(levels - 1, -1, -1):
        rec = _haar_idwt2(rec, tuple(soft(b) for b in bandss[lvl]))
    return rec[0] if single else rec


# ---------------------------------------------------------------------------
# Daubechies banks (periodic boundary handling, exact reconstruction)
# ---------------------------------------------------------------------------

_SQ3 = np.sqrt(3.0)
_DB4_H = np.array([1 + _SQ3, 3 + _SQ3, 3 - _SQ3, 1 - _SQ3]) / (4 * np.sqrt(2))

_DAUB_H = {
    # standard orthogonal Daubechies lowpass banks (sum = sqrt(2))
    "DAUB4": _DB4_H,
    "DAUB12": np.array([
        0.111540743350, 0.494623890398, 0.751133908021, 0.315250351709,
        -0.226264693965, -0.129766867567, 0.097501605587, 0.027522865530,
        -0.031582039318, 0.000553842201, 0.004777257511, -0.001077301085]),
    "DAUB20": np.array([
        0.026670057901, 0.188176800078, 0.527201188932, 0.688459039454,
        0.281172343661, -0.249846424327, -0.195946274377, 0.127369340336,
        0.093057364604, -0.071394147166, -0.029457536822, 0.033212674059,
        0.003606553567, -0.010733175483, 0.001395351747, 0.001992405295,
        -0.000685856695, -0.000116466855, 0.000093588670, -0.000013264203]),
}


def _daub_filters(kind: str):
    h = np.asarray(_DAUB_H[kind.upper()], np.float64)
    g = np.array([(-1) ** k * h[len(h) - 1 - k] for k in range(len(h))])
    return h, g


def _daub_analysis_1d(x, axis, h, g):
    x = x.movedim(axis, -1)
    taps = [torch.roll(x, -k, dims=-1) for k in range(len(h))]
    lo = sum(float(h[k]) * taps[k] for k in range(len(h)))[..., 0::2]
    hi = sum(float(g[k]) * taps[k] for k in range(len(g)))[..., 0::2]
    return lo.movedim(-1, axis), hi.movedim(-1, axis)


def _daub_synthesis_1d(lo, hi, axis, h, g):
    lo = lo.movedim(axis, -1)
    hi = hi.movedim(axis, -1)
    up_lo = _interleave(lo, torch.zeros_like(lo), -1)
    up_hi = _interleave(hi, torch.zeros_like(hi), -1)
    x = sum(float(h[k]) * torch.roll(up_lo, k, dims=-1)
            + float(g[k]) * torch.roll(up_hi, k, dims=-1)
            for k in range(len(h)))
    return x.movedim(-1, axis)


def daub_dwt2(x, levels: int = 1, kind: str = "DAUB4", device=None):
    """2-D Daubechies DWT pyramid: (ll, [(lh, hl, hh)...] finest first)."""
    h, g = _daub_filters(kind)
    cur = as_tensor(x, device)
    details = []
    for _ in range(levels):
        lo, hi = _daub_analysis_1d(cur, -1, h, g)
        ll, lh = _daub_analysis_1d(lo, -2, h, g)
        hl, hh = _daub_analysis_1d(hi, -2, h, g)
        details.append((lh, hl, hh))
        cur = ll
    return cur, details


def daub_idwt2(ll, details, kind: str = "DAUB4"):
    """Exact inverse of daub_dwt2."""
    h, g = _daub_filters(kind)
    cur = ll
    for lh, hl, hh in reversed(details):
        lo = _daub_synthesis_1d(cur, lh, -2, h, g)
        hi = _daub_synthesis_1d(hl, hh, -2, h, g)
        cur = _daub_synthesis_1d(lo, hi, -1, h, g)
    return cur


def db4_dwt2(x, levels: int = 1, device=None):
    """2-D db4 DWT pyramid (daub_dwt2 with the DAUB4 bank)."""
    return daub_dwt2(x, levels, "DAUB4", device)


def db4_idwt2(ll, details):
    """Exact inverse of db4_dwt2."""
    return daub_idwt2(ll, details, "DAUB4")


def db4_denoise_2d(imgs, threshold_sigmas: float = 3.0, levels: int = 2,
                   device=None):
    """Soft-threshold db4 wavelet denoising (the reference's
    xmipp_transform_filter --wavelet / DWT denoising role). The noise
    scale is the MAD of the finest diagonal band."""
    ll, details = db4_dwt2(imgs, levels, device)
    thr = threshold_sigmas * _median_all(details[0][2].abs()) / 0.6745

    def soft(c):
        return torch.sign(c) * (c.abs() - thr).clamp(min=0.0)

    return db4_idwt2(ll, [(soft(lh), soft(hl), soft(hh))
                          for lh, hl, hh in details])


def _band_radius_mask(shape, level, R, device):
    """Coefficients whose spatial support center lies within radius R of
    the image center (DWT_keep_central_part semantics, per band)."""
    hy, wx = shape[-2], shape[-1]
    scale = 2 ** (level + 1)
    yy = (torch.arange(hy, device=device) - hy / 2.0) * scale
    xx = (torch.arange(wx, device=device) - wx / 2.0) * scale
    r = torch.sqrt(yy[:, None] ** 2 + xx[None, :] ** 2)
    return (r <= R).to(torch.float32)


def wavelet_filter_2d(imgs, kind: str = "DAUB12", mode: str = "remove_scale",
                      scale: int = 0, output_scale: int = 0,
                      threshold_pct: float = 50.0, R: int = -1,
                      snr0: float = 0.1, snrf: float = 0.2,
                      white_noise: bool = False, device=None):
    """The reference WaveletFilter mode family (denoise.cpp apply()):

    - remove_scale: zero the detail quadrants at `scale`
    - soft_thresholding: soft-threshold details at the `threshold_pct`
      percentile of |coefficients|
    - bayesian: per-band Wiener shrinkage, noise from the finest HH MAD,
      prior SNR clipped to [snr0, snrf] (white_noise keeps the per-band
      noise flat)
    - adaptive_soft: per-band BayesShrink threshold sigma_n^2/sigma_x
    - central: keep coefficients whose support lies within radius R

    output_scale > 0 drops that many finest levels from the synthesis
    (image shrinks by 2^output_scale, reference denoise.cpp:188-193).
    """
    x = as_tensor(imgs, device)
    single = x.ndim == 2
    if single:
        x = x[None]
    n = min(x.shape[-2:])
    max_levels = max(1, int(np.log2(n)) - 2)
    levels = max(max_levels, scale + 1, output_scale)
    levels = min(levels, int(np.log2(n)) - 1)
    ll, details = daub_dwt2(x, levels, kind)
    sigma_n = _median_all(details[0][2].abs()) / 0.6745
    var = lambda b: b.var(correction=0)

    if mode == "remove_scale":
        s = min(scale, levels - 1)
        details = [tuple(torch.zeros_like(b) for b in bands) if lv == s
                   else bands for lv, bands in enumerate(details)]
    elif mode == "soft_thresholding":
        allc = torch.cat([b.abs().reshape(-1)
                          for bands in details for b in bands])
        thr = _percentile(allc, threshold_pct)
        details = [tuple(torch.sign(b) * (b.abs() - thr).clamp(min=0.0)
                         for b in bands) for bands in details]
    elif mode == "bayesian":
        out_details = []
        for lv, bands in enumerate(details):
            nb = []
            for b in bands:
                var_b = var(b).clamp(min=1e-30)
                noise_var = sigma_n ** 2 if white_noise else \
                    torch.minimum(sigma_n ** 2, var_b)
                sig_var = (torch.clamp(var_b - noise_var, snr0 * noise_var,
                                       snrf * noise_var)
                           if lv <= max(scale, 0) else
                           (var_b - noise_var).clamp(min=0.0))
                nb.append(b * sig_var / (sig_var + noise_var))
            out_details.append(tuple(nb))
        details = out_details
    elif mode == "adaptive_soft":
        out_details = []
        for bands in details:
            nb = []
            for b in bands:
                sig = torch.sqrt((var(b) - sigma_n ** 2).clamp(min=1e-30))
                thr = sigma_n ** 2 / sig
                nb.append(torch.sign(b) * (b.abs() - thr).clamp(min=0.0))
            out_details.append(tuple(nb))
        details = out_details
    elif mode == "central":
        Reff = R if R > 0 else n // 2
        details = [tuple(b * _band_radius_mask(b.shape, lv, Reff, b.device)
                         for b in bands)
                   for lv, bands in enumerate(details)]
    else:
        raise ValueError(f"unknown wavelet mode {mode!r}")

    if output_scale > 0:
        details = details[output_scale:]
    out = daub_idwt2(ll, details, kind)
    return out[0] if single else out
