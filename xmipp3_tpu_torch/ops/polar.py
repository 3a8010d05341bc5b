"""Polar resampling + rotational correlation over ring FFTs.

Counterpart of the reference package's ops/polar.py: batched gathers onto
static polar grids and a 1-D FFT correlation along the angular axis.

Layout: polar stacks are (B, n_rings, n_angles) float32; ring radii are
radius_min + i (1 px spacing); angular samples θ_j = 2π j / n_angles,
x = c + r cosθ, y = c + r sinθ. Ring weighting for correlation: w_i ∝ r_i
(annulus area). The sampling grids are static per shape: they are built on
the host once and cached per device.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor
from xmipp3_tpu_torch.ops.dft_mm import irfft_mm_last, rfft_mm_last
from xmipp3_tpu_torch.ops.shift import _parabola_peak_1d


def polar_grid(h: int, w: int, radius_min: int, radius_max: int,
               n_angles: int | None = None):
    """Sampling coordinates (yy, xx) of shape (n_rings, n_angles)."""
    if n_angles is None:
        # enough angular samples for the outermost ring (power of 2 friendly)
        n_angles = int(2 ** np.ceil(np.log2(2 * np.pi * radius_max)))
    radii = np.arange(radius_min, radius_max + 1, dtype=np.float32)
    theta = (2 * np.pi * np.arange(n_angles) / n_angles).astype(np.float32)
    cy, cx = h // 2, w // 2
    yy = cy + radii[:, None] * np.sin(theta)[None, :]
    xx = cx + radii[:, None] * np.cos(theta)[None, :]
    return yy.astype(np.float32), xx.astype(np.float32), radii


def _bilinear_taps(yy, xx, H: int, W: int, wrap: bool, device):
    """Flat indices and weights of the 4 bilinear taps of static sampling
    coordinates: a list of (index int64, weight float32) tensor pairs.
    wrap=True indexes periodically, else indices are clipped to the frame."""
    y0 = np.floor(yy).astype(np.int64)
    x0 = np.floor(xx).astype(np.int64)
    fy = (yy - y0).astype(np.float32)
    fx = (xx - x0).astype(np.float32)
    taps = []
    for dy, dx, wgt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                        (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        if wrap:
            yi, xi = (y0 + dy) % H, (x0 + dx) % W
        else:
            yi, xi = np.clip(y0 + dy, 0, H - 1), np.clip(x0 + dx, 0, W - 1)
        taps.append((torch.as_tensor(yi * W + xi, device=device),
                     torch.as_tensor(wgt, device=device)))
    return taps


def _sample(imgs, taps):
    """Σ_t imgs.flat[idx_t] * w_t: imgs (B,H,W), taps of shape S -> (B,*S)."""
    flat = imgs.reshape(imgs.shape[0], -1)
    shape = taps[0][0].shape
    out = None
    for idx, wgt in taps:
        term = flat[:, idx.reshape(-1)].reshape(-1, *shape) * wgt
        out = term if out is None else out + term
    return out


@lru_cache(maxsize=32)
def _polar_taps(H, W, radius_min, radius_max, n_angles, stride, nearest,
                device):
    yy, xx, _ = polar_grid(H, W, radius_min, radius_max, n_angles)
    yy, xx = yy[::stride], xx[::stride]
    if nearest:
        yi = np.clip(np.round(yy).astype(np.int64), 0, H - 1)
        xi = np.clip(np.round(xx).astype(np.int64), 0, W - 1)
        return [(torch.as_tensor(yi * W + xi, device=device),
                 torch.ones(yy.shape, device=device))]
    return _bilinear_taps(yy, xx, H, W, False, device)


def cartesian_to_polar(imgs, radius_min: int = 2,
                       radius_max: int | None = None,
                       n_angles: int | None = None, stride: int = 1,
                       nearest: bool = False, device=None):
    """Batched polar resampling. imgs (B,H,W) -> (B,R,A).

    stride>1 samples every stride-th ring and nearest=True uses 1-tap
    sampling — the cheap mode for coarse scans; defaults give full-quality
    bilinear rings. Samples past the frame take the clipped edge value."""
    imgs = as_tensor(imgs, device)
    single = imgs.ndim == 2
    if single:
        imgs = imgs[None]
    B, H, W = imgs.shape
    if radius_max is None:
        radius_max = H // 2 - 2
    out = _sample(imgs, _polar_taps(H, W, radius_min, radius_max, n_angles,
                                    stride, nearest, imgs.device))
    return out[0] if single else out


@lru_cache(maxsize=32)
def _offset_taps(H, W, offsets, radius_min, radius_max, n_angles, stride,
                 device):
    yy0, xx0, _ = polar_grid(H, W, radius_min, radius_max, n_angles)
    yy0, xx0 = yy0[::stride], xx0[::stride]
    yy = np.stack([yy0 - ty for (tx, ty) in offsets])     # (T, R, A)
    xx = np.stack([xx0 - tx for (tx, ty) in offsets])
    return _bilinear_taps(yy, xx, H, W, True, device)


def polar_at_static_offsets(imgs, offsets, radius_min: int = 2,
                            radius_max: int | None = None,
                            n_angles: int | None = None, stride: int = 1,
                            device=None):
    """Bilinear polar resample around a static tuple of trial shifts.

    Sampling T(t)·img on the polar grid equals sampling img at grid - t, so
    the trial shifts are baked into the sampling grids and no image is
    shifted. Indexing is periodic: shifted grids can step past the frame for
    the outer rings, and wrapping matches the Fourier-shift semantics of the
    reference path (clipping changes outer-ring correlations).
    imgs (B, H, W), offsets ((tx, ty), ...) -> (B, T, R, A)."""
    imgs = as_tensor(imgs, device)
    B, H, W = imgs.shape
    if radius_max is None:
        radius_max = H // 2 - 2
    offsets = tuple((float(tx), float(ty)) for tx, ty in offsets)
    return _sample(imgs, _offset_taps(H, W, offsets, radius_min, radius_max,
                                      n_angles, stride, imgs.device))


def ring_ffts(polar, device=None):
    """FFT along the angular axis (reference fourierTransformRings)."""
    return rfft_mm_last(polar, device)


def rotational_correlation(f_ref, f_others, radius_min: int = 2):
    """Angular cross-correlation c(θ) summed over rings with r-weights.

    f_ref: (R, A//2+1) or (B, R, A//2+1); f_others: (B, R, A//2+1).
    Returns (B, A) correlation curves."""
    if f_ref.ndim == 2:
        f_ref = f_ref[None]
    R = f_others.shape[-2]
    A = 2 * (f_others.shape[-1] - 1)
    radii = torch.arange(radius_min, radius_min + R, dtype=torch.float32,
                         device=f_others.device)
    w = radii / radii.sum()
    cross = f_others * f_ref.conj()              # (B, R, A//2+1)
    weighted = (cross * w[None, :, None]).sum(dim=-2)
    return irfft_mm_last(weighted, A)


def best_rotation_from_ffts(f_ref, f_others, radius_min: int = 2):
    """Best in-plane rotation angle (degrees) and correlation peak.

    Angle returned is the rotation to apply to `other` so it matches `ref`
    (same sense as the psi of ops.geo.alignment_matrices_2d)."""
    corr = rotational_correlation(f_ref, f_others, radius_min)
    B, A = corr.shape
    idx = corr.argmax(dim=-1)
    ym1 = corr.gather(1, ((idx - 1) % A)[:, None])[:, 0]
    y0 = corr.gather(1, idx[:, None])[:, 0]
    yp1 = corr.gather(1, ((idx + 1) % A)[:, None])[:, 0]
    off = _parabola_peak_1d(ym1, y0, yp1)
    ang = (idx.to(torch.float32) + off) * (360.0 / A)
    # wrap to (-180, 180]
    ang = torch.where(ang > 180.0, ang - 360.0, ang)
    return ang, y0


def best_rotation(ref, others, radius_min: int = 2,
                  radius_max: int | None = None, n_angles: int | None = None,
                  device=None):
    """End-to-end 1-vs-N rotation estimation on Cartesian images."""
    others = as_tensor(others, device)
    ref = as_tensor(ref, others.device)
    if others.ndim == 2:
        others = others[None]
    H = others.shape[-2]
    if radius_max is None:
        radius_max = H // 2 - 2
    p_ref = cartesian_to_polar(ref, radius_min, radius_max, n_angles)
    p_oth = cartesian_to_polar(others, radius_min, radius_max, n_angles)
    return best_rotation_from_ffts(ring_ffts(p_ref), ring_ffts(p_oth),
                                   radius_min)


def polar_at_offsets(imgs, offsets, radius_min: int = 2,
                     radius_max: int | None = None,
                     n_angles: int | None = None, stride: int = 1,
                     device=None):
    """Polar resample around shifted centres without shifting the images:
    sampling T(t)·img on the polar grid equals sampling img at grid - t.
    imgs (B,H,W), offsets (T,2) as (tx,ty) -> (T,B,R,A), nearest
    neighbour (the coarse-scan path), on the images' device."""
    imgs = as_tensor(imgs, device)
    B, H, W = imgs.shape
    if radius_max is None:
        radius_max = H // 2 - 2
    yy, xx, _ = polar_grid(H, W, radius_min, radius_max, n_angles)
    if stride > 1:
        yy, xx = yy[::stride], xx[::stride]
    t = np.asarray(offsets, np.float32).reshape(-1, 2)
    # the reference's float32 round-half-even of the shifted grid
    yi = np.clip(np.round(yy[None] - t[:, 1, None, None]).astype(np.int64),
                 0, H - 1)
    xi = np.clip(np.round(xx[None] - t[:, 0, None, None]).astype(np.int64),
                 0, W - 1)
    idx = torch.as_tensor(yi * W + xi, device=imgs.device)   # (T, R, A)
    flat = imgs.reshape(B, -1)
    return flat[:, idx.reshape(-1)].reshape(B, *idx.shape).permute(
        1, 0, 2, 3)


def polar_rings_reference(coeffs, first_ring: int, last_ring: int,
                          xoff: float = 0.0, yoff: float = 0.0,
                          mode: str = "full", device=None):
    """Reference-exact polar ring sampling
    (Polar::getPolarFromCartesianBSpline, data/polar.h:625-702): rings at
    integer radii, 2·int(0.5·angle·r) samples per ring (min 1), sample
    (x, y) = r·(sin phi, cos phi) evaluated by cubic B-spline on `coeffs`
    (spline coefficients) with mirror-off-bounds extension and no
    centring: the reference evaluates in the array's own coordinate frame.
    Returns (rings, radii): a list of 1-D tensors and a list of radii."""
    from xmipp3_tpu_torch.ops.geo import _gather_bspline3
    coeffs = as_tensor(coeffs, device)
    twopi = 2.0 * np.pi if mode == "full" else np.pi
    rings, radii = [], []
    for r in range(first_ring, last_ring + 1):
        radius = float(r)
        nsam = max(1, 2 * int(0.5 * twopi * radius))
        phi = np.arange(nsam, dtype=np.float32) * np.float32(twopi / nsam)
        xs = torch.as_tensor(np.sin(phi) * radius + xoff, device=coeffs.device)
        ys = torch.as_tensor(np.cos(phi) * radius + yoff, device=coeffs.device)
        rings.append(_gather_bspline3(coeffs, ys, xs, wrap=False,
                                      zero_outside=False))
        radii.append(radius)
    return rings, radii


def polar_weighted_stats(rings, radii, mode: str = "full"):
    """Ring-area-weighted mean and stddev (Polar::computeAverageAndStddev,
    data/polar.h:488-534): weight a sample = angle·radius/nsam (float64,
    host)."""
    twopi = 2.0 * np.pi if mode == "full" else np.pi
    s = s2 = n = 0.0
    for ring, radius in zip(rings, radii):
        vals = np.asarray(ring.cpu() if isinstance(ring, torch.Tensor)
                          else ring, np.float64)
        w = twopi * radius / vals.size
        s += w * vals.sum()
        s2 += w * (vals ** 2).sum()
        n += w * vals.size
    if n > 0:
        mean = s / n
        return mean, float(np.sqrt(abs(s2 / n - mean * mean)))
    return 0.0, 0.0
