"""Batched 2-D shift estimation via FFT cross-correlation.

Counterpart of the reference package's ops/shift.py: rfft2 -> cross-power ->
correlation on the search window -> argmax -> 3-point parabolic subpixel
refinement, batched over the leading axis.

Convention: returned (sx, sy) is the shift to APPLY to `other` (content moves
by +sx,+sy, as in ops.fourier.fourier_shift_2d) so it registers onto `ref`.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor
from xmipp3_tpu_torch.ops.dft_mm import irfft2_mm, rfft2_mm


def _parabola_peak_1d(ym1, y0, yp1):
    """Vertex offset of the parabola through (-1,ym1),(0,y0),(1,yp1) in [-.5,.5]."""
    denom = ym1 - 2.0 * y0 + yp1
    off = torch.where(denom.abs() > 1e-12, 0.5 * (ym1 - yp1) / denom, 0.0)
    return off.clamp(-0.5, 0.5)


def _taps_2d(maps, py, px):
    """maps[b, py[b], px[b]] for (B,H,W) maps and (B,) integer positions."""
    W = maps.shape[-1]
    return maps.reshape(maps.shape[0], -1).gather(
        1, (py * W + px)[:, None])[:, 0]


def correlation_peaks_2d(corrs, max_shift: int | None = None):
    """Find subpixel peaks of centered correlation maps (B,H,W).

    Returns (sx, sy, peak_value): location of max relative to image center,
    restricted to |shift| <= max_shift (box window)."""
    B, H, W = corrs.shape
    dev = corrs.device
    cy, cx = H // 2, W // 2
    if max_shift is not None and max_shift > 0:
        yy = (torch.arange(H, device=dev) - cy).abs()[:, None]
        xx = (torch.arange(W, device=dev) - cx).abs()[None, :]
        window = (yy <= max_shift) & (xx <= max_shift)
        masked = torch.where(window[None], corrs, -torch.inf)
    else:
        masked = corrs
    flat_idx = masked.reshape(B, -1).argmax(dim=1)
    py = flat_idx // W
    px = flat_idx % W

    def tap(dy, dx):
        return _taps_2d(corrs, (py + dy).clamp(0, H - 1),
                        (px + dx).clamp(0, W - 1))

    offx = _parabola_peak_1d(tap(0, -1), tap(0, 0), tap(0, 1))
    offy = _parabola_peak_1d(tap(-1, 0), tap(0, 0), tap(1, 0))
    peak = tap(0, 0)
    sx = px.to(torch.float32) + offx - cx
    sy = py.to(torch.float32) + offy - cy
    return sx, sy, peak


def _windowed_dft_tables(n: int, k: int, offsets, rfft_axis: bool):
    """cos/sin evaluation tables (k, D) for a direct windowed inverse DFT.

    rfft_axis=True: k = n//2+1 rfft bins with [1,2,…,2,(1|2)] Hermitian
    duplication folded in. rfft_axis=False: k = n full signed-frequency
    bins (fftfreq order). offsets: displacement samples (pixels)."""
    offsets = np.asarray(offsets, np.float64)
    if rfft_axis:
        freqs = np.arange(k) / n
        dup = np.full(k, 2.0)
        dup[0] = 1.0
        if n % 2 == 0:
            dup[-1] = 1.0
    else:
        freqs = np.fft.fftfreq(n)
        dup = np.ones(k)
    ang = 2 * np.pi * freqs[:, None] * offsets[None, :]
    return ((np.cos(ang) * dup[:, None]).astype(np.float32),
            (np.sin(ang) * dup[:, None]).astype(np.float32))


@lru_cache(maxsize=16)
def _window_tables(H: int, W: int, ms: int, device: torch.device):
    """(Cx, Sx, Cy, Sy, inner) of the ±(ms+1) window, on `device`."""
    offs = np.arange(-(ms + 1), ms + 2, dtype=np.float64)   # parabola ring
    tabs = (*_windowed_dft_tables(W, W // 2 + 1, offs, True),
            *_windowed_dft_tables(H, H, offs, False),
            (np.abs(offs)[:, None] <= ms) & (np.abs(offs)[None, :] <= ms))
    return tuple(torch.as_tensor(t, device=device) for t in tabs)


def windowed_cross_peaks(cross, H: int, W: int, max_shift: int):
    """Subpixel correlation peaks from rfft2 cross-spectra, evaluated ONLY
    on the ±max_shift displacement window via separable DFT products.

    c(sy, sx) = (1/HW)·Σ_k X_k e^{2πi k·s} is contracted straight onto the
    window (one extra ring of samples for the 3-point parabola) instead of
    materializing the full (B, H, W) correlation and masking most of it.

    cross: (B, H, W//2+1) complex rfft2 cross-power. Returns (sx, sy, peak)
    with the same semantics and normalization as
    fftshift(irfft2(cross)) + correlation_peaks_2d."""
    B = cross.shape[0]
    ms = int(max_shift)
    D = 2 * ms + 3
    Cx, Sx, Cy, Sy, inner = _window_tables(H, W, ms, cross.device)
    xr, xi = cross.real, cross.imag
    # contract the rfft x-axis onto the window: T = Σ_kx X e^{2πi kx sx}
    tr = xr @ Cx - xi @ Sx                                   # (B, H, D)
    ti = xr @ Sx + xi @ Cx
    # contract the full y-axis; result is real (Hermitian input)
    corr = (torch.einsum("bhd,ha->bad", tr, Cy)
            - torch.einsum("bhd,ha->bad", ti, Sy)) / (H * W)
    # argmax restricted to |s| <= ms (the border ring is parabola margin)
    masked = torch.where(inner[None], corr, -torch.inf)
    flat = masked.reshape(B, -1).argmax(dim=1)
    py = flat // D
    px = flat % D

    def tap(dy, dx):
        return _taps_2d(corr, py + dy, px + dx)

    offx = _parabola_peak_1d(tap(0, -1), tap(0, 0), tap(0, 1))
    offy = _parabola_peak_1d(tap(-1, 0), tap(0, 0), tap(1, 0))
    sx = px.to(torch.float32) + offx - (ms + 1)
    sy = py.to(torch.float32) + offy - (ms + 1)
    return sx, sy, tap(0, 0)


def rfft2_any(x, device=None):
    """rfft2 of a batch (the reference package picks a table transform for
    small images here; the port has one transform for all sizes)."""
    return rfft2_mm(x, device)


def best_shift_from_spectra(F_ref, F_oth, max_shift: int | None = None,
                            normalize: bool = False, W: int | None = None):
    """Spectra-level core of best_shift: callers that keep a fixed reference
    across iterations (ops/match.refine_winners) precompute rfft2(ref) once
    instead of re-transforming it every call.

    F_ref, F_oth: (B, H, W//2+1) rfft2 spectra; pass W explicitly for
    odd-width images (defaults to even 2·(k−1))."""
    H = F_oth.shape[-2]
    if W is None:
        W = 2 * (F_oth.shape[-1] - 1)
    cross = F_oth * F_ref.conj()
    if normalize:  # phase correlation
        cross = cross / cross.abs().clamp(min=1e-12)
    if max_shift is not None and 0 < max_shift and \
            2 * max_shift + 3 <= min(H, W) // 2:
        sx, sy, peak = windowed_cross_peaks(cross, H, W, int(max_shift))
        return -sx, -sy, peak / (H * W)
    corr = torch.fft.fftshift(irfft2_mm(cross, (H, W)), dim=(-2, -1))
    sx, sy, peak = correlation_peaks_2d(corr, max_shift)
    # peak at center means zero shift; correlation of other vs ref shifted by s
    # peaks at s where other(x) ≈ ref(x - s); to register other onto ref we
    # apply the negative.
    return -sx, -sy, peak / (H * W)


def best_shift(ref, others, max_shift: int | None = None,
               normalize: bool = False, device=None):
    """1-vs-N shift estimation (reference bestShift / AShiftCorrEstimator).

    ref: (H,W) or (B,H,W) matching others; others: (B,H,W).
    Returns (sx, sy, corr_peak) tensors of shape (B,)."""
    others = as_tensor(others, device)
    ref = as_tensor(ref, others.device)
    if ref.ndim == 2:
        ref = ref[None]
    W = others.shape[-1]
    return best_shift_from_spectra(rfft2_any(ref), rfft2_any(others),
                                   max_shift=max_shift, normalize=normalize,
                                   W=W)


def best_shift_pairs(a, b, max_shift: int | None = None, device=None):
    """Pairwise shift estimation between stacks a and b (B,H,W) each."""
    return best_shift(a, b, max_shift=max_shift, device=device)


def align_translationally(ref, others, max_shift: int | None = None,
                          order: int = 1, device=None):
    """Estimate and apply shifts; returns (aligned, sx, sy, corr)."""
    from xmipp3_tpu_torch.ops.geo import shift_2d_real
    others = as_tensor(others, device)
    sx, sy, c = best_shift(ref, others, max_shift=max_shift)
    return shift_2d_real(others, sx, sy, order=order), sx, sy, c


def correlation_index(a, b, device=None):
    """Normalized cross-correlation of batches (the reference
    correlation_index / CorrelationComputer merit, amerit_computer.h)."""
    a = as_tensor(a, device)
    b = as_tensor(b, a.device)
    if a.ndim == 2:
        a = a[None]
    if b.ndim == 2:
        b = b[None]
    am = a - a.mean(dim=(-2, -1), keepdim=True)
    bm = b - b.mean(dim=(-2, -1), keepdim=True)
    num = (am * bm).sum(dim=(-2, -1))
    den = torch.sqrt((am * am).sum(dim=(-2, -1)) * (bm * bm).sum(dim=(-2, -1)))
    return num / den.clamp(min=1e-12)


def correlation_matrix(a, b, device=None):
    """Centered circular cross-correlation map (reference
    correlation_matrix, data/filters.h — FFT cross-power without
    normalization, CenterFFT'd so zero lag sits at (H//2, W//2))."""
    a = as_tensor(a, device)
    b = as_tensor(b, a.device)
    if a.ndim == 2:
        a = a[None]
    if b.ndim == 2:
        b = b[None]
    corr = torch.fft.ifft2(torch.fft.fft2(a) * torch.fft.fft2(b).conj())
    return torch.fft.fftshift(corr.real, dim=(-2, -1))
