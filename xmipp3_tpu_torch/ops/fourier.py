"""Frequency grids, batched 2-D transforms, Fourier shifts and radial
averages (the subset of the reference package's ops/fourier.py that
reconstruction, gallery projection, projection matching, the Fourier
filters and PSD/CTF estimation need), in torch float32/complex64."""
from __future__ import annotations

import math

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor


def freq_grid_2d(h: int, w: int):
    """(fy, fx) normalized frequencies for the rfft2 layout: fy (h,1),
    fx (1,w//2+1), numpy float32."""
    fy = np.fft.fftfreq(h).astype(np.float32)[:, None]
    fx = np.fft.rfftfreq(w).astype(np.float32)[None, :]
    return fy, fx


def radial_freq_2d(h: int, w: int):
    fy, fx = freq_grid_2d(h, w)
    return np.sqrt(fy * fy + fx * fx).astype(np.float32)


def freq_grid_3d(d: int, h: int, w: int):
    """(fz, fy, fx) normalized frequencies for the rfftn layout, numpy
    float32, broadcastable to (d, h, w//2+1)."""
    fz = np.fft.fftfreq(d).astype(np.float32)[:, None, None]
    fy = np.fft.fftfreq(h).astype(np.float32)[None, :, None]
    fx = np.fft.rfftfreq(w).astype(np.float32)[None, None, :]
    return fz, fy, fx


def rfft2(imgs, device=None):
    return torch.fft.rfft2(as_tensor(imgs, device))


def irfft2(spec, shape=None, device=None):
    return torch.fft.irfft2(as_tensor(spec, device, torch.complex64),
                            s=shape)


def phase_ramp_1d(freqs, shifts):
    """exp(-2πi f s) for a 1-D frequency vector and a batch of shifts.

    Fourier shift phases are separable — exp(-2πi(fx·sx + fy·sy)) is the
    outer product of two 1-D phase vectors, so two 1-D exps and a broadcast
    cost H+K transcendentals per image instead of H·K.
    shifts (...,) -> (..., len(freqs)) complex64."""
    ang = (-2 * math.pi) * shifts.to(torch.float32)[..., None] * freqs
    return torch.complex(torch.cos(ang), torch.sin(ang))


def shift_spec_2d(spec, sx, sy, H: int, W: int):
    """Multiply an rfft2 half-spectrum (..., H, W//2+1) by the separable
    shift phase for per-image shifts sx/sy (...,)."""
    dev = spec.device
    px = phase_ramp_1d(torch.fft.rfftfreq(W, device=dev), sx)
    py = phase_ramp_1d(torch.fft.fftfreq(H, device=dev), sy)
    return spec * py[..., :, None] * px[..., None, :]


def fourier_shift_2d(imgs, sx, sy, device=None):
    """Subpixel periodic shift by (sx, sy) pixels via Fourier phase ramp.
    Positive sx moves content toward +x (the convention of
    apply_alignment_2d shifts). imgs (B,H,W) or (H,W)."""
    imgs = as_tensor(imgs, device)
    single = imgs.ndim == 2
    if single:
        imgs = imgs[None]
    B, H, W = imgs.shape
    sx = as_tensor(sx, imgs.device).reshape(-1)
    sy = as_tensor(sy, imgs.device).reshape(-1)
    spec = shift_spec_2d(torch.fft.rfft2(imgs), sx, sy, H, W)
    out = torch.fft.irfft2(spec, s=(H, W))
    return out[0] if single else out


def radial_average_half(power, nbins: int):
    """Radially average an rfft-layout 2-D array into nbins rings of width
    0.5/nbins cycles/px, on the tensor's device: power (..., H, W//2+1) ->
    (..., nbins). The ring sums are one index_add_ over the flat plane."""
    power = as_tensor(power)
    H = power.shape[-2]
    W = 2 * (power.shape[-1] - 1)
    r = radial_freq_2d(H, W)
    bins = np.clip((r / 0.5 * nbins).astype(np.int32), 0, nbins - 1).ravel()
    idx = torch.as_tensor(bins, dtype=torch.int64, device=power.device)
    flat = power.reshape(-1, bins.size)
    sums = torch.zeros(flat.shape[0], nbins, dtype=torch.float32,
                       device=power.device).index_add_(1, idx, flat)
    counts = torch.as_tensor(np.bincount(bins, minlength=nbins),
                             dtype=torch.float32, device=power.device)
    out = sums / torch.clamp(counts, min=1.0)
    return out.reshape(power.shape[:-2] + (nbins,))


# ---------------------------------------------------------------------------
# FFT sizes, index conversion, whole planes
# ---------------------------------------------------------------------------

def _is_smooth(n: int, primes=(2, 3, 5)) -> bool:
    for p in primes:
        while n % p == 0:
            n //= p
    return n == 1


def next_good_fft_size(n: int) -> int:
    """Smallest 5-smooth integer >= n (a static stand-in for cuFFTAdvisor)."""
    while not _is_smooth(n):
        n += 1
    return n


def good_fft_sizes(n: int, count: int = 8) -> list[int]:
    out, m = [], n
    while len(out) < count:
        m = next_good_fft_size(m)
        out.append(m)
        m += 1
    return out


def fft_idx2digfreq(idx: int, dim: int) -> float:
    """The reference FFT_IDX2DIGFREQ: w = idx/dim for idx <= dim/2 else
    (idx-dim)/dim. The even-size Nyquist bin maps to +0.5 (numpy's fftfreq
    gives -0.5 there)."""
    return (idx if idx <= dim // 2 else idx - dim) / float(dim)


def center_fft_2d(spec_full):
    """fftshift of both last axes (xmipp CenterFFT, for display/PSD)."""
    return torch.fft.fftshift(torch.as_tensor(spec_full), dim=(-2, -1))


def hermitian_full_from_half(spec_half, w: int):
    """The full complex plane from its rfft half (for algorithms that need
    the whole plane, such as PSD display; reference half2whole,
    psd_estimator.h:53)."""
    spec_half = torch.as_tensor(spec_half)
    H = spec_half.shape[-2]
    cols = w - spec_half.shape[-1]
    idx = torch.as_tensor(np.arange(1, cols + 1)[::-1].copy(),
                          device=spec_half.device)
    row_idx = torch.as_tensor((-np.arange(H)) % H, device=spec_half.device)
    conj_part = torch.conj(spec_half[..., :, idx])[..., row_idx, :]
    return torch.cat([spec_half, conj_part], dim=-1)
