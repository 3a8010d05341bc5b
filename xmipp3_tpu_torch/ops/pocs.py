"""Projectors Onto Convex Sets (POCS) for volume adjustment and
subtraction.

Counterpart of the reference package's ops/pocs.py (the reference's
POCS operator family and volume-adjustment loop,
reconstruction/volume_subtraction.cpp:100-460: POCSmask,
POCSnonnegative, POCSFourierAmplitude(+RadAvg), POCSMinMax,
POCSFourierPhase, radialAverage, computeRadQuotient, runIteration/run).
Each operator is a function on tensors; `volume_adjust` runs its
iterations as a loop on the volumes' device that reads nothing back to
the host. Standard deviations are population ones (correction=0), as
the reference's jnp.std.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor


def pocs_mask(vol, mask):
    """V *= mask."""
    return vol * mask


def pocs_nonnegative(vol):
    return torch.clamp_min(vol, 0.0)


def pocs_min_max(vol, vmin, vmax):
    return torch.minimum(torch.maximum(vol, vmin), vmax)


def pocs_fourier_amplitude(mag1, F2, lam=1.0):
    """Replace |F2| by (1-l)|F2| + l mag1, keeping the phase. Entries with
    |F2| <= 1e-10 are left untouched (the reference's divide-by-zero
    guard)."""
    mod = torch.abs(F2)
    scale = (1.0 - lam) + lam * mag1 / torch.clamp_min(mod, 1e-30)
    return torch.where(mod > 1e-10, F2 * scale, F2)


def pocs_fourier_phase(phase_unit, F):
    """Set F's phase to the given unit-modulus phase field."""
    return torch.abs(F) * phase_unit


def extract_phase(F):
    """Unit-modulus phase of a complex field (1 where F is 0)."""
    mod = torch.abs(F)
    nz = mod > 0
    return torch.where(nz, F / torch.where(nz, mod, 1.0),
                       torch.ones((), dtype=F.dtype, device=F.device))


def _half_freq_radius(shape):
    """Digital |w| over the rfftn half-spectrum of a volume `shape`."""
    D, H, W = shape
    fz = np.fft.fftfreq(D)[:, None, None]
    fy = np.fft.fftfreq(H)[None, :, None]
    fx = np.fft.rfftfreq(W)[None, None, :]
    return np.sqrt(fz * fz + fy * fy + fx * fx)


def radial_average_octant(mag_half, shape):
    """The reference radialAverage (volume_subtraction.cpp:198-238): the
    mean of half-spectrum magnitudes over rings iw = round(w Nx), in the
    positive-frequency octant k < D/2, i < H/2, j < W/2. The ring sums are
    one float32 index_add_ each; a ring with no voxel reads NaN (0/0), and
    a ring index past the table is dropped, as the reference's
    .at[].add drops it."""
    D, H, W = shape
    maxrad = int(np.floor(np.sqrt((W // 2) ** 2 + (H // 2) ** 2
                                  + (D // 2) ** 2)))
    kz = (np.arange(D // 2) / D)[:, None, None]
    ky = (np.arange(H // 2) / H)[None, :, None]
    kx = (np.arange(W // 2) / W)[None, None, :]
    w = np.sqrt(kz * kz + ky * ky + kx * kx)
    iw = np.round(w * W).astype(np.int64).ravel()
    keep = iw < maxrad
    dev = mag_half.device
    idx = torch.as_tensor(iw[keep], device=dev)
    sel = torch.as_tensor(np.flatnonzero(keep), device=dev)
    oct_mag = mag_half[:D // 2, :H // 2, :W // 2].reshape(-1)[sel]
    num = torch.zeros(maxrad, device=dev).index_add_(0, idx, oct_mag)
    den = torch.zeros(maxrad, device=dev).index_add_(
        0, idx, torch.ones_like(oct_mag))
    return num / den


def compute_rad_quotient(mag1_half, mag2_half, shape):
    """min(radialAverage(V1) / radialAverage(V2), 1), NaN -> 0."""
    r1 = radial_average_octant(mag1_half, shape)
    r2 = radial_average_octant(mag2_half, shape)
    q = r1 / r2
    return torch.where(torch.isnan(q), 0.0, torch.clamp_max(q, 1.0))


def pocs_fourier_amplitude_radavg(F_half, lam, rad_quotient, shape):
    """Multiply the half-spectrum by (1-l) + l rQ[min(floor(w Nx), len-1)]
    (volume_subtraction.cpp:127-152)."""
    w = _half_freq_radius(shape)
    iw = np.minimum(np.floor(w * shape[2]).astype(np.int64),
                    rad_quotient.shape[0] - 1)
    q = rad_quotient[torch.as_tensor(iw, device=F_half.device)]
    return F_half * ((1.0 - lam) + lam * q)


def _lowpass3d(shape, cut, device=None):
    w = _half_freq_radius(shape)
    raised = 0.02
    m = np.where(w <= cut, 1.0,
                 np.where(w <= cut + raised,
                          0.5 * (1 + np.cos(np.pi * (w - cut) / raised)),
                          0.0))
    return as_tensor(m.astype(np.float32), device)


def lowpass_volume(vol, cut):
    """vol low-passed at digital frequency `cut` (raised cosine 0.02)."""
    return torch.fft.irfftn(torch.fft.rfftn(vol)
                            * _lowpass3d(vol.shape, cut, vol.device),
                            s=vol.shape)


def volume_adjust(V1, V2, mask=None, iters: int = 5, lam: float = 1.0,
                  radavg: bool = True, cut_freq: float = 0.0, device=None):
    """The reference adjustment loop (ProgVolumeSubtraction::run and
    runIteration): project V2 onto the constraint sets of V1 - Fourier
    amplitudes (direct, or the radial-average quotient), the [v1min,
    v1max] range, the support mask, V2's own phases, nonnegativity, V1's
    std - for `iters` iterations on `device` (the card by default; a
    tensor V1 keeps its device). Returns the adjusted V2 as a tensor."""
    V1 = as_tensor(V1, device)
    dev = V1.device
    V2 = as_tensor(V2, dev)
    shape = tuple(V1.shape)
    m = torch.ones(shape, device=dev) if mask is None else \
        as_tensor(mask, dev)
    V1m = pocs_nonnegative(pocs_mask(V1, m))
    v1min, v1max = V1m.min(), V1m.max()
    std1 = V1m.std(correction=0)
    V = pocs_nonnegative(pocs_mask(V2, m))

    F2 = torch.fft.rfftn(V)
    phase2 = extract_phase(F2)
    mag1 = torch.abs(torch.fft.rfftn(V1m))
    rq = compute_rad_quotient(mag1, torch.abs(F2), shape)
    lp = _lowpass3d(shape, cut_freq, dev) if cut_freq else None

    for _ in range(iters):
        F = torch.fft.rfftn(V)
        if radavg:
            F = pocs_fourier_amplitude_radavg(F, lam, rq, shape)
        else:
            F = pocs_fourier_amplitude(mag1, F, lam)
        V = torch.fft.irfftn(F, s=shape)
        V = pocs_min_max(V, v1min, v1max)
        V = pocs_mask(V, m)
        F = torch.fft.rfftn(V)
        F = pocs_fourier_phase(phase2, F)
        V = torch.fft.irfftn(F, s=shape)
        V = pocs_nonnegative(V)
        V = V * (std1 / torch.clamp_min(V.std(correction=0), 1e-30))
        if lp is not None:
            V = torch.fft.irfftn(torch.fft.rfftn(V) * lp, s=shape)
    return V


def subtract_adjusted(V1, Vadj, mask_sub, cut_freq: float = 0.0):
    """The final subtraction (volume_subtraction.cpp subtraction()):
    outside the mask keep V1; inside take V1f - min(Vadj, V1f), with V1f
    the (optionally low-passed) reference. On Vadj's device."""
    Vadj = as_tensor(Vadj)
    V1 = as_tensor(V1, Vadj.device)
    V1f = lowpass_volume(V1, cut_freq) if cut_freq else V1
    m = as_tensor(mask_sub, Vadj.device)
    return V1 * (1 - m) + (V1f - torch.minimum(Vadj, V1f)) * m
