"""Fourier Shell Correlation and related resolution measures (the
reference package's ops/fsc.py).

Replaces reference resolution_fsc (resolution_fsc.h:33) and the FRC used by
tests; shells in the rfft layout with segment sums (index_add_ into at most
X/2+1 bins, no per-shell loops). Inputs go to `device` (the card by
default); the curves come back as tensors (fsc_3d, frc_2d) or numpy
arrays (frc_dpr_curves)."""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from xmipp3_tpu_torch.device import resolve_device


@lru_cache(maxsize=8)
def _shell_index_3d(D, H, W, nbins):
    fz = np.fft.fftfreq(D)[:, None, None]
    fy = np.fft.fftfreq(H)[None, :, None]
    fx = np.fft.rfftfreq(W)[None, None, :]
    r = np.sqrt(fz * fz + fy * fy + fx * fx)
    return np.minimum((r / 0.5 * nbins).astype(np.int64), nbins - 1).ravel()


def fsc_3d(vol1, vol2, nbins: int | None = None, device=None):
    """FSC curve between two volumes (arrays or tensors). Returns
    (freqs, fsc) as float32 tensors of length nbins on `device`.

    freqs are digital (cycles/px); convert with f/sampling for 1/Å."""
    device = resolve_device(device)
    vol1 = torch.as_tensor(vol1, dtype=torch.float32, device=device)
    vol2 = torch.as_tensor(vol2, dtype=torch.float32, device=device)
    D, H, W = vol1.shape
    if nbins is None:
        nbins = D // 2
    F1 = torch.fft.rfftn(vol1)
    F2 = torch.fft.rfftn(vol2)
    bins = torch.as_tensor(_shell_index_3d(D, H, W, nbins), device=device)
    num, d1, d2 = _shell_sums(bins, nbins,
                              (F1 * torch.conj(F2)).real.reshape(-1),
                              (F1.abs() ** 2).reshape(-1),
                              (F2.abs() ** 2).reshape(-1))
    fsc = num / torch.clamp(torch.sqrt(d1 * d2), min=1e-12)
    freqs = (torch.arange(nbins, dtype=torch.float32, device=device) + 0.5
             ) * (0.5 / nbins)
    return freqs, fsc


def fsc_resolution(freqs, fsc, threshold: float = 0.143,
                   sampling: float = 1.0) -> float:
    """Resolution (Å) at the FSC threshold crossing."""
    freqs = np.asarray(torch.as_tensor(freqs).cpu())
    fsc = np.asarray(torch.as_tensor(fsc).cpu())
    below = np.where(fsc < threshold)[0]
    if len(below) == 0:
        return 2.0 * sampling  # Nyquist
    i = below[0]
    if i == 0:
        return float("inf")
    # linear interpolation of the crossing
    f = freqs[i - 1] + (freqs[i] - freqs[i - 1]) * (
        (fsc[i - 1] - threshold) / max(fsc[i - 1] - fsc[i], 1e-12))
    return float(sampling / f)


def _shell_sums(bins, nbins: int, *values):
    """Per-shell sums of each (n,) float32 tensor: index_add_ into nbins."""
    zeros = torch.zeros(nbins, dtype=torch.float32, device=bins.device)
    return [zeros.index_add(0, bins, v) for v in values]


def frc_2d(img1, img2, nbins: int | None = None, device=None):
    """Fourier Ring Correlation between two images. Returns (freqs, frc)
    as float32 tensors of length nbins on `device`."""
    device = resolve_device(device)
    img1 = torch.as_tensor(img1, dtype=torch.float32, device=device)
    img2 = torch.as_tensor(img2, dtype=torch.float32, device=device)
    H, W = img1.shape[-2:]
    if nbins is None:
        nbins = H // 2
    fy = np.fft.fftfreq(H)[:, None]
    fx = np.fft.rfftfreq(W)[None, :]
    r = np.sqrt(fy * fy + fx * fx)
    bins = torch.as_tensor(np.minimum((r / 0.5 * nbins).astype(np.int64),
                                      nbins - 1).ravel(), device=device)
    F1 = torch.fft.rfft2(img1).reshape(-1)
    F2 = torch.fft.rfft2(img2).reshape(-1)
    num, d1, d2 = _shell_sums(bins, nbins, (F1 * torch.conj(F2)).real,
                              F1.abs() ** 2, F2.abs() ** 2)
    freqs = (torch.arange(nbins, dtype=torch.float32, device=device) + 0.5
             ) * (0.5 / nbins)
    return freqs, num / torch.clamp(torch.sqrt(d1 * d2), min=1e-12)


def _int_shell_bins(shape):
    """Integer-frequency shells idx = round(f*X) over the rfft layout —
    the reference frc_dpr binning (resolution_fsc.cpp:188 caller)."""
    if len(shape) == 3:
        D, H, W = shape
        fz = np.fft.fftfreq(D)[:, None, None]
        fy = np.fft.fftfreq(H)[None, :, None]
        fx = np.fft.rfftfreq(W)[None, None, :]
        r = np.sqrt(fz * fz + fy * fy + fx * fx)
    else:
        H, W = shape
        fy = np.fft.fftfreq(H)[:, None]
        fx = np.fft.rfftfreq(W)[None, :]
        r = np.sqrt(fy * fy + fx * fx)
    X = W
    nshell = X // 2 + 1
    idx = np.minimum(np.round(r * X).astype(np.int64), nshell - 1)
    return idx.ravel(), nshell, X


def _frc_dpr_device(F1, F2, bins, nshell: int, do_dpr: bool):
    """FRC, random-noise FRC, DPR and L2 error per integer shell from the
    flattened spectra F1, F2 and their shell indices."""
    cnt, num, d1, d2, err = _shell_sums(
        bins, nshell, torch.ones(F1.shape, device=F1.device),
        (F1 * torch.conj(F2)).real, F1.abs() ** 2, F2.abs() ** 2,
        (F1 - F2).abs() ** 2)
    frc = num / torch.clamp(torch.sqrt(d1 * d2), min=1e-30)
    frc_noise = 2.0 / torch.sqrt(torch.clamp(cnt, min=1.0))
    error_l2 = torch.sqrt(err / torch.clamp(cnt, min=1.0))
    if do_dpr:
        w = F1.abs() + F2.abs()
        delta = torch.rad2deg(torch.angle(F1 * torch.conj(F2)))
        tw, dw = _shell_sums(bins, nshell, w * delta * delta, w)
        dpr = torch.sqrt(tw / torch.clamp(dw, min=1e-30))
    else:
        dpr = torch.zeros(nshell, device=F1.device)
    return frc, frc_noise, dpr, error_l2


def frc_dpr_curves(a1, a2, sampling: float = 1.0, do_dpr: bool = False,
                   device=None):
    """Reference frc_dpr: integer shells, FRC + random-noise FRC (2/sqrt(n))
    + amplitude-weighted DPR (degrees) + per-shell L2 error.

    Returns dict of numpy arrays keyed freq (1/Å), freq_dig, frc, frc_noise,
    dpr, error_l2 over shells i=0..X/2 (resolution_fsc.cpp:115-163 output
    contract)."""
    device = resolve_device(device)
    a1 = torch.as_tensor(np.asarray(a1, np.float32), device=device)
    a2 = torch.as_tensor(np.asarray(a2, np.float32), device=device)
    bins, nshell, X = _int_shell_bins(tuple(a1.shape))
    F1 = torch.fft.rfftn(a1).reshape(-1)
    F2 = torch.fft.rfftn(a2).reshape(-1)
    curves = _frc_dpr_device(F1, F2, torch.as_tensor(bins, device=device),
                             nshell, do_dpr)
    i = np.arange(nshell)
    out = {"freq_dig": i / X, "freq": i / (X * sampling)}
    for k, v in zip(("frc", "frc_noise", "dpr", "error_l2"), curves):
        out[k] = v.cpu().numpy()
    return out


def frc_rfactor(vol1, vol2, min_freq: float = -2.0, max_freq: float = 1.0,
                device=None) -> float:
    """R-factor between two volumes: sum(||F1|-|F2||)/sum(|F1|) over the
    half (rfft) spectrum with digital |w| in (min_freq, max_freq) — the
    reference frc_dpr's do_rfactor output (resolution_fsc.cpp:188; 0.134661
    on the embedded 3x3x3 fixture of function_tests/test_resolution_frc.cpp)."""
    device = resolve_device(device)
    v1 = torch.as_tensor(vol1, dtype=torch.float32, device=device)
    v2 = torch.as_tensor(vol2, dtype=torch.float32, device=device)
    D, H, W = v1.shape
    F1 = torch.fft.rfftn(v1).abs()
    F2 = torch.fft.rfftn(v2).abs()
    fz = np.fft.fftfreq(D)[:, None, None]
    fy = np.fft.fftfreq(H)[None, :, None]
    fx = np.fft.rfftfreq(W)[None, None, :]
    R = torch.as_tensor(np.sqrt(fz * fz + fy * fy + fx * fx),
                        dtype=torch.float32, device=device)
    m = (R > min_freq) & (R < max_freq)
    num = torch.where(m, (F1 - F2).abs(), 0.0).sum()
    den = torch.where(m, F1, 0.0).sum()
    return float(num / den)
