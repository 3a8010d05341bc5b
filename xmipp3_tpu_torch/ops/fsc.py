"""Fourier Shell Correlation (the subset of the reference package's
ops/fsc.py that checks a reconstruction against a known volume).

Replaces reference resolution_fsc (resolution_fsc.h:33); shells in the
rfft layout with segment sums (no per-shell loops)."""
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
    cross = (F1 * torch.conj(F2)).real.reshape(-1)
    p1 = (F1.abs() ** 2).reshape(-1)
    p2 = (F2.abs() ** 2).reshape(-1)
    zeros = torch.zeros(nbins, dtype=torch.float32, device=device)
    num = zeros.index_add(0, bins, cross)
    d1 = zeros.index_add(0, bins, p1)
    d2 = zeros.index_add(0, bins, p2)
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
