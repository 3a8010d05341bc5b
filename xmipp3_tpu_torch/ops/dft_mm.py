"""Small-size DFTs under the reference package's names.

The reference package (ops/dft_mm.py) writes these transforms as dense
cos/sin table contractions because batched small FFTs are bound by dispatch
latency on its device. That is no concern of the card's FFT library, so the
port keeps the function names, layouts and dtypes and computes each one
with torch.fft. The results agree with the table forms to float32 roundoff:
like them, the inverse transforms ignore the imaginary part of the DC bin
and, for even n, of the Nyquist bin.
"""
from __future__ import annotations

import torch

from xmipp3_tpu_torch.device import as_tensor


def rfft_mm_last(x, device=None):
    """rfft along the last axis of real x (…, n) -> complex64 (…, n//2+1)."""
    return torch.fft.rfft(as_tensor(x, device), dim=-1)


def irfft_mm_last(X, n: int, device=None):
    """irfft along the last axis of Hermitian X (…, n//2+1) -> (…, n)."""
    return torch.fft.irfft(as_tensor(X, device, torch.complex64), n=n, dim=-1)


def rfft2_mm(imgs, device=None):
    """rfft2 of (B, H, W) real input."""
    return torch.fft.rfft2(as_tensor(imgs, device))


def irfft2_mm(X, shape, device=None):
    """irfft2 of (B, H, W//2+1) Hermitian input to `shape` = (H, W)."""
    return torch.fft.irfft2(as_tensor(X, device, torch.complex64),
                            s=tuple(shape))


def fft2_abs_shifted_mm(imgs, device=None):
    """fftshift(|fft2(imgs)|) for (B, H, W) real input."""
    spec = torch.fft.fft2(as_tensor(imgs, device))
    return torch.fft.fftshift(spec, dim=(-2, -1)).abs()
