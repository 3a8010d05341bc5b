"""Fourier shift phases (the subset of the reference package's
ops/fourier.py that Fourier reconstruction needs), in torch complex64."""
from __future__ import annotations

import math

import torch


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
