"""Batched rotation+shift via FFT shears (no gathers).

Counterpart of the reference package's ops/shear_rotate.py. A rotation is
the three-shear decomposition R(θ) = Shx(-tan θ/2) · Shy(sin θ) ·
Shx(-tan θ/2), each shear a per-row/column translation applied as a Fourier
phase ramp: batched 1-D FFTs + elementwise complex multiplies, with sinc
(spectral) interpolation accuracy.

Angles are reduced to (-45°, 45°] by composing an exact k·90° rotation
(transpose+flip, selected per image), so shear factors stay small.
Convention matches ops.geo.apply_affine_2d with wrap=True:
out = T(sx, sy)·R(psi) applied to the image (alignment_matrices_2d form).

The reference package writes the 1-D transforms as table products for
images up to 256 px and folds the final translation into two more shears;
the port keeps that sequence of four shears for every size (so that the
two agree at the sizes they share) and computes each with torch.fft in
full float32.
"""
from __future__ import annotations

import math

import torch

from xmipp3_tpu_torch.device import as_tensor


def _shear(imgs, shifts, dim: int):
    """Translate every line along `dim` (1 = columns, 2 = rows) of a
    (B,H,W) batch by its own amount (periodic). shifts broadcasts against
    the other two axes: (B,H) for dim 2, (B,W) for dim 1. The imaginary part
    of the even-size Nyquist bin is dropped by the inverse transform."""
    n = imgs.shape[dim]
    f = torch.fft.rfftfreq(n, device=imgs.device)
    if dim == 2:
        ang = f[None, None, :] * shifts[:, :, None]
    else:
        ang = f[None, :, None] * shifts[:, None, :]
    ang = (-2 * math.pi) * ang
    phase = torch.complex(torch.cos(ang), torch.sin(ang))
    return torch.fft.irfft(torch.fft.rfft(imgs, dim=dim) * phase, n=n,
                           dim=dim)


def translate_fourier(imgs, sx, sy, device=None):
    """Subpixel periodic translation (B,H,W) by per-image (sx, sy) — the
    separable two-shear form; composes exactly with rotate_shift_fourier
    (periodic sinc shifts compose exactly)."""
    imgs = as_tensor(imgs, device)
    B, H, W = imgs.shape
    sx = as_tensor(sx, imgs.device)
    sy = as_tensor(sy, imgs.device)
    out = _shear(imgs, sx[:, None].expand(B, H), 2)
    return _shear(out, sy[:, None].expand(B, W), 1)


def rotate_shift_fourier(imgs, psi_deg, sx, sy, device=None):
    """Rotate by psi (ops.geo convention) then shift by (sx, sy) — all in
    Fourier space. imgs (B,H,W) float32; returns (B,H,W)."""
    imgs = as_tensor(imgs, device)
    dev = imgs.device
    B, H, W = imgs.shape
    psi = torch.deg2rad(torch.remainder(as_tensor(psi_deg, dev) + 180.0,
                                        360.0) - 180.0)

    # quadrant reduction: psi = residual + k*90°, residual in (-45°, 45°]
    quarter = torch.round(psi / (math.pi / 2))
    k = torch.remainder(quarter.to(torch.int32), 4)
    resid = psi - quarter * (math.pi / 2)

    # exact k·90° rotations. Content convention (calibrated against
    # apply_affine_2d): psi=+90 maps logical (x, y) -> (y, -x). Inversion
    # about the center n//2 is index n-i for even n (plain flip gives n-1-i,
    # hence the +1 roll) but exactly n-1-i for odd n (no roll).
    ry = 1 if H % 2 == 0 else 0
    rx = 1 if W % 2 == 0 else 0
    swapped = imgs.transpose(1, 2)
    r1 = torch.roll(swapped.flip(1), ry, 1)
    r2 = torch.roll(imgs.flip((1, 2)), (ry, rx), (1, 2))
    r3 = torch.roll(swapped.flip(2), rx, 2)
    sel = k[:, None, None]
    base = torch.where(sel == 0, imgs,
                       torch.where(sel == 1, r1,
                                   torch.where(sel == 2, r2, r3)))

    # three shears for the residual: content v' = Shx(t)·Shy(-sin)·Shx(t) v
    # with t = tan(resid/2) reproduces v' = [[c, s], [-s, c]] v (the
    # alignment_matrices_2d content rotation), verified by parity tests.
    t = torch.tan(resid / 2)
    m = -torch.sin(resid)
    y = (torch.arange(H, dtype=torch.float32, device=dev) - H // 2)[None, :]
    x = (torch.arange(W, dtype=torch.float32, device=dev) - W // 2)[None, :]
    sx = as_tensor(sx, dev)
    sy = as_tensor(sy, dev)

    # the x-translation folds into the third shear (per-row x-shifts add)
    # and the y-translation is a fourth, uniform shear
    out = _shear(base, t[:, None] * y, 2)
    out = _shear(out, m[:, None] * x, 1)
    out = _shear(out, t[:, None] * y + sx[:, None], 2)
    return _shear(out, sy[:, None].expand(B, W), 1)
