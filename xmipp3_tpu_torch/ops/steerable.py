"""Steerable second-derivative-of-Gaussian filters for 3D feature
enhancement (walls / filaments in tomograms).

Contract: reference data/steerable.{h,cpp} — six separable Hessian-of-
Gaussian basis responses (gxx, gyy, gzz, gxy, gxz, gyz built from 1D
kernels), steered analytically over a direction grid, keeping the per-voxel
maximum; "wall" uses (a,b,c)=(-1/4, 5/4, 5/2), filaments (1, -5/3, 10/3)
(steerable.cpp Steerable::Steerable).

On the card (or `device`): each separable pass is a batched FFT multiply
along one axis for all six basis volumes at once; the direction sweep is
a weighted sum of the six volumes and a running max a direction.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor


def _kernels_1d(n, sigma):
    """The reference's six (hx, hy, hz) 1D kernel triplets on a centered
    axis (steerable.cpp generate1DFilters), float32 numpy (6, n) each."""
    i = np.arange(n) - n // 2
    i2 = i.astype(np.float64) ** 2
    s2 = sigma * sigma
    k1 = 1.0 / (2.0 * np.pi * sigma) ** 1.5
    k2 = -1.0 / s2
    g = -np.exp(-i2 / (2 * s2))
    hx = np.stack([k1 * k2 * g * (1 - i2 / s2), k1 * k2 * g, k1 * k2 * g,
                   k1 * k2 * k2 * g * i, k1 * k2 * k2 * g * i,
                   k1 * k2 * k2 * g])
    hy = np.stack([g, g * (1 - i2 / s2), g, g * i, g, g * i])
    hz = np.stack([g, g, g * (1 - i2 / s2), g, g * i, g * i])
    return (hx.astype(np.float32), hy.astype(np.float32),
            hz.astype(np.float32))


def _filter_axis(vols, h, axis):
    """Circular-convolve each of the six volumes with its centered 1D kernel
    along `axis` (FFT multiply; the kernel is ifftshifted so its center sits
    at lag 0, matching the reference's MINUS_ONE_POWER phase trick)."""
    n = vols.shape[axis]
    h = torch.as_tensor(np.fft.ifftshift(h, axes=-1), device=vols.device)
    Hf = torch.fft.rfft(h, dim=-1)                          # (6, n//2+1)
    V = torch.fft.rfft(vols, dim=axis)
    shape = [1] * V.ndim
    shape[0] = 6
    shape[axis] = Hf.shape[-1]
    return torch.fft.irfft(V * Hf.reshape(shape), n=n, dim=axis)


def steerable_basis_3d(vol, sigma, device=None):
    """Six separable basis responses, shape (6, Z, Y, X), on the volume's
    device (`device`; the card by default for a host volume)."""
    vol = as_tensor(vol, device)
    Z, Y, X = vol.shape
    # kernel lengths must match each axis
    hx = _kernels_1d(X, float(sigma))[0]
    hy = _kernels_1d(Y, float(sigma))[1]
    hz = _kernels_1d(Z, float(sigma))[2]
    vols = vol[None].expand(6, Z, Y, X)
    out = _filter_axis(vols, hx, axis=3)
    out = _filter_axis(out, hy, axis=2)
    return _filter_axis(out, hz, axis=1)


def _direction_grid(delta_ang):
    """The reference's (tilt, rot) sweep with pole handling
    (steerable.cpp:66-76); returns (D, 3) unit vectors."""
    dirs = [(1.0, 0.0, 0.0)]
    n_tilt = int(round(180.0 / delta_ang))
    for it in range(1, n_tilt):
        tilt = delta_ang * it
        st = np.sin(np.deg2rad(tilt))
        d_rot = delta_ang / max(st, 1e-6)
        n_rot = max(int(round(360.0 / d_rot)), 1)
        for j in range(n_rot):
            rot = j * d_rot
            r, t = np.deg2rad(rot), np.deg2rad(tilt)
            dirs.append((np.sin(r) * np.cos(t), np.sin(r) * np.sin(t),
                         np.cos(r)))
    return np.asarray(dirs, np.float32)


def _steer_max(basis, dirs, filter_type: str):
    if filter_type == "wall":
        a, b, c = -0.25, 1.25, 2.5
    else:                                  # ridge / filament
        a, b, c = 1.0, -5.0 / 3.0, 10.0 / 3.0
    u0, u1, u2 = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    coeff = np.stack([a + b * u0 ** 2, a + b * u1 ** 2, a + b * u2 ** 2,
                      c * u0 * u1, c * u0 * u2, c * u1 * u2],
                     axis=1).astype(np.float32)
    coeff = torch.as_tensor(coeff, device=basis.device)
    best = torch.full(basis.shape[1:], -torch.inf, dtype=basis.dtype,
                      device=basis.device)
    for w in coeff:
        best = torch.maximum(best, torch.einsum("k,kzyx->zyx", w, basis))
    return best


def steerable_filter_3d(vol, sigma=2.0, delta_ang=15.0, filter_type="ridge",
                        device=None):
    """Directional feature enhancement: max over the direction grid of the
    steered Hessian-of-Gaussian response. filter_type: "wall" | "ridge"."""
    basis = steerable_basis_3d(vol, sigma, device)
    return _steer_max(basis, _direction_grid(float(delta_ang)), filter_type)
