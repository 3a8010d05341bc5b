"""Fiducial-landmark enhancement for tilt series.

Counterpart of the reference package's ops/tomo_landmarks.py
(tomo_detect_landmarks.cpp:1310-1470, the directional Fourier filter): a
band around the landmark frequency 1/targetFS (digital, +-0.1) is split
into `n_dirs` 10-degree Gaussian angular cones; the cones' responses are
summed and the image is multiplied by the summed response (isotropic
blobs respond in every cone, linear interpolation edges only in one).

Every frame and every direction run as one batched pass: the cone masks
sum to one (H, W//2+1) mask, so the frames take one rfft2, one product
and one irfft2 on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor


def _cone_mask(H: int, W: int, target_fs: float, n_dirs: int, device):
    """The summed cone mask (H, W//2+1) inside the landmark band."""
    fy = torch.fft.fftfreq(H, device=device)[:, None]
    fx = torch.fft.rfftfreq(W, device=device)[None, :]
    un = torch.sqrt(fy * fy + fx * fx)
    inv_fs = 1.0 / float(target_fs)
    band = (un > inv_fs - 0.1) & (un < inv_fs + 0.1) & (un > 1e-6)
    ux = fx / un.clamp(min=1e-12)
    uy = fy / un.clamp(min=1e-12)
    cos10 = 0.9848
    aux = 8.0 / ((cos10 - 1.0) ** 2)
    angles = torch.arange(n_dirs, dtype=torch.float32,
                          device=device) * (np.pi / n_dirs)
    xd = torch.cos(angles)[:, None, None]
    yd = torch.sin(angles)[:, None, None]
    cosine = torch.abs(xd * ux[None] + yd * uy[None])        # (D, H, Wr)
    cone = torch.where(cosine >= cos10,
                       torch.exp(-((cosine - 1.0) ** 2) * aux), 0.0)
    return cone.sum(dim=0) * band


def directional_enhance(imgs, target_fs: float, n_dirs: int = 8,
                        device=None):
    """imgs (F, H, W) -> enhanced (F, H, W) tensor on `device` (the card
    by default; a tensor stays where it is): img * sum_d dirfilter_d(img).

    target_fs: landmark size in pixels (the band sits at digital
    frequency 1/target_fs +- 0.1, reference lowerBound/upperBound)."""
    imgs = as_tensor(imgs, device)
    _, H, W = imgs.shape
    mask = _cone_mask(H, W, target_fs, int(n_dirs), imgs.device)
    resp = torch.fft.irfft2(torch.fft.rfft2(imgs) * mask[None], s=(H, W))
    return imgs * resp


def downsample_factor(fiducial_px: float, target_px: float) -> float:
    """Reference generateSideInfo: ds so the fiducial lands at
    target_px pixels."""
    return max(float(fiducial_px) / max(float(target_px), 1.0), 1.0)
