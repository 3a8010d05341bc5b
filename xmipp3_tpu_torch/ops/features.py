"""Image features (the subset of the reference package's ops/features.py
that image_align --pspc needs): translational centering.

Not yet ported (ROADMAP.md, port queue item 11): the classification
feature extractors and TV denoising of the reference module.
"""
from __future__ import annotations

import torch

from xmipp3_tpu_torch.device import as_tensor
from xmipp3_tpu_torch.ops.geo import shift_2d_real
from xmipp3_tpu_torch.ops.shift import best_shift


def center_translationally(imgs, order: int = 3, device=None):
    """Center each image of a (B,H,W) stack at the average best shift
    against its X/Y/XY mirrors (reference centerImageTranslationally,
    filters.cpp:3212; the mirrors are plain reversals)."""
    imgs = as_tensor(imgs, device)
    sx = torch.zeros(imgs.shape[0], device=imgs.device)
    sy = torch.zeros(imgs.shape[0], device=imgs.device)
    for mirrored in (imgs.flip(2), imgs.flip(1), imgs.flip((1, 2))):
        mx, my, _ = best_shift(imgs, mirrored)
        sx = sx + mx
        sy = sy + my
    # the reference translates by MINUS the mean mirror-registration shift
    return shift_2d_real(imgs, -sx / 3.0, -sy / 3.0, order=order)
