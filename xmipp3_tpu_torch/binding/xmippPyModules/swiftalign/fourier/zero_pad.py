from __future__ import annotations

import numpy as np


def zero_pad(images: np.ndarray, shape) -> np.ndarray:
    """Center zero-pad the trailing 2 dims to `shape` (reference
    swiftalign/fourier/zero_pad.py role: padding before FFT
    interpolation)."""
    images = np.asarray(images)
    H, W = images.shape[-2:]
    oh, ow = shape
    out = np.zeros(images.shape[:-2] + (oh, ow), images.dtype)
    y0 = (oh - H) // 2
    x0 = (ow - W) // 2
    out[..., y0:y0 + H, x0:x0 + W] = images
    return out
