"""Flatten images to the pixels selected by a boolean mask (reference
swiftalign/operators/MaskFlattener.py contract: __call__ maps
(..., H, W) -> (..., n_mask))."""
from __future__ import annotations

import numpy as np


class MaskFlattener:
    def __init__(self, mask):
        self.mask = np.asarray(mask) > 0
        self.output_size = int(self.mask.sum())

    def __call__(self, images, out=None):
        images = np.asarray(images)
        res = images[..., self.mask]
        if out is not None:
            out[...] = res
            return out
        return res

    def unflatten(self, flat, fill=0.0):
        flat = np.asarray(flat)
        out = np.full(flat.shape[:-1] + self.mask.shape, fill,
                      flat.dtype)
        out[..., self.mask] = flat
        return out
