"""Multidimensional rfft frequency grid (reference
swiftalign/fourier/rfftnfreq.py: stacked meshgrid of fftfreq axes with
rfftfreq on the last)."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def rfftnfreq(dim: Sequence[int], d: float = 1.0, dtype=np.float32):
    axes = [np.fft.fftfreq(n, d=d) for n in dim[:-1]]
    axes.append(np.fft.rfftfreq(dim[-1], d=d))
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack(grids).astype(dtype)
