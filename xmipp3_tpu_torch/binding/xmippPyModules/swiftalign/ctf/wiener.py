"""Wiener inverse filter H*/(|H|^2 + N/S) (reference
swiftalign/ctf/wiener.py formula)."""
from __future__ import annotations

import numpy as np


def wiener_2d(direct_filter, inverse_ssnr=None, out=None):
    H = np.asarray(direct_filter)
    p = np.abs(H) ** 2 if np.iscomplexobj(H) else np.square(H)
    if inverse_ssnr is None:
        inverse_ssnr = p.mean(axis=(-2, -1), keepdims=True) * 0.1
    res = np.conj(H) / (p + inverse_ssnr)
    if out is not None:
        out[...] = res
        return out
    return res
