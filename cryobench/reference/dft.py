"""Discrete Fourier transforms as matrix products, in a stated precision.

The plain reference computes every transform and contraction as a product
with cos/sin tables, so that its precision is the precision of its
products: "fp32" is full float32 (TF32 off), "tf32" rounds every operand
of a product to TF32's 10-bit mantissa (what the card's TF32 mode does),
"bf16" computes the products in bfloat16. Imports nothing of the program.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to the nearest TF32 value (10 mantissa bits, ties
    to even)."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0x0FFF + lsb) & ~0x1FFF
    return i.view(torch.float32)


def rnd(x: torch.Tensor, prec: str) -> torch.Tensor:
    """x as the precision keeps an operand or a result."""
    if prec == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if prec == "tf32":
        return to_tf32(x)
    return x


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """a @ b (batched) in float32 in the stated precision."""
    if prec == "bf16":
        return (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).to(torch.float32)
    if prec == "tf32":
        a, b = to_tf32(a), to_tf32(b)
    return a @ b


@lru_cache(maxsize=64)
def _tables(n: int, k: int, device: torch.device, inverse: bool):
    """cos/sin tables of the DFT of length n over bins 0..k-1: (n, k) for
    the forward transform, (k, n) with the Hermitian weights and 1/n for
    the inverse real transform."""
    j = np.arange(n)[:, None]
    m = np.arange(k)[None, :]
    ang = 2 * np.pi * ((j * m) % n) / n
    c, s = np.cos(ang), np.sin(ang)
    if inverse:
        d = np.full(k, 2.0)
        d[0] = 1.0
        if n % 2 == 0 and k - 1 == n // 2:
            d[-1] = 1.0
        c, s = (c * d / n).T, (s * d / n).T
    return (torch.as_tensor(c, dtype=torch.float32, device=device),
            torch.as_tensor(s, dtype=torch.float32, device=device))


def rfft(x: torch.Tensor, k: int, prec: str):
    """Bins 0..k-1 of the DFT of real x along its last axis: (re, im)."""
    c, s = _tables(x.shape[-1], k, x.device, False)
    return mm(x, c, prec), -mm(x, s, prec)


def irfft(re: torch.Tensor, im: torch.Tensor, n: int, prec: str):
    """The real inverse of length n of bins (re, im) along the last axis;
    the imaginary parts of bin 0 and of the Nyquist bin add nothing."""
    c, s = _tables(n, re.shape[-1], re.device, True)
    return mm(re, c, prec) - mm(im, s, prec)


def dft(re, im, dim: int, inverse: bool, prec: str):
    """The full complex DFT (or its inverse, with 1/n) along `dim`."""
    n = re.shape[dim]
    c, s = _tables(n, n, re.device, False)
    re, im = re.movedim(dim, -1), im.movedim(dim, -1)
    sg = 1.0 if inverse else -1.0
    out_r = mm(re, c, prec) - sg * mm(im, s, prec)
    out_i = mm(im, c, prec) + sg * mm(re, s, prec)
    if inverse:
        out_r, out_i = out_r / n, out_i / n
    return out_r.movedim(-1, dim), out_i.movedim(-1, dim)


def rfft2(x: torch.Tensor, prec: str):
    """rfft2 of (..., H, W) real x: (re, im) of shape (..., H, W//2+1)."""
    re, im = rfft(x, x.shape[-1] // 2 + 1, prec)
    return dft(re, im, -2, False, prec)


def irfft2(re, im, shape, prec: str):
    """The real inverse of an rfft2 half spectrum to (..., H, W)."""
    re, im = dft(re, im, -2, True, prec)
    return irfft(re, im, shape[-1], prec)
