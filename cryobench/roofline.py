"""Peaks of the card and the work of the kernels' layers, counted from the
problem's shapes (any implementation of a layer reads the same work).

Copied from `chip_smoke.py`'s phase 2 (`compare`, `tap_stats`,
`cross_vs_plain`): the bound of a call is the larger of its bytes over the
HBM rate and its float32 operations over the rate outside the tensor
cores, with every input byte read once and every output byte written once.
"""
from __future__ import annotations

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor
# cores (the kernels do plain float32 arithmetic).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def bound_s(nbytes: float, nops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, nops / F32_FLOPS)


def cross_work(B: int, nr: int, R: int, K: int, mirror: bool = True):
    """(bytes, flops) of K4's contraction at one trial: both ring-spectrum
    operands (complex64) and the ring weights read once, each output
    spectrum (B, R, K) written once; four real multiply-adds (8 flops) per
    image, ring, reference and harmonic give both spectra."""
    outs = 2 if mirror else 1
    nbytes = 8 * (B + R) * nr * K + 4 * nr + outs * 8 * B * R * K
    return nbytes, 8 * B * nr * R * K


def scan_rings(box: int, radius_min: int = 2, stride: int = 2) -> int:
    """Rings of the matching scan: radius_min..box/2-2, every stride-th."""
    return len(range(radius_min, box // 2 - 2 + 1)[::stride])


def kb_tap_stats(coords, P: int, radius: float):
    """(samples, live taps, touched voxels) of one batch's gridding: coords
    is a list of (zi, yi, xi) float tensors in cube index units, one entry
    a symmetry copy. A sample whose floor corner lies outside [0, P) on any
    axis is dropped whole; a tap is live where its distance is within the
    blob radius and it lies inside the cube."""
    dev = coords[0][0].device
    touched = torch.zeros(P ** 3, dtype=torch.bool, device=dev)
    samples = taps = 0
    r2 = radius * radius
    for zi, yi, xi in coords:
        z0, y0, x0 = (torch.floor(a) for a in (zi, yi, xi))
        valid = ((z0 >= 0) & (z0 < P) & (y0 >= 0) & (y0 < P)
                 & (x0 >= 0) & (x0 < P))
        samples += zi.numel()
        for dz in range(-1, 3):
            for dy in range(-1, 3):
                for dx in range(-1, 3):
                    z, y, x = z0 + dz, y0 + dy, x0 + dx
                    d2 = (z - zi) ** 2 + (y - yi) ** 2 + (x - xi) ** 2
                    live = (valid & (d2 <= r2) & (z >= 0) & (z < P)
                            & (y >= 0) & (y < P) & (x >= 0) & (x < P))
                    idx = ((z * P + y) * P + x)[live].to(torch.int64)
                    taps += idx.numel()
                    touched[idx] = True
    return samples, taps, int(touched.sum())


def kb_work(samples: int, taps: int, touched: int):
    """(bytes, flops) of K3 on a batch (chip_smoke phase 2's counting):
    24 bytes read per sample and copy (coordinates and three values), each
    touched voxel of the three cubes read and written once; per sample
    floor and fractions (6), per live tap the distance (8), the degree-7
    Horner polynomial (14), three products and three adds (6)."""
    return samples * 24 + touched * 3 * 4 * 2, taps * 28 + samples * 6


def slice_coords(mats: np.ndarray, box: int, P: int, max_freq: float,
                 dev):
    """Cube coordinates (zi, yi, xi) of the kept rfft2 samples of images at
    the (C, 3, 3) orientation matrices `mats`: frequency (kx, ky) at
    c + kx*P/box*m0 + ky*P/box*m1, with c = P/2 and |f| <= max_freq."""
    fy = np.fft.fftfreq(box)[:, None]
    fx = np.fft.rfftfreq(box)[None, :]
    keep = np.sqrt(fy ** 2 + fx ** 2) <= max_freq
    KX = torch.as_tensor(np.broadcast_to(fx * P, keep.shape)[keep],
                         device=dev)
    KY = torch.as_tensor(np.broadcast_to(fy * P, keep.shape)[keep],
                         device=dev)
    m = torch.as_tensor(mats, device=dev)
    c = P // 2
    pos = [KX[None] * m[:, 0, i, None] + KY[None] * m[:, 1, i, None] + c
           for i in range(3)]                                # x, y, z
    return [t.reshape(-1).to(torch.float32) for t in (pos[2], pos[1], pos[0])]
