"""Parametric masks (circular/crown/gaussian/raised-cosine/wedge...).

Counterpart of the reference package's ops/mask.py (reference Mask engine,
data/mask.h:360, ProgMask :1039): mask *generators* returning float32
numpy arrays on the host, as there; callers multiply them into images on
the device. Centered-origin convention: logical origin at n//2 (xmipp
FIRST_XMIPP_INDEX).
"""
from __future__ import annotations

import numpy as np


def _radius2_2d(h, w, cy=None, cx=None):
    cy = h // 2 if cy is None else cy
    cx = w // 2 if cx is None else cx
    y = np.arange(h, dtype=np.float32)[:, None] - cy
    x = np.arange(w, dtype=np.float32)[None, :] - cx
    return y * y + x * x


def _radius2_3d(d, h, w):
    z = np.arange(d, dtype=np.float32)[:, None, None] - d // 2
    y = np.arange(h, dtype=np.float32)[None, :, None] - h // 2
    x = np.arange(w, dtype=np.float32)[None, None, :] - w // 2
    return z * z + y * y + x * x


def circular_mask(shape, radius: float | None = None, inner: float = 0.0,
                  mode: str = "binary"):
    """Binary/smooth circular (2D) or spherical (3D) mask.

    radius<0 in the reference CLI means "use dim/2 + radius"; None = dim/2.
    inner>0 makes a crown/shell. mode: binary | gaussian | raised_cosine."""
    if len(shape) == 2:
        r2 = _radius2_2d(*shape)
    else:
        r2 = _radius2_3d(*shape)
    n = min(shape)
    if radius is None:
        radius = n // 2
    elif radius < 0:
        radius = n // 2 + radius
    r = np.sqrt(r2)
    if mode == "binary":
        m = (r <= radius).astype(np.float32)
    elif mode == "gaussian":
        m = np.exp(-r2 / (2 * radius ** 2)).astype(np.float32)
    elif mode == "raised_cosine":
        t = np.clip((r - inner) / max(radius - inner, 1e-6), 0, 1)
        m = (0.5 * (1 + np.cos(np.pi * t))).astype(np.float32)
        inner = 0.0
    else:
        raise ValueError(mode)
    if inner > 0:
        m = m * (r >= inner).astype(np.float32)
    return m


def crown_mask(shape, r_inner: float, r_outer: float):
    return circular_mask(shape, r_outer, inner=r_inner)


def blob_circular_mask(shape, r1: float, blob_radius: float,
                       order: int = 2, alpha: float = 10.4,
                       inner: bool = True):
    """Soft-edged Kaiser-Bessel circular/spherical mask (reference
    BlobCircularMask, data/mask.cpp:219-242): 1 inside radius r1, blob
    profile b(r - r1) over the next `blob_radius` pixels (inner mode);
    mirrored for the outside mode. CLI: `--mask blob_circular R W -m 2
    -a 10.4` (W<0 selects inner, mask.cpp:948-955)."""
    from xmipp3_tpu_torch.ops.basis import kaiser_value
    r2 = _radius2_2d(*shape) if len(shape) == 2 else _radius2_3d(*shape)
    r = np.sqrt(r2)
    if inner:
        soft = kaiser_value(np.clip(r - r1, 0.0, None),
                            a=blob_radius, alpha=alpha, m=order)
        return np.where(r <= r1, 1.0, soft).astype(np.float32)
    soft = kaiser_value(np.clip(r1 - r, 0.0, None),
                        a=blob_radius, alpha=alpha, m=order)
    return np.where(r >= r1, 1.0, soft).astype(np.float32)


def blob_crown_mask(shape, r1: float, r2: float, blob_radius: float,
                    order: int = 2, alpha: float = 10.4,
                    inner: bool = True):
    """Soft crown between radii (reference BlobCrownMask,
    data/mask.cpp:278-308): inner mode = product of an outside-blob at r1
    and an inside-blob at r2; outside mode = sum of the complements."""
    if inner:
        return (blob_circular_mask(shape, r1, blob_radius, order, alpha,
                                   inner=False)
                * blob_circular_mask(shape, r2, blob_radius, order, alpha,
                                     inner=True))
    return (blob_circular_mask(shape, r1, blob_radius, order, alpha,
                               inner=True)
            + blob_circular_mask(shape, r2, blob_radius, order, alpha,
                                 inner=False))


def background_mask(shape, radius: float | None = None):
    """Complement of the circular mask — the 'background' ring used by
    normalization (reference ProgNormalize background definitions)."""
    return 1.0 - circular_mask(shape, radius)


def rectangular_mask(shape, half_x: int, half_y: int, half_z: int | None = None):
    if len(shape) == 2:
        h, w = shape
        y = np.abs(np.arange(h)[:, None] - h // 2)
        x = np.abs(np.arange(w)[None, :] - w // 2)
        return ((y <= half_y) & (x <= half_x)).astype(np.float32)
    d, h, w = shape
    z = np.abs(np.arange(d)[:, None, None] - d // 2)
    y = np.abs(np.arange(h)[None, :, None] - h // 2)
    x = np.abs(np.arange(w)[None, None, :] - w // 2)
    return ((z <= (half_z if half_z is not None else d)) & (y <= half_y)
            & (x <= half_x)).astype(np.float32)


def gaussian_mask(shape, sigma: float):
    if len(shape) == 2:
        r2 = _radius2_2d(*shape)
    else:
        r2 = _radius2_3d(*shape)
    return np.exp(-r2 / (2 * sigma ** 2)).astype(np.float32)


def raised_cosine_window_1d(n: int, overlap_frac: float = 0.5):
    """Separable piece smoother used by PSD estimation tiles (reference
    constructPieceSmoother, ctf_estimate_from_micrograph.cpp:348)."""
    x = np.arange(n, dtype=np.float32)
    ramp = int(n * overlap_frac / 2)
    wnd = np.ones(n, np.float32)
    if ramp > 0:
        t = 0.5 * (1 - np.cos(np.pi * (x[:ramp] + 0.5) / ramp))
        wnd[:ramp] = t
        wnd[-ramp:] = t[::-1]
    return wnd


def region_growing_equal_value(vol, seed=(0, 0, 0), filling_value=0):
    """Flood-fill the 6-connected equal-value region containing `seed`:
    output is 1 everywhere except the grown region, which takes
    `filling_value` (reference regionGrowing3DEqualValue,
    data/filters.cpp:499-560; seed = the array's first logical voxel)."""
    from scipy import ndimage
    v = np.asarray(vol)
    eq = v == v[tuple(seed)]
    lab, _ = ndimage.label(eq)
    out = np.ones(v.shape, np.int32)
    out[lab == lab[tuple(seed)]] = filling_value
    return out
