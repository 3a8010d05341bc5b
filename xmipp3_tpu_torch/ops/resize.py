"""Image/volume resizing: Fourier crop/pad (band-limited) and spline scaling.

Counterpart of the reference package's ops/resize.py (the reference
image_resize / transform_downsample engines): the Fourier crop is exact
band-limited downsampling, and the spline scaling resamples through the
port's cubic B-spline (mirror-off-bounds prefilter and 16-tap gather of
ops/geo.py), bilinear or nearest taps, batched on the images' device.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor


def _fourier_crop_pad(spec, out_shape):
    """Center-crop or center-pad the centred full spectrum `spec` over its
    last len(out_shape) axes."""
    k = len(out_shape)
    in_shape = spec.shape[-k:]
    out = torch.zeros(spec.shape[:-k] + tuple(out_shape), dtype=spec.dtype,
                      device=spec.device)
    src, dst = [Ellipsis], [Ellipsis]
    for n_in, n_out in zip(in_shape, out_shape):
        c = min(n_in, n_out)
        s0, d0 = n_in // 2 - c // 2, n_out // 2 - c // 2
        src.append(slice(s0, s0 + c))
        dst.append(slice(d0, d0 + c))
    out[tuple(dst)] = spec[tuple(src)]
    return out


def fourier_resize_2d(imgs, out_h: int, out_w: int, device=None):
    """Band-limited resize via Fourier crop/pad. imgs (B,H,W) ->
    (B,out_h,out_w); a single (H,W) image is accepted too."""
    imgs = as_tensor(imgs, device)
    single = imgs.ndim == 2
    if single:
        imgs = imgs[None]
    B, H, W = imgs.shape
    dims = (-2, -1)
    spec = torch.fft.fftshift(torch.fft.fft2(imgs), dim=dims)
    out = _fourier_crop_pad(spec, (out_h, out_w))
    out = torch.fft.ifft2(torch.fft.ifftshift(out, dim=dims))
    res = out.real * ((out_h * out_w) / (H * W))
    return res[0] if single else res


def fourier_resize_3d(vol, out_d: int, out_h: int, out_w: int, device=None):
    vol = as_tensor(vol, device)
    D, H, W = vol.shape
    spec = torch.fft.fftshift(torch.fft.fftn(vol))
    out = _fourier_crop_pad(spec, (out_d, out_h, out_w))
    res = torch.fft.ifftn(torch.fft.ifftshift(out)).real
    return res * ((out_d * out_h * out_w) / (D * H * W))


def scale_to_size_nearest(arr, out_shape, device=None):
    """Nearest-neighbor rescale to `out_shape` (any rank). Matches the
    reference's NEAREST preview scaling (Image::readPreview /
    scaleToSize(NEAREST), core/xmipp_image_base.cpp): pure index gather,
    every output value is an exact input value."""
    arr = as_tensor(arr, device, dtype=None)
    if len(out_shape) != arr.ndim:
        raise ValueError("out_shape rank must match input rank")
    out = arr
    for ax, (n_in, n_out) in enumerate(zip(arr.shape, out_shape)):
        if n_in == n_out:
            continue
        idx = torch.clamp((torch.arange(n_out, device=arr.device) * n_in)
                          // n_out, 0, n_in - 1)
        out = torch.index_select(out, ax, idx)
    return out


def spline_resize_2d(imgs, out_h: int, out_w: int, order: int = 3,
                     device=None):
    """Scale by resampling with cubic B-spline (order 3), nearest (0) or
    bilinear (any other order) interpolation. imgs (B,H,W) or (H,W)."""
    imgs = as_tensor(imgs, device)
    single = imgs.ndim == 2
    if single:
        imgs = imgs[None]
    B, H, W = imgs.shape
    sy, sx = out_h / H, out_w / W
    # output grid maps back into input by 1/s
    A = torch.tensor([[sx, 0, 0], [0, sy, 0], [0, 0, 1]], dtype=torch.float32)
    out = _resize_warp(imgs, A, out_h, out_w, order)
    return out[0] if single else out


def _resize_warp(imgs, A, out_h: int, out_w: int, order: int):
    from xmipp3_tpu_torch.ops.geo import (_gather_bilinear, _gather_bspline3,
                                          bspline3_prefilter_2d)
    B, H, W = imgs.shape
    dev = imgs.device
    Ainv = torch.linalg.inv(A).to(dev)
    yy = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None] \
        - out_h // 2
    xx = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :] \
        - out_w // 2
    xs = Ainv[0, 0] * xx + Ainv[0, 1] * yy + W // 2
    ys = Ainv[1, 0] * xx + Ainv[1, 1] * yy + H // 2
    xs = xs.expand(B, out_h, out_w)
    ys = ys.expand(B, out_h, out_w)
    if order == 3:
        return _gather_bspline3(bspline3_prefilter_2d(imgs, wrap=False), ys,
                                xs, False)
    if order == 0:
        # NEAREST: round-half-away-from-zero like the reference ROUND
        yi = torch.where(ys >= 0, torch.floor(ys + 0.5),
                         torch.ceil(ys - 0.5)).to(torch.int64)
        xi = torch.where(xs >= 0, torch.floor(xs + 0.5),
                         torch.ceil(xs - 0.5)).to(torch.int64)
        inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        flat = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, -1)
        val = imgs.reshape(B, -1).gather(1, flat).reshape(ys.shape)
        return torch.where(inside, val, 0.0)
    return _gather_bilinear(imgs, ys, xs, False)


def pyramid_reduce_2d(imgs, levels: int = 1, device=None):
    """Gaussian-ish pyramid reduce (factor 2 per level) via Fourier crop of
    the smoothed image — matches the reference 'pyramid' resize option."""
    out = as_tensor(imgs, device)
    for _ in range(levels):
        H, W = out.shape[-2:]
        out = fourier_resize_2d(out, H // 2, W // 2)
    return out


def reslice(vol, view: str):
    """Volume reslicing (the reference MultidimArray::reslice /
    xmipp_image_base VIEW_* semantics):
      y_neg: out[Zout-1-i, k, j] = in[k, i, j]
      x_neg: out[Xout-1-j, i, k] = in[k, i, j]
    y_pos / x_pos are the transposes without the new-axis flip. Host
    numpy."""
    v = np.asarray(vol)
    if view == "y_neg":
        return v.transpose(1, 0, 2)[::-1].copy()
    if view == "y_pos":
        return v.transpose(1, 0, 2)[:, ::-1].copy()
    if view == "x_neg":
        return v.transpose(2, 1, 0)[::-1].copy()
    if view == "x_pos":
        return v.transpose(2, 1, 0)[:, :, ::-1].copy()
    raise ValueError(f"unknown reslice view '{view}'")
