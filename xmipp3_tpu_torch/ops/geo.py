"""Batched 2-D geometric transforms (the applyGeometry stack), bilinear.

Counterpart of the 2-D part of the reference package's ops/geo.py, as
batched gathers.

Conventions:
  - images are (B, H, W) float32, logical origin at (H//2, W//2);
  - a 3x3 homogeneous matrix A maps INPUT logical coords to OUTPUT logical
    coords (so sampling uses A^-1: out(x) = in(A^-1 x));
  - `wrap=True` wraps coordinates periodically (xmipp WRAP), else zero-fill.

Not yet ported (ROADMAP.md, port queue): cubic B-spline interpolation
(order 3), read_apply_geo, xmipp_geo_matrices and the 3-D transforms.
"""
from __future__ import annotations

import torch

from xmipp3_tpu_torch.device import as_tensor

_LATER_ORDER3 = ("B-spline interpolation (order 3) is not yet ported to "
                 "xmipp3_tpu_torch (ROADMAP.md, port queue: the rest of "
                 "ops/geo.py)")


def _gather_bilinear(imgs, yy, xx, wrap: bool):
    """Bilinear samples of imgs (B,H,W) at array coordinates yy, xx
    (B, ...); a single (H,W) image with (...) coordinates is accepted too."""
    single = imgs.ndim == 2
    if single:
        imgs, yy, xx = imgs[None], yy[None], xx[None]
    B, H, W = imgs.shape
    flat = imgs.reshape(B, -1)
    y0 = torch.floor(yy)
    x0 = torch.floor(xx)
    fy = yy - y0
    fx = xx - x0
    y0 = y0.to(torch.int64)
    x0 = x0.to(torch.int64)

    def tap(dy, dx):
        yi, xi = y0 + dy, x0 + dx
        if wrap:
            yi, xi = torch.remainder(yi, H), torch.remainder(xi, W)
        else:
            inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            yi = yi.clamp(0, H - 1)
            xi = xi.clamp(0, W - 1)
        val = flat.gather(1, (yi * W + xi).reshape(B, -1)).reshape(yy.shape)
        return val if wrap else torch.where(inside, val, 0.0)

    out = (tap(0, 0) * ((1 - fy) * (1 - fx)) + tap(0, 1) * ((1 - fy) * fx) +
           tap(1, 0) * (fy * (1 - fx)) + tap(1, 1) * (fy * fx))
    return out[0] if single else out


def _out_coords(H, W, device):
    cy, cx = H // 2, W // 2
    yy = torch.arange(H, dtype=torch.float32, device=device)[:, None] - cy
    xx = torch.arange(W, dtype=torch.float32, device=device)[None, :] - cx
    return yy.expand(H, W), xx.expand(H, W)


def apply_affine_2d(imgs, mats, order: int = 1, wrap: bool = False,
                    inverse: bool = False, device=None):
    """Warp a batch: imgs (B,H,W), mats (B,3,3) mapping input->output coords
    in (x, y) logical order. Returns (B,H,W)."""
    if order != 1:
        raise NotImplementedError(_LATER_ORDER3)
    imgs = as_tensor(imgs, device)
    mats = as_tensor(mats, imgs.device)
    if imgs.ndim == 2:
        imgs = imgs[None]
    if mats.ndim == 2:
        mats = mats[None].expand(imgs.shape[0], 3, 3)
    B, H, W = imgs.shape
    M = (mats if inverse else torch.linalg.inv(mats))[:, :, :, None, None]
    yy, xx = _out_coords(H, W, imgs.device)
    xs = M[:, 0, 0] * xx + M[:, 0, 1] * yy + M[:, 0, 2]
    ys = M[:, 1, 0] * xx + M[:, 1, 1] * yy + M[:, 1, 2]
    return _gather_bilinear(imgs, ys + H // 2, xs + W // 2, wrap)


def _flip_matrices(A, flip):
    """M_x^flip · A: the x-mirror applied to the rows that carry a flip."""
    mirror = torch.tensor([[-1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]],
                          device=A.device)
    f = as_tensor(flip, A.device, torch.bool)
    return torch.where(f[:, None, None], mirror @ A, A)


def alignment_matrices_2d(psi, sx, sy, flip=None, scale=None, device=None):
    """Batched alignment matrices: T(shift)·S·R(psi) (optionally mirrored),
    (B,3,3) float32."""
    psi = torch.deg2rad(as_tensor(psi, device))
    dev = psi.device
    sx = as_tensor(sx, dev)
    sy = as_tensor(sy, dev)
    B = psi.shape[0]
    sc = torch.ones(B, device=dev) if scale is None else as_tensor(scale, dev)
    c, s = torch.cos(psi) * sc, torch.sin(psi) * sc
    zeros = torch.zeros(B, device=dev)
    ones = torch.ones(B, device=dev)
    A = torch.stack([
        torch.stack([c, s, sx], dim=-1),
        torch.stack([-s, c, sy], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=-2)
    return A if flip is None else _flip_matrices(A, flip)


def apply_alignment_2d(imgs, psi, sx, sy, flip=None, order: int = 1,
                       wrap: bool = False, device=None):
    """Apply per-image alignment (rotate by psi, then shift) to register a
    batch — the metadata-geometry application of XmippMetadataProgram."""
    imgs = as_tensor(imgs, device)
    A = alignment_matrices_2d(psi, sx, sy, flip, device=imgs.device)
    return apply_affine_2d(imgs, A, order=order, wrap=wrap)


# ---------------------------------------------------------------------------
# Metadata pose convention (the single framework-wide contract):
#   stored (rot, tilt, psi, shiftX, shiftY, flip) satisfy
#       shift(img, (sx, sy)) ≈ M_x^flip · proj(A(rot, tilt, psi))
#   i.e. the registered (reference-frame) image is
#       registered = M_x^flip · R(-psi) · T(sx, sy) · img
# matching the reference behavior where reconstruct applies stored shifts to
# the image and uses (rot,tilt,psi) directly as the pose.
# ---------------------------------------------------------------------------

def metadata_alignment_matrices(psi, sx, sy, flip=None, scale=None,
                                device=None):
    """Matrices of the registration transform M_x^f·R(-psi)·S·T(s)
    (batched; scale defaults to 1)."""
    psi_r = torch.deg2rad(as_tensor(psi, device))
    dev = psi_r.device
    sx = as_tensor(sx, dev)
    sy = as_tensor(sy, dev)
    B = psi_r.shape[0]
    sc = torch.ones(B, device=dev) if scale is None else as_tensor(scale, dev)
    c, s = torch.cos(-psi_r) * sc, torch.sin(-psi_r) * sc
    zeros = torch.zeros(B, device=dev)
    ones = torch.ones(B, device=dev)
    R = torch.stack([
        torch.stack([c, s, zeros], dim=-1),
        torch.stack([-s, c, zeros], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1)], dim=-2)
    T = torch.stack([
        torch.stack([ones, zeros, sx], dim=-1),
        torch.stack([zeros, ones, sy], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1)], dim=-2)
    A = R @ T
    return A if flip is None else _flip_matrices(A, flip)


def apply_md_geometry(imgs, psi, sx, sy, flip=None, order: int = 1,
                      wrap: bool = False, device=None):
    """Register a batch using stored metadata pose parameters."""
    imgs = as_tensor(imgs, device)
    A = metadata_alignment_matrices(psi, sx, sy, flip, device=imgs.device)
    return apply_affine_2d(imgs, A, order=order, wrap=wrap)


def centered_flip(imgs, axis: int):
    """Mirror about the center n//2 (index i -> (n-i) mod n). A plain
    reversal maps i -> n-1-i, which for EVEN sizes is the centered mirror
    plus a one-pixel shift — that stray pixel gets absorbed into fitted
    shifts and then breaks the metadata pose conversion (the matrices in
    metadata_alignment_matrices mirror about the exact center)."""
    n = imgs.shape[axis]
    out = imgs.flip(axis)
    if n % 2 == 0:
        out = torch.roll(out, 1, axis)
    return out


def rotate_vector_2d(vx, vy, angle_deg):
    """Rotate 2-vectors by angle (consistent with R(a) composition:
    v' = (c·vx + s·vy, -s·vx + c·vy))."""
    a = torch.deg2rad(angle_deg)
    c, s = torch.cos(a), torch.sin(a)
    return c * vx + s * vy, -s * vx + c * vy


def alignment_to_md_pose(psi_align, sx, sy, flip=None, device=None):
    """Convert 'applied alignment' params (aligned = warp(T(s)·S·R_a(ψ)) of
    the experimental image, found on its x-mirror when flip) into the stored
    metadata pose convention consumed by apply_md_geometry
    (M = M_x^flip·R_md(ψm)·T(sm)).

    Derivation (matrix identity warp(M_md) == warp(A_align·F^flip)):
      no flip:  M_md = T(s)·R_md(-ψ)         => ψm = -ψ, sm = R_md(-ψ)·s
      flip:     F·R_md(ψm)·T(sm) = T(s)·R_md(-ψ)·F
                                 = F·T(Fs)·R_md(ψ)
                => ψm = ψ,  sm = R_md(-ψ)·(-sx, sy)
    (F = diag(-1,1) x-mirror; R_a(ψ) = R_md(-ψ).)"""
    psi_align = as_tensor(psi_align, device)
    dev = psi_align.device
    sx = as_tensor(sx, dev)
    sy = as_tensor(sy, dev)
    if flip is None:
        f = torch.zeros(psi_align.shape, dtype=torch.bool, device=dev)
    else:
        f = as_tensor(flip, dev, torch.bool)
    psi_md = torch.where(f, psi_align, -psi_align)
    sx_eff = torch.where(f, -sx, sx)
    sx_md, sy_md = rotate_vector_2d(sx_eff, sy, psi_md)
    psi_md = torch.remainder(psi_md + 180.0, 360.0) - 180.0
    return psi_md, sx_md, sy_md, f
