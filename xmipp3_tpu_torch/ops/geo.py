"""Batched geometric transforms (the applyGeometry stack).

Counterpart of the reference package's ops/geo.py, as batched gathers.

Conventions:
  - images are (B, H, W) float32, logical origin at (H//2, W//2);
  - a 3x3 homogeneous matrix A maps INPUT logical coords to OUTPUT logical
    coords (so sampling uses A^-1: out(x) = in(A^-1 x));
  - `wrap=True` wraps coordinates periodically (xmipp WRAP), else zero-fill.
Interpolation: order 1 (bilinear) or 3 (cubic B-spline after a prefilter:
periodic through the FFT with wrap, else the reference's mirror-off-bounds
boundary through the DCT-II, applied as one (N, N) matrix per axis).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor


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


def _bspline3_weight(t):
    """Cubic B-spline kernel B3(|t|), |t| < 2."""
    a = t.abs()
    w_inner = (4.0 - 6.0 * a * a + 3.0 * a * a * a) / 6.0
    w_outer = ((2.0 - a) ** 3) / 6.0
    return torch.where(a < 1.0, w_inner, torch.where(a < 2.0, w_outer, 0.0))


@lru_cache(maxsize=16)
def _mirror_prefilter_matrix(n: int, device: torch.device):
    """(n, n) float32 matrix of the mirror-off-bounds B-spline deconvolution
    along one axis, built in float64: C^T diag(1/h) C, with C the
    orthonormal DCT-II matrix and h(k) = (4 + 2 cos(pi k / n)) / 6. The
    half-sample-even extension is the DCT-II's symmetry, so the sampled
    kernel [1/6, 4/6, 1/6] is diagonal in that basis. The matrix is
    symmetric."""
    k = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(n, dtype=np.float64)[None, :]
    C = np.cos(np.pi * k * (2 * i + 1) / (2 * n)) * np.sqrt(2.0 / n)
    C[0] /= np.sqrt(2.0)
    h = (4.0 + 2.0 * np.cos(np.pi * np.arange(n) / n)) / 6.0
    return torch.as_tensor((C.T @ (C / h[:, None])).astype(np.float32),
                           device=device)


def bspline3_prefilter_2d(imgs, wrap: bool = True, device=None):
    """B-spline coefficient prefilter of (B,H,W) or (H,W) images: coeffs =
    img deconvolved by the sampled cubic kernel [1/6, 4/6, 1/6] per axis.

    wrap=True: periodic boundary (through the FFT), to pair with wrapped
    gathers. wrap=False: mirror-off-bounds boundary (Bilib
    MirrorOffBounds, the reference produceSplineCoefficients convention),
    as one DCT-derived (N, N) matrix product per axis."""
    imgs = as_tensor(imgs, device)
    H, W = imgs.shape[-2:]
    if wrap:
        ky = (4.0 + 2.0 * torch.cos(2 * np.pi * torch.fft.fftfreq(
            H, device=imgs.device))) / 6.0
        kx = (4.0 + 2.0 * torch.cos(2 * np.pi * torch.fft.rfftfreq(
            W, device=imgs.device))) / 6.0
        spec = torch.fft.rfft2(imgs) / (ky[:, None] * kx[None, :])
        return torch.fft.irfft2(spec, s=(H, W))
    My = _mirror_prefilter_matrix(H, imgs.device)
    Mx = _mirror_prefilter_matrix(W, imgs.device)
    return My @ imgs @ Mx


def _mirror_off(idx, n: int):
    """Map an integer index into [0, n) by mirror-off-bounds reflection
    (valid for idx in [-n, 2n-1], which covers all B-spline taps)."""
    idx = torch.where(idx < 0, -1 - idx, idx)
    return torch.where(idx >= n, 2 * n - 1 - idx, idx)


def _gather_bspline3(coeffs, yy, xx, wrap: bool, zero_outside: bool = True):
    """Cubic B-spline samples of coefficient images (B,H,W) at array
    coordinates yy, xx (B, ...): a row of taps at a time (4 gathers of the
    4 x taps each), summed in the order of a tap at a time. wrap=True:
    periodic taps. wrap=False: mirror-off-bounds taps, with the OUTPUT
    zeroed wherever the sample point itself falls outside
    [0, N-1] (the reference applyGeometry DONT_WRAP contract: outside
    points are 0, near-edge points use the mirrored extension — not
    zero-padded taps). A single (H,W) image with (...) coordinates is
    accepted too."""
    single = coeffs.ndim == 2
    if single:
        coeffs, yy, xx = coeffs[None], yy[None], xx[None]
    B, H, W = coeffs.shape
    flat = coeffs.reshape(-1)
    base = (torch.arange(B, device=coeffs.device) * (H * W)).reshape(
        B, *([1] * (yy.dim() - 1)))
    d = torch.arange(-1, 3, device=coeffs.device).reshape(
        4, *([1] * yy.dim()))

    def taps(c, n):
        """The 4 taps along one axis: weights and indices, (4, B, ...)."""
        i = torch.floor(c).to(torch.int64) + d
        w = _bspline3_weight(c - i.to(c.dtype))
        return w, (torch.remainder(i, n) if wrap else
                   _mirror_off(i.clamp(-n, 2 * n - 1), n))

    wx, xi = taps(xx, W)
    wy, yi = taps(yy, H)
    xi = xi + base
    out = torch.zeros_like(yy)
    for k in range(4):
        terms = flat[yi[k] * W + xi] * wy[k] * wx
        for j in range(4):
            out = out + terms[j]
    if not wrap and zero_outside:
        eps = 1e-4
        inside = ((yy >= -eps) & (yy <= H - 1 + eps) &
                  (xx >= -eps) & (xx <= W - 1 + eps))
        out = torch.where(inside, out, 0.0)
    return out[0] if single else out


def _out_coords(H, W, device):
    cy, cx = H // 2, W // 2
    yy = torch.arange(H, dtype=torch.float32, device=device)[:, None] - cy
    xx = torch.arange(W, dtype=torch.float32, device=device)[None, :] - cx
    return yy.expand(H, W), xx.expand(H, W)


def apply_affine_2d(imgs, mats, order: int = 1, wrap: bool = False,
                    inverse: bool = False, device=None):
    """Warp a batch: imgs (B,H,W), mats (B,3,3) mapping input->output coords
    in (x, y) logical order. order 3 is the cubic B-spline, any other
    order bilinear. Returns (B,H,W)."""
    imgs = as_tensor(imgs, device)
    mats = as_tensor(mats, imgs.device)
    if imgs.ndim == 2:
        imgs = imgs[None]
    if mats.ndim == 2:
        mats = mats[None].expand(imgs.shape[0], 3, 3)
    B, H, W = imgs.shape
    # inv_ex: linalg.inv without its host check of the factorisation, so
    # that a CUDA graph can hold the warp (the binding's image_align)
    M = (mats if inverse else torch.linalg.inv_ex(mats)[0])[:, :, :, None,
                                                             None]
    yy, xx = _out_coords(H, W, imgs.device)
    xs = M[:, 0, 0] * xx + M[:, 0, 1] * yy + M[:, 0, 2]
    ys = M[:, 1, 0] * xx + M[:, 1, 1] * yy + M[:, 1, 2]
    if order == 3:
        return _gather_bspline3(bspline3_prefilter_2d(imgs, wrap),
                                ys + H // 2, xs + W // 2, wrap)
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


def xmipp_geo_matrices(psi, sx, sy, flip=None, scale=None, device=None):
    """The reference geo2TransformationMatrix: gather matrix
    A = [[S·c, -S·s, sx], [S·s, S·c, sy], [0,0,1]] in (x, y) logical coords
    (flip negates the first row's rotation part). readApplyGeo resamples
    out(x) = in(A·x)."""
    psi_r = torch.deg2rad(as_tensor(psi, device))
    dev = psi_r.device
    sx = as_tensor(sx, dev)
    sy = as_tensor(sy, dev)
    B = psi_r.shape[0]
    sc = torch.ones(B, device=dev) if scale is None else as_tensor(scale, dev)
    c, s = torch.cos(psi_r) * sc, torch.sin(psi_r) * sc
    f = (torch.zeros(B, dtype=torch.bool, device=dev) if flip is None
         else as_tensor(flip, dev, torch.bool))
    sgn = torch.where(f, -1.0, 1.0)
    zeros = torch.zeros(B, device=dev)
    ones = torch.ones(B, device=dev)
    return torch.stack([
        torch.stack([sgn * c, -sgn * s, sx], dim=-1),
        torch.stack([s, c, sy], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1)], dim=-2)


def read_apply_geo(imgs, psi, sx, sy, flip=None, scale=None,
                   order: int = 3, wrap: bool = False, device=None):
    """Reference Image::readApplyGeo semantics: apply the stored 2-D
    registration geometry exactly as xmippCore does (BSPLINE3, gather with
    the geo2TransformationMatrix — see xmipp_geo_matrices). This is the
    convention of reference-written align2d-style metadata; it differs
    from apply_md_geometry (the projection-pose registration;
    readApplyGeo(psi) == apply_md_geometry(-psi) for pure rotations)."""
    imgs = as_tensor(imgs, device)
    A = xmipp_geo_matrices(psi, sx, sy, flip, scale, device=imgs.device)
    return apply_affine_2d(imgs, A, order=order, wrap=wrap, inverse=True)


def registration_pose_to_xmipp_row(psi_align, sx, sy, flip=None,
                                   device=None):
    """Convert the aligner's registration parameters into the reference
    align2d row convention (transformationMatrix2Parameters2D analog): the
    returned numpy (psi, shiftX, shiftY, flip, scale) row satisfies
    read_apply_geo(row) == apply_md_geometry(alignment_to_md_pose(...)),
    i.e. a reference readApplyGeo reproduces the registered image
    (reference align2d.cpp:231-234 writer)."""
    pm, sxm, sym, f = alignment_to_md_pose(psi_align, sx, sy, flip, device)
    M = metadata_alignment_matrices(pm, sxm, sym, f).cpu().numpy()
    A = np.linalg.inv(M.astype(np.float64))
    flip_out = np.linalg.det(A[:, :2, :2]) < 0
    R = A[:, :2, :2].copy()
    R[flip_out, 0, :] *= -1.0
    psi_out = np.degrees(np.arctan2(R[:, 1, 0], R[:, 0, 0]))
    scale = np.hypot(R[:, 0, 0], R[:, 1, 0])
    return (psi_out.astype(np.float32), A[:, 0, 2].astype(np.float32),
            A[:, 1, 2].astype(np.float32), flip_out,
            scale.astype(np.float32))


def rotate_2d(imgs, angles, order: int = 1, wrap: bool = False,
              device=None):
    imgs = as_tensor(imgs, device)
    B = imgs.shape[0] if imgs.ndim == 3 else 1
    z = torch.zeros(B, device=imgs.device)
    ang = as_tensor(angles, imgs.device).expand(B)
    return apply_affine_2d(imgs, alignment_matrices_2d(ang, z, z),
                           order=order, wrap=wrap)


def shift_2d_real(imgs, sx, sy, order: int = 1, wrap: bool = False,
                  device=None):
    imgs = as_tensor(imgs, device)
    B = imgs.shape[0] if imgs.ndim == 3 else 1
    z = torch.zeros(B, device=imgs.device)
    return apply_affine_2d(imgs, alignment_matrices_2d(
        z, as_tensor(sx, imgs.device).expand(B),
        as_tensor(sy, imgs.device).expand(B)), order=order, wrap=wrap)


# ---------------------------------------------------------------------------
# 3D affine (volumes): used by symmetrize / volume align
# ---------------------------------------------------------------------------

#: voxels of warped output that one pass of apply_affine_3d computes: the
#: matrices go through in chunks of this many voxels (about 20 float32 and
#: int64 temporaries of that size each)
AFFINE_CHUNK_VOXELS = 1 << 23


def apply_affine_3d(vol, mats, wrap: bool = False, device=None):
    """vol (D,H,W), mats (S,3,3) rotation-only (or (S,3,4) with translation);
    returns (S,D,H,W) — one trilinearly warped copy per matrix (symmetry
    replication). The matrices are warped together, in chunks of
    AFFINE_CHUNK_VOXELS output voxels; each voxel's arithmetic is the same
    as for one matrix alone."""
    vol = as_tensor(vol, device)
    dev = vol.device
    D, H, W = vol.shape
    mats = as_tensor(mats, dev)
    if mats.ndim == 2:
        mats = mats[None]
    if mats.shape[-1] == 3:
        mats = torch.cat([mats, torch.zeros(mats.shape[:-1] + (1,),
                                            device=dev)], dim=-1)
    cz, cy, cx = D // 2, H // 2, W // 2
    zz = torch.arange(D, dtype=torch.float32, device=dev)[:, None, None] - cz
    yy = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None] - cy
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :] - cx
    flat = vol.reshape(-1)
    Rs = torch.linalg.inv(mats[:, :, :3])
    ts = mats[:, :, 3]

    def warp(R, t):
        # R (s,3,3), t (s,3) -> (s,D,H,W)
        r = lambda i, j: R[:, i, j].reshape(-1, 1, 1, 1)
        X, Y, Z = (c - t[:, k].reshape(-1, 1, 1, 1)
                   for k, c in enumerate((xx, yy, zz)))
        xs = r(0, 0) * X + r(0, 1) * Y + r(0, 2) * Z
        ys = r(1, 0) * X + r(1, 1) * Y + r(1, 2) * Z
        zs = r(2, 0) * X + r(2, 1) * Y + r(2, 2) * Z
        zi, yi, xi = zs + cz, ys + cy, xs + cx
        z0, y0, x0 = (torch.floor(c).to(torch.int64) for c in (zi, yi, xi))
        fz, fy, fx = zi - z0, yi - y0, xi - x0
        out = torch.zeros((len(R), D, H, W), device=dev)
        for dz in range(2):
            for dy in range(2):
                for dx in range(2):
                    zj, yj, xj = z0 + dz, y0 + dy, x0 + dx
                    w = ((fz if dz else 1 - fz) * (fy if dy else 1 - fy)
                         * (fx if dx else 1 - fx))
                    if wrap:
                        idx = ((torch.remainder(zj, D) * H
                                + torch.remainder(yj, H)) * W
                               + torch.remainder(xj, W))
                        val = flat[idx]
                    else:
                        inside = ((zj >= 0) & (zj < D) & (yj >= 0) & (yj < H)
                                  & (xj >= 0) & (xj < W))
                        idx = ((zj.clamp(0, D - 1) * H + yj.clamp(0, H - 1))
                               * W + xj.clamp(0, W - 1))
                        val = torch.where(inside, flat[idx], 0.0)
                    out = out + w * val
        return out

    per = max(1, AFFINE_CHUNK_VOXELS // (D * H * W))
    return torch.cat([warp(Rs[s:s + per], ts[s:s + per])
                      for s in range(0, len(Rs), per)])


def window_2d(imgs, out_h: int, out_w: int, fill: float = 0.0, device=None):
    """Center crop/pad (xmipp transform_window semantics, centered origins)."""
    imgs = as_tensor(imgs, device, None)
    single = imgs.ndim == 2
    if single:
        imgs = imgs[None]
    B, H, W = imgs.shape
    out = torch.full((B, out_h, out_w), fill, dtype=imgs.dtype,
                     device=imgs.device)
    # align logical centers
    cy, cx = H // 2, W // 2
    oy, ox = out_h // 2, out_w // 2
    y0_src = max(0, cy - oy)
    x0_src = max(0, cx - ox)
    y0_dst = max(0, oy - cy)
    x0_dst = max(0, ox - cx)
    hh = min(H - y0_src, out_h - y0_dst)
    ww = min(W - x0_src, out_w - x0_dst)
    out[:, y0_dst:y0_dst + hh, x0_dst:x0_dst + ww] = \
        imgs[:, y0_src:y0_src + hh, x0_src:x0_src + ww]
    return out[0] if single else out


def window_2d_logical(img, y0: int, x0: int, yF: int, xF: int,
                      fill: float = 0.0):
    """Crop/pad a numpy image to the logical window [y0..yF] x [x0..xF] (the
    reference window2D contract: indices are LOGICAL, the array's origin at
    (H//2, W//2); out size (yF-y0+1, xF-x0+1) with out's STARTING at
    (y0, x0)). Out-of-range source pixels take `fill`. Host numpy, as in
    the reference."""
    img = np.asarray(img)
    H, W = img.shape[-2:]
    oh, ow = yF - y0 + 1, xF - x0 + 1
    out = np.full(img.shape[:-2] + (oh, ow), fill, img.dtype)
    cy, cx = H // 2, W // 2
    ys = np.arange(y0, yF + 1) + cy
    xs = np.arange(x0, xF + 1) + cx
    iy = np.where((ys >= 0) & (ys < H))[0]
    ix = np.where((xs >= 0) & (xs < W))[0]
    if iy.size and ix.size:
        out[..., iy[0]:iy[-1] + 1, ix[0]:ix[-1] + 1] = \
            img[..., ys[iy[0]]:ys[iy[-1]] + 1, xs[ix[0]]:xs[ix[-1]] + 1]
    return out
