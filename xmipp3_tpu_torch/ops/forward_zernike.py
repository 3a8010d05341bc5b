"""Forward-model Zernike3D per-particle fitting (forward_zernike_images,
forward_zernike_subtomos, forward_zernike_volume).

Counterpart of the reference package's ops/forward_zernike.py, which
rebuilds the reference suite's forward engine
(reconstruction/forward_zernike_images.{h,cpp}: deformVol at
:1047-1145 splats each masked voxel, displaced by the Zernike3D
deformation field, directly into the rotated projection plane; cost =
image correlation + lambda * deformation, optimized per particle).

The voxel selection and the splat footprints are host numpy, as in the
reference. On the card: the splat, a differentiable scatter-add (bilinear
/ trilinear weights, or the projected / 3-D Kaiser-Bessel footprint with
the table's linear interpolation so that the position gradient flows)
with clamped indices and an `inside` mask, through torch's index_add;
and the per-particle fits. The reference vmaps a per-particle Adam
lax.scan; here the batch axis rides in the tensors, and each step takes
one torch.autograd.grad of the SUM of the per-particle losses (the
losses are independent, so each particle's gradient is its own), with
the reference's per-group learning rates and bias correction. The step
loop reads nothing back to the host.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor, fp32_products
from xmipp3_tpu_torch.ops.zernike import (real_sph_harm, zernike_indices,
                                          zernike_radial)


def masked_voxel_basis(vol: np.ndarray, L1: int, L2: int,
                       rmax: float | None = None,
                       value_threshold: float = 0.0,
                       mask: np.ndarray | None = None,
                       rdef: float | None = None,
                       step: int = 1):
    """Voxel positions/values inside the deformation sphere + the Zernike3D
    basis evaluated AT those voxels (host numpy): returns (positions (N,3)
    [x,y,z] centered, values (N,), Z (K,N)).

    rmax selects voxels (radius in px; reference --Rmax), rdef normalizes
    the Zernike basis (reference --RDef; defaults to rmax), mask restricts
    the selection to mask>0 (reference --mask), and step keeps every
    step-th voxel along each axis (reference --step, the deformVol loop
    stride)."""
    D = vol.shape[0]
    if rmax is None or rmax <= 0:
        rmax = D / 2 - 1
    if rdef is None or rdef <= 0:
        rdef = rmax
    z, y, x = np.mgrid[0:D, 0:D, 0:D].astype(np.float64)
    zc, yc, xc = z - D // 2, y - D // 2, x - D // 2
    r = np.sqrt(xc * xc + yc * yc + zc * zc)
    sel = (r <= rmax) & (np.abs(vol) > value_threshold)
    if mask is not None:
        sel &= np.squeeze(np.asarray(mask)) > 0.5
    if step > 1:
        sel &= ((z % step == 0) & (y % step == 0) & (x % step == 0))
    pos = np.stack([xc[sel], yc[sel], zc[sel]], axis=1)
    vals = np.asarray(vol)[sel].astype(np.float32)
    xr, yr, zr = (pos[:, 0] / rdef, pos[:, 1] / rdef, pos[:, 2] / rdef)
    rr = np.sqrt(xr * xr + yr * yr + zr * zr)
    rs = np.where(rr > 0, rr, 1e-9)
    theta = np.arccos(np.clip(zr / rs, -1, 1))
    phi = np.arctan2(yr, xr)
    idx = zernike_indices(L1, L2)
    Z = np.zeros((len(idx), len(vals)), np.float32)
    for k, (l, n, m) in enumerate(idx):
        Z[k] = (zernike_radial(n, l, rr)
                * real_sph_harm(l, m, theta, phi)).astype(np.float32)
    return pos.astype(np.float32), vals, Z


def blob_splat_profile(blob_r: float, order: int = 2, alpha: float = 7.05,
                       samples_per_px: int = 32):
    """Radial profile of the PROJECTED 3-D Kaiser-Bessel blob (its line
    integral along the projection direction), tabulated at 1/samples_per_px
    px: the reference's splatting footprint (blob.radius=blobr, order 2,
    alpha 7.05, forward_zernike_images.cpp:279-281). Returns (profile
    (T,), n_taps) where n_taps is the integer tap half-width."""
    from xmipp3_tpu_torch.ops.basis import kaiser_value
    n_taps = int(np.ceil(blob_r))
    smax = n_taps + 1.0
    s = np.arange(int(smax * samples_per_px) + 2) / samples_per_px
    zq = np.linspace(-blob_r, blob_r, 257)
    rr = np.sqrt(s[:, None] ** 2 + zq[None, :] ** 2)
    vals = np.asarray(kaiser_value(rr.ravel(), a=blob_r, alpha=alpha,
                                   m=order), np.float64).reshape(rr.shape)
    prof = np.trapezoid(vals, zq, axis=1)
    # normalize to unit mass on the 2-D plane so splatted images keep the
    # voxel values' scale (sum over the footprint ~ 1)
    ss = np.arange(0.0, smax, 1.0 / samples_per_px)
    pr = np.interp(ss, s, prof)
    mass = np.trapezoid(2 * np.pi * ss * pr, ss)
    prof = prof / max(mass, 1e-12)
    return prof.astype(np.float32), n_taps


def blob_splat_profile_3d(blob_r: float, order: int = 2,
                          alpha: float = 7.05, samples_per_px: int = 32):
    """Radial table of the 3-D Kaiser-Bessel blob VALUE (not projected),
    normalized to unit integral over R^3: the volume-splat footprint.
    Returns (profile (T,), n_taps)."""
    from xmipp3_tpu_torch.ops.basis import kaiser_value
    n_taps = int(np.ceil(blob_r))
    smax = n_taps + 1.0
    s = np.arange(int(smax * samples_per_px) + 2) / samples_per_px
    prof = np.asarray(kaiser_value(s, a=blob_r, alpha=alpha, m=order),
                      np.float64)
    mass = np.trapezoid(4 * np.pi * s * s * prof, s)
    prof = prof / max(mass, 1e-12)
    return prof.astype(np.float32), n_taps


def _clip(x, lo, hi):
    """jnp.clip's gradient: maximum then minimum, each splitting the
    gradient evenly at a tie (torch.clamp gives it all to x)."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(hi, torch.maximum(lo, x))


def _euler_rows(rot, tilt, psi, n_rows: int = 2):
    """The first n_rows rows of the ZYZ passive matrix of angle tensors
    (degrees), each a tuple of three tensors of the angles' shape."""
    r, t, p = (torch.deg2rad(a) for a in (rot, tilt, psi))
    c1, s1 = torch.cos(r), torch.sin(r)
    c2, s2 = torch.cos(t), torch.sin(t)
    c3, s3 = torch.cos(p), torch.sin(p)
    rows = [(c3 * c2 * c1 - s3 * s1, c3 * c2 * s1 + s3 * c1, -c3 * s2),
            (-s3 * c2 * c1 - c3 * s1, -s3 * c2 * s1 + c3 * c1, s3 * s2),
            (s2 * c1, s2 * s1, c2)]
    return rows[:n_rows]


def _deformed_rotated(positions, Z, coeffs3, rot, tilt, psi, size: int,
                      n_rows: int):
    """The deformed cloud's image coordinates: g = coeffs3 . Z displaces
    each voxel (coeffs3 (..., 3, K) -> g (..., 3, N)), the pose rows map it
    (angles of shape (..., M) or (...)). Returns ([xi, yi(, zi)] each
    (..., M, N) or (..., N), def2 (...))."""
    with fp32_products():
        g = coeffs3 @ Z                                  # (..., 3, N)
    p = positions.T + g                                  # (..., 3, N)
    multi = rot.dim() > coeffs3.dim() - 2
    if multi:
        p = p.unsqueeze(-3)                              # (..., 1, 3, N)
    rows = _euler_rows(rot, tilt, psi, n_rows)
    c = size // 2
    coords = [row[0][..., None] * p[..., 0, :] + row[1][..., None]
              * p[..., 1, :] + row[2][..., None] * p[..., 2, :] + c
              for row in rows]
    def2 = torch.mean(torch.sum(g * g, dim=-2), dim=-1)
    return coords, def2


def _taps(coords, size: int, blob_profile, n_taps: int,
          samples_per_px: int):
    """The splat's taps of image/volume coordinates (each (..., N)): a
    list of (flat index into the (size,)*dim grid, weight, inside)."""
    dim = len(coords)
    if blob_profile is None or n_taps <= 0:
        lo = [torch.floor(a) for a in coords]
        frac = [a - b for a, b in zip(coords, lo)]
        lo = [b.to(torch.int64) for b in lo]
        offsets = [(0, 1)] * dim
    else:
        lo = [torch.round(a).to(torch.int64) for a in coords]
        offsets = [range(-n_taps, n_taps + 1)] * dim
        T = blob_profile.shape[0]
    out = []
    # the reference's loop order: the last coordinate (x) fastest
    for off in itertools.product(*offsets[::-1]):
        off = off[::-1]                                  # (dx, dy[, dz])
        ii = [b + o for b, o in zip(lo, off)]
        inside = None
        for a in ii:
            ok = (a >= 0) & (a < size)
            inside = ok if inside is None else inside & ok
        if blob_profile is None or n_taps <= 0:
            w = None
            for f, o in zip(frac, off):
                wf = f if o else 1 - f
                w = wf if w is None else w * wf
        else:
            # the reference's sum order: y, x in 2-D; x, y, z in 3-D
            pairs = list(zip(coords, ii))
            d2 = sum((a - b.to(torch.float32)) ** 2
                     for a, b in (pairs[::-1] if dim == 2 else pairs))
            dist = torch.sqrt(d2 + 1e-12)
            # linear interpolation of the footprint table so the position
            # gradient flows through the blob weight
            tf = _clip(dist * samples_per_px, 0.0, T - 1.001)
            ti = tf.to(torch.int64)
            fr = tf - ti.to(torch.float32)
            w = blob_profile[ti] * (1 - fr) + blob_profile[ti + 1] * fr
            inside = inside & (dist < n_taps + 1.0)
        flat = None
        for a in ii[::-1]:                               # z, y, x order
            a = a.clamp(0, size - 1)
            flat = a if flat is None else flat * size + a
        out.append((flat, w, inside))
    return out


def _splat(coords, values, size: int, blob_profile=None, n_taps: int = 0,
           samples_per_px: int = 32):
    """Scatter-add values (N,) at coords (each (..., N)) into (...,
    size^dim) grids; differentiable in the coordinates through the
    weights."""
    dim = len(coords)
    lead = coords[0].shape[:-1]
    n_grids = int(np.prod(lead)) if len(lead) else 1
    cells = size ** dim
    base = (torch.arange(n_grids, device=values.device) * cells).reshape(
        lead + (1,))
    out = torch.zeros(n_grids * cells, dtype=torch.float32,
                      device=values.device)
    for flat, w, inside in _taps(coords, size, blob_profile, n_taps,
                                 samples_per_px):
        src = torch.where(inside, w * values, 0.0)
        out = out.index_add(0, (flat + base).reshape(-1), src.reshape(-1))
    return out.reshape(lead + (size,) * dim)


def forward_splat_project(positions, values, Z, coeffs3, rot, tilt, psi,
                          size: int, blob_profile=None, n_taps: int = 0,
                          samples_per_px: int = 32, device=None):
    """Project the deformed voxel cloud: g = coeffs3 . Z displaces each
    voxel, the pose rows map it to image coords, and the value is splat
    with bilinear weights (differentiable scatter-add), or, when
    blob_profile is given, with the projected KB blob footprint over a
    (2 n_taps + 1)^2 tap window. coeffs3 (3,K) or (B,3,K), angles scalars
    or (B,) / (B,M). Returns ((..., size, size) image, mean squared
    deformation (...))."""
    positions = as_tensor(positions, device)
    dev = positions.device
    values, Z, coeffs3 = (as_tensor(a, dev) for a in (values, Z, coeffs3))
    rot, tilt, psi = (as_tensor(a, dev) for a in (rot, tilt, psi))
    if blob_profile is not None:
        blob_profile = as_tensor(blob_profile, dev)
    coords, def2 = _deformed_rotated(positions, Z, coeffs3, rot, tilt, psi,
                                     size, 2)
    return _splat(coords, values, size, blob_profile, n_taps,
                  samples_per_px), def2


def forward_splat_volume(positions, values, Z, coeffs3, rot, tilt, psi,
                         size: int, blob_profile=None, n_taps: int = 0,
                         samples_per_px: int = 32, device=None):
    """Splat the deformed, rotated voxel cloud into a (size,size,size)
    volume: g = coeffs3 . Z displaces each voxel, the full pose matrix
    maps it, and the value lands with trilinear weights (differentiable),
    or the 3-D KB blob footprint over a (2 n_taps + 1)^3 window. Returns
    ((..., size, size, size) volume, mean squared deformation (...))."""
    positions = as_tensor(positions, device)
    dev = positions.device
    values, Z, coeffs3 = (as_tensor(a, dev) for a in (values, Z, coeffs3))
    rot, tilt, psi = (as_tensor(a, dev) for a in (rot, tilt, psi))
    if blob_profile is not None:
        blob_profile = as_tensor(blob_profile, dev)
    coords, def2 = _deformed_rotated(positions, Z, coeffs3, rot, tilt, psi,
                                     size, 3)
    return _splat(coords, values, size, blob_profile, n_taps,
                  samples_per_px), def2


def _ctf_spec(size: int, defU, defV, ang, ctf_consts,
              phase_flipped: bool):
    """Astigmatic CTF on the rfft grid of (size, size) images from
    (...,) defocus tensors (the parametrization of
    ops.continuous._ctf_rfft). Returns (..., size, size//2+1)."""
    K1, K2, Ksin, Kcos, Ts = ctf_consts
    dev = defU.device
    fy = torch.fft.fftfreq(size, device=dev)[:, None]
    fx = torch.fft.rfftfreq(size, device=dev)[None, :]
    r2 = fx * fx + fy * fy
    u2 = r2 / (Ts * Ts)
    safe = r2.clamp(min=1e-30)
    c2t = (fx * fx - fy * fy) / safe
    s2t = 2 * fx * fy / safe
    e = lambda a: a[..., None, None]
    az = torch.deg2rad(e(ang))
    cos2 = c2t * torch.cos(2 * az) + s2t * torch.sin(2 * az)
    deltaf = -(e(defU) + e(defV)) / 2 + (-(e(defU) - e(defV)) / 2) * cos2
    arg = K1 * deltaf * u2 + K2 * u2 * u2
    ctf = -(Ksin * torch.sin(arg) - Kcos * torch.cos(arg))
    return torch.abs(ctf) if phase_flipped else ctf


def _masked_corr(a, b, w=None, dims=(-2, -1)):
    """Normalized correlation over the last dims, weighted by the mask w
    (the reference's mask2D / Rmax sphere), per leading index."""
    if w is None:
        am = a - a.mean(dim=dims, keepdim=True)
        bm = b - b.mean(dim=dims, keepdim=True)
        return (am * bm).sum(dim=dims) / torch.sqrt(torch.maximum(
            (am * am).sum(dim=dims) * (bm * bm).sum(dim=dims),
            torch.tensor(1e-20, device=a.device)))
    ws = torch.maximum(w.sum(), torch.tensor(1e-20, device=a.device))
    mean = lambda v: ((v * w).sum(dim=dims, keepdim=True) / ws)
    am = a - mean(a)
    bm = b - mean(b)
    return (w * am * bm).sum(dim=dims) / torch.sqrt(torch.maximum(
        (w * am * am).sum(dim=dims) * (w * bm * bm).sum(dim=dims),
        torch.tensor(1e-20, device=a.device)))


def _adam(loss_fn, params, lrs, steps: int, b1=0.9, b2=0.999, eps=1e-8):
    """The reference's hand-written Adam over a list of tensors with
    per-tensor learning rates (scalars or broadcastable tensors), the
    bias corrections in float32 as its scan computes them. loss_fn sums
    the per-particle losses."""
    params = [p.detach().clone() for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    tt = np.arange(1, steps + 1, dtype=np.float32)
    c1 = 1 - np.power(np.float32(b1), tt)
    c2 = 1 - np.power(np.float32(b2), tt)
    for t in range(steps):
        ps = [p.requires_grad_(True) for p in params]
        with torch.enable_grad():
            gs = torch.autograd.grad(loss_fn(*ps), ps)
        params = [p.detach() for p in ps]
        for k, g in enumerate(gs):
            m[k] = b1 * m[k] + (1 - b1) * g
            v[k] = b2 * v[k] + (1 - b2) * g * g
            params[k] = params[k] - lrs[k] * (m[k] / float(c1[t])) / (
                torch.sqrt(v[k] / float(c2[t])) + eps)
    return params


# (K1, K2, Ksin, Kcos, Ts) of no CTF: the model times 1
NO_CTF = (0.0, 0.0, 1.0, 0.0, 1.0)


def fit_forward_zernike_batch(positions, values, Z, imgs, rots, tilts, psis,
                              coeffs0, lam: float, size: int, steps: int,
                              lr: float = 0.5, max_angular: float = 5.0,
                              max_shift: float = 5.0,
                              shifts_x=None, shifts_y=None,
                              blob_profile=None, n_taps: int = 0,
                              use_ctf: bool = False,
                              phase_flipped: bool = False,
                              defU=None, defV=None, defAng=None,
                              ctf_consts=None,
                              opt_align: bool = True,
                              opt_deform: bool = True,
                              opt_defocus: bool = False,
                              img_mask=None, device=None):
    """Per-particle forward-model fit of a batch: Adam over (3, K)
    deformation coefficients + per-image (drot, dtilt, dpsi, dx, dy,
    ddefU, ddefV, ddefAng) deltas minimizing mean_images[-corr(P_m, I_m)]
    + lam sqrt(mean |g|^2), with the --optimize* gates as per-group
    learning rates (0 freezes a group, the reference's parameter-subset
    Powell). Images may carry a multi-image axis (B, M, H, W) for the
    pairs/triplets mode: the coefficients are shared across M, the deltas
    are per image. Returns tensors (coeffs (B,3,K), dpose (B,[M,]8), corr
    (B[,M]), deform (B,))."""
    imgs = as_tensor(imgs, device)
    dev = imgs.device
    t = lambda a: as_tensor(a, dev)
    positions, values, Z = t(positions), t(values), t(Z)
    rots, tilts, psis = t(rots), t(tilts), t(psis)
    ctf_consts = ctf_consts or NO_CTF
    multi = imgs.dim() == 4
    if not multi:
        imgs = imgs[:, None]
        rots, tilts, psis = rots[:, None], tilts[:, None], psis[:, None]
    B, M = imgs.shape[0], imgs.shape[1]

    def opt2(a):
        if a is None:
            return torch.zeros((B, M), device=dev)
        a = t(a)
        return a[:, None] * torch.ones((1, M), device=dev) \
            if a.dim() == 1 else a
    sx0, sy0 = opt2(shifts_x), opt2(shifts_y)
    dU0, dV0, dA0 = opt2(defU), opt2(defV), opt2(defAng)
    if blob_profile is not None:
        blob_profile = t(blob_profile)
    if img_mask is not None:
        img_mask = t(img_mask)

    lr_a = lr if opt_align else 0.0
    lr_d = 30.0 if (opt_defocus and use_ctf) else 0.0
    lr_pose = torch.tensor([lr_a, lr_a, lr_a, lr_a, lr_a, lr_d, lr_d,
                            0.1 * lr_d], dtype=torch.float32, device=dev)
    lr_c = lr if opt_deform else 0.0
    fy = torch.fft.fftfreq(size, device=dev)[:, None]
    fx = torch.fft.rfftfreq(size, device=dev)[None, :]

    def project(c3, dp):
        clip_a = lambda a: _clip(a, -max_angular, max_angular)
        img, def2 = forward_splat_project(
            positions, values, Z, c3, rots + clip_a(dp[..., 0]),
            tilts + clip_a(dp[..., 1]), psis + clip_a(dp[..., 2]), size,
            blob_profile=blob_profile, n_taps=n_taps)
        sx = sx0 + _clip(dp[..., 3], -max_shift, max_shift)
        sy = sy0 + _clip(dp[..., 4], -max_shift, max_shift)
        # shift the projection in Fourier space (differentiable, exact)
        spec = torch.fft.rfft2(img)
        phase = torch.exp(-2j * torch.pi * (fy * sy[..., None, None]
                                             + fx * sx[..., None, None]))
        spec = spec * phase
        if use_ctf:
            spec = spec * _ctf_spec(size, dU0 + dp[..., 5], dV0 + dp[..., 6],
                                    dA0 + dp[..., 7], ctf_consts,
                                    phase_flipped)
        return torch.fft.irfft2(spec, s=(size, size)), def2

    def loss(c3, dpose):
        P, def2 = project(c3, dpose)
        cc = _masked_corr(P, imgs, img_mask)
        return (-cc.mean(dim=1) + lam * torch.sqrt(def2 + 1e-12)).sum()

    c3, dpose = _adam(loss, [t(coeffs0), torch.zeros((B, M, 8),
                                                     device=dev)],
                      [lr_c, lr_pose], steps)
    with torch.no_grad():
        P, def2 = project(c3, dpose)
        cc = _masked_corr(P, imgs, img_mask)
        # report clipped (= applied) deltas
        dpose = dpose.clone()
        dpose[..., 0:3] = dpose[..., 0:3].clamp(-max_angular, max_angular)
        dpose[..., 3:5] = dpose[..., 3:5].clamp(-max_shift, max_shift)
    if not multi:
        dpose, cc = dpose[:, 0], cc[:, 0]
    return c3, dpose, cc, torch.sqrt(def2)


def fit_forward_zernike_subtomos_batch(
        positions, values, Z, subs, rots, tilts, psis, coeffs0,
        lam: float, size: int, steps: int, lr: float = 0.5,
        max_angular: float = 5.0, max_shift: float = 5.0,
        shifts=None, spec_mask=None, vol_mask=None,
        blob_profile=None, n_taps: int = 0,
        use_ctf: bool = False, phase_flipped: bool = False,
        defU=None, defV=None, ctf_consts=None,
        opt_align: bool = True, opt_deform: bool = True,
        opt_defocus: bool = False, device=None):
    """Per-subtomogram forward fit (forward_zernike_subtomos): the deformed
    cloud is splat as a 3-D volume, missing-wedge / low-pass filtered
    (spec_mask on the rfftn grid: the reference's filterMW with
    --t1/--t2), isotropic-CTF-attenuated ((defU+defV)/2 drives a radial
    CTF), shifted in Fourier, and correlated against the subtomogram
    inside vol_mask (the --Rmax sphere). dpose per subtomogram = (drot,
    dtilt, dpsi, dx, dy, dz, ddefU, ddefV). Returns tensors (coeffs
    (B,3,K), dpose (B,8), corr (B,), deform (B,))."""
    subs = as_tensor(subs, device)
    dev = subs.device
    t = lambda a: as_tensor(a, dev)
    positions, values, Z = t(positions), t(values), t(Z)
    rots, tilts, psis = t(rots), t(tilts), t(psis)
    ctf_consts = ctf_consts or NO_CTF
    B = subs.shape[0]
    sh0 = torch.zeros((B, 3), device=dev) if shifts is None else t(shifts)
    dU0 = torch.zeros(B, device=dev) if defU is None else t(defU)
    dV0 = torch.zeros(B, device=dev) if defV is None else t(defV)
    if blob_profile is not None:
        blob_profile = t(blob_profile)
    if spec_mask is not None:
        spec_mask = t(spec_mask)
    if vol_mask is not None:
        vol_mask = t(vol_mask)
    lr_a = lr if opt_align else 0.0
    lr_d = 30.0 if (opt_defocus and use_ctf) else 0.0
    lr_pose = torch.tensor([lr_a] * 6 + [lr_d, lr_d], dtype=torch.float32,
                           device=dev)
    lr_c = lr if opt_deform else 0.0
    fz = torch.fft.fftfreq(size, device=dev)[:, None, None]
    fy = torch.fft.fftfreq(size, device=dev)[None, :, None]
    fx = torch.fft.rfftfreq(size, device=dev)[None, None, :]
    e = lambda a: a[:, None, None, None]
    dims = (-3, -2, -1)

    def project(c3, dp):
        clip_a = lambda a: _clip(a, -max_angular, max_angular)
        v, def2 = forward_splat_volume(
            positions, values, Z, c3, rots + clip_a(dp[:, 0]),
            tilts + clip_a(dp[:, 1]), psis + clip_a(dp[:, 2]), size,
            blob_profile=blob_profile, n_taps=n_taps)
        s = sh0 + _clip(dp[:, 3:6], -max_shift, max_shift)
        spec = torch.fft.rfftn(v, dim=dims)
        spec = spec * torch.exp(-2j * torch.pi * (
            fz * e(s[:, 2]) + fy * e(s[:, 1]) + fx * e(s[:, 0])))
        if spec_mask is not None:
            spec = spec * spec_mask
        if use_ctf:
            K1, K2, Ksin, Kcos, Ts = ctf_consts
            r2 = fx * fx + fy * fy + fz * fz
            u2 = r2 / (Ts * Ts)
            dmean = e((dU0 + dp[:, 6] + dV0 + dp[:, 7]) / 2)
            arg = -K1 * dmean * u2 + K2 * u2 * u2
            ctf = -(Ksin * torch.sin(arg) - Kcos * torch.cos(arg))
            spec = spec * (torch.abs(ctf) if phase_flipped else ctf)
        return torch.fft.irfftn(spec, s=(size, size, size), dim=dims), def2

    w = vol_mask if vol_mask is not None else torch.ones(
        (size,) * 3, device=dev)

    def loss(c3, dp):
        P, def2 = project(c3, dp)
        cc = _masked_corr(P, subs, w, dims)
        return (-cc + lam * torch.sqrt(def2 + 1e-12)).sum()

    c3, dp = _adam(loss, [t(coeffs0), torch.zeros((B, 8), device=dev)],
                   [lr_c, lr_pose], steps)
    with torch.no_grad():
        P, def2 = project(c3, dp)
        cc = _masked_corr(P, subs, w, dims)
        dp = dp.clone()
        dp[:, 0:3] = dp[:, 0:3].clamp(-max_angular, max_angular)
        dp[:, 3:6] = dp[:, 3:6].clamp(-max_shift, max_shift)
    return c3, dp, cc, torch.sqrt(def2)
