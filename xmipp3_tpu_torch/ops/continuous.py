"""Continuous pose refinement by differentiable projection.

Counterpart of the reference package's ops/continuous.py, which replaces the
reference angular_continuous_assign2 (Powell over pose/defocus/gray via
continuous2cost, angular_continuous_assign2.cpp:522) by batched gradient
descent: the Fourier central-slice projector is differentiable with respect
to the Euler angles, shifts and magnification (a trilinear gather of a fixed
complex cube), so all particles are refined at once.

Here the gradients come from torch.autograd through the port's
extract_central_slices (ops/project.py): the floor indices are detached and
the trilinear weights carry the gradient. The Fourier cube is kept out of the
graph, so the backward pass is elementwise and needs no atomics. The
reference differentiates the MEAN loss and multiplies the gradient by B; the
losses here return the SUM of the per-particle losses, whose gradient is each
particle's own. Each particle's Adam state is its own too, so the particle
set is refined in chunks (`chunk`) with the numbers one batch would give; the
step loop reads nothing back to the host until its chunk is done.

Reference option surface carried here (angular_continuous_assign2.cpp:120-142):
per-parameter trust regions (--max_shift/--max_scale/--max_angular_change/
--max_defocus_change/--max_gray_scale/--max_gray_shift) become projected-
gradient clips after every Adam step; --Rmax is a real-space evaluation mask;
--max_resolution/--sampling set the band limit; --sameDefocus ties the two
defocus deltas; --optimize* gate the per-parameter learning rates.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor
from xmipp3_tpu_torch.ops.fourier import shift_spec_2d
from xmipp3_tpu_torch.ops.project import (extract_central_slices,
                                          prepare_fourier_volume,
                                          slices_to_projections)


def _euler_t(rot, tilt, psi):
    """ZYZ Euler -> (B, 3, 3) matrices of (B,) tensors (degrees),
    differentiable."""
    rot, tilt, psi = (torch.deg2rad(a) for a in (rot, tilt, psi))
    c1, s1 = torch.cos(rot), torch.sin(rot)
    c2, s2 = torch.cos(tilt), torch.sin(tilt)
    c3, s3 = torch.cos(psi), torch.sin(psi)
    row0 = torch.stack([c3 * c2 * c1 - s3 * s1, c3 * c2 * s1 + s3 * c1,
                        -c3 * s2], dim=-1)
    row1 = torch.stack([-s3 * c2 * c1 - c3 * s1, -s3 * c2 * s1 + c3 * c1,
                        s3 * s2], dim=-1)
    row2 = torch.stack([s2 * c1, s2 * s1, c2], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def _project_posed(vf, rot, tilt, psi, sx, sy, N: int, scale=None):
    mats = _euler_t(rot, tilt, psi)
    if scale is not None:
        # magnification: sample the central slice at scaled frequencies
        # (image scale m <-> frequency scale 1/m); differentiable
        mats = mats * scale[:, None, None]
    slices = extract_central_slices(vf, mats, N)
    return slices_to_projections(shift_spec_2d(slices, sx, sy, N, N), N)


def _freq_grid(N: int, device):
    fy = torch.fft.fftfreq(N, device=device)[:, None]
    fx = torch.fft.rfftfreq(N, device=device)[None, :]
    return fx, fy, torch.sqrt(fx * fx + fy * fy)


def _ncc_loss(params, vf, imgs, N: int, max_freq: float = 0.35):
    """Band-limited frequency-weighted NCC: |f|-weighting boosts the
    high-frequency terms that constrain the pose (plain NCC is dominated by
    low frequencies and plateaus), but only up to max_freq — beyond that the
    data is noise-dominated and would corrupt the refinement.

    Returns (sum of -NCC over the particles, NCC (B,))."""
    rot, tilt, psi, sx, sy = params
    proj = _project_posed(vf, rot, tilt, psi, sx, sy, N)
    _, _, r = _freq_grid(N, imgs.device)
    w = torch.where(r <= max_freq, r, 0.0)
    P = torch.fft.rfft2(proj) * w
    I = torch.fft.rfft2(imgs) * w
    num = (P * torch.conj(I)).real.sum(dim=(-2, -1))
    den = torch.sqrt((P.abs() ** 2).sum(dim=(-2, -1))
                     * (I.abs() ** 2).sum(dim=(-2, -1)))
    ncc = num / den.clamp(min=1e-12)
    return -ncc.sum(), ncc


def _dwt2_levels(x, levels: int):
    """Batched 2-D Haar DWT coefficient pyramid: the (lh, hl, hh) bands of
    each level, finest first, then the final ll."""
    from xmipp3_tpu_torch.ops.denoise import _haar_dwt2
    coeffs = []
    cur = x
    for _ in range(levels):
        ll, (lh, hl, hh) = _haar_dwt2(cur)
        coeffs.extend([lh, hl, hh])
        cur = ll
    coeffs.append(cur)
    return coeffs


def _wavelet_loss(params, vf, imgs, N: int, levels: int = 2,
                  spec_w=None, real_w=None):
    """Wavelet-space continuous assignment objective (reference
    angular_continuous_assign.h:39 — the original algorithm matches image
    and projection in DWT space, weighting scales; here: NCC over the
    multi-level Haar coefficient pyramid with the finest detail band
    down-weighted). spec_w/real_w are the reference's --gaussian_Fourier /
    --gaussian_Real / --zerofreq_weight weighting masks, applied
    identically to projection and image.

    Returns (sum of -NCC over the particles, NCC (B,))."""
    rot, tilt, psi, sx, sy = params
    proj = _project_posed(vf, rot, tilt, psi, sx, sy, N)
    if spec_w is not None:
        proj = torch.fft.irfft2(torch.fft.rfft2(proj) * spec_w, s=(N, N))
        imgs = torch.fft.irfft2(torch.fft.rfft2(imgs) * spec_w, s=(N, N))
    if real_w is not None:
        proj = proj * real_w
        imgs = imgs * real_w
    cp = _dwt2_levels(proj, levels)
    ci = _dwt2_levels(imgs, levels)
    # weights: finest-level details (first 3 arrays) get 0.25; all other
    # bands weight 1 (multiscale emphasis on stable coefficients)
    num = pp = ii = 0.0
    for k, (a, b) in enumerate(zip(cp, ci)):
        w = 0.25 if k < 3 else 1.0
        num = num + w * (a * b).sum(dim=(-2, -1))
        pp = pp + w * (a * a).sum(dim=(-2, -1))
        ii = ii + w * (b * b).sum(dim=(-2, -1))
    ncc = num / torch.sqrt(pp * ii).clamp(min=1e-12)
    return -ncc.sum(), ncc


def _ctf_rfft(r, fx, fy, defU, defV, ang, ctf_consts, phase_flipped: bool):
    """Astigmatic CTF on the rfft grid from per-particle defocus."""
    K1, K2, Ksin, Kcos, Ts = ctf_consts
    u2 = (r / Ts) ** 2
    safe = (fx * fx + fy * fy).clamp(min=1e-30)
    c2t = (fx * fx - fy * fy) / safe
    s2t = 2 * fx * fy / safe
    az = torch.deg2rad(ang)[:, None, None]
    cos2 = c2t * torch.cos(2 * az) + s2t * torch.sin(2 * az)
    dU = defU[:, None, None]
    dV = defV[:, None, None]
    deltaf = -(dU + dV) / 2 + (-(dU - dV) / 2) * cos2
    arg = K1 * deltaf * u2 + K2 * (u2 ** 2)
    ctf = -(Ksin * torch.sin(arg) - Kcos * torch.cos(arg))
    if phase_flipped:
        ctf = torch.abs(ctf)
    return ctf


def _model_full(params, vf, ctf_pp, ctf_consts, N: int,
                max_freq: float, use_ctf: bool, phase_flipped: bool,
                same_defocus: bool):
    """Forward model a·CTF(P(pose, scale)) + b, band-limited to max_freq,
    in real space."""
    rot, tilt, psi, sx, sy, scale, a, b, ddefU, ddefV = params
    proj = _project_posed(vf, rot, tilt, psi, sx, sy, N, scale=scale)
    fx, fy, r = _freq_grid(N, proj.device)
    w = torch.where(r <= max_freq, 1.0, 0.0)
    P = torch.fft.rfft2(proj) * w
    if use_ctf:
        defU0, defV0, ang = ctf_pp
        if same_defocus:
            ddefV = ddefU
        P = P * _ctf_rfft(r, fx, fy, defU0 + ddefU, defV0 + ddefV, ang,
                          ctf_consts, phase_flipped)
    Pr = torch.fft.irfft2(P, s=(N, N))
    return a[:, None, None] * Pr + b[:, None, None]


def _l2_loss_full(params, vf, imgs_f, mask, ctf_pp, ctf_consts, N: int,
                  max_freq: float = 0.35, use_ctf: bool = False,
                  phase_flipped: bool = False, same_defocus: bool = False):
    """Masked, band-limited L2 with gray transform, magnification and
    per-particle CTF (reference continuous2cost: the full objective,
    angular_continuous_assign2.cpp:522 — pose + scale + gray a,b +
    defocus, evaluated inside the --Rmax mask).

    params = (rot, tilt, psi, sx, sy, scale, a, b, ddefU, ddefV);
    imgs_f = images pre-filtered to max_freq; mask = (N,N) real-space
    evaluation mask. Returns (sum of the per-particle costs, -cost (B,))."""
    model = _model_full(params, vf, ctf_pp, ctf_consts, N, max_freq,
                        use_ctf, phase_flipped, same_defocus)
    resid = (model - imgs_f) * mask
    norm = ((imgs_f * mask) ** 2).sum(dim=(-2, -1))
    cost = (resid ** 2).sum(dim=(-2, -1)) / norm.clamp(min=1e-12)
    return cost.sum(), -cost


_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _adam_step(params, m, v, grads, lrs, t: int, lo=None, hi=None):
    """One per-particle Adam update on stacked (K, B) parameters, with
    optional trust-region projection (the reference max_* bounds).
    `grads` is (K, B), each particle's own gradient."""
    m = _B1 * m + (1 - _B1) * grads
    v = _B2 * v + (1 - _B2) * grads * grads
    # the bias corrections in float32, as the reference's scan computes them
    mh = m / float(1 - np.float32(_B1) ** t)
    vh = v / float(1 - np.float32(_B2) ** t)
    params = params - lrs[:, None] * mh / (torch.sqrt(vh) + _EPS)
    if lo is not None:
        params = torch.maximum(torch.minimum(params, hi), lo)
    return params, m, v


def _adam_run(loss_fn, p0, lrs, n_steps: int, lo=None, hi=None):
    """n_steps of Adam on p0 (K, B) under loss_fn(tuple of K (B,) tensors)
    -> (summed loss, per-particle value). Returns (params, the first
    step's values, the last step's values); nothing is read back to the
    host inside the loop."""
    params = p0
    m = torch.zeros_like(p0)
    v = torch.zeros_like(p0)
    first = last = None
    for t in range(1, n_steps + 1):
        p = params.detach().requires_grad_(True)
        with torch.enable_grad():
            loss, value = loss_fn(tuple(p.unbind(0)))
            (g,) = torch.autograd.grad(loss, p)
        with torch.no_grad():
            params, m, v = _adam_step(p.detach(), m, v, g, lrs, t, lo, hi)
        value = value.detach()
        first = value if first is None else first
        last = value
    return params, first, last


def _chunk_size(N: int, chunk: int | None) -> int:
    """Particles a chunk of the refinement takes: about 4 MB of autograd
    state a particle at N=128, so 1,024 particles hold about 4 GB."""
    if chunk is not None and chunk > 0:
        return int(chunk)
    return max(1, (1 << 23) // (N * (N // 2 + 1)))


def _radial_mask(N: int, Rmax: float | None, device):
    if Rmax is None or Rmax <= 0:
        return torch.ones((N, N), device=device)
    yy, xx = np.mgrid[:N, :N]
    r = np.hypot(yy - N // 2, xx - N // 2)
    return torch.as_tensor((r <= Rmax).astype(np.float32), device=device)


def _host(t):
    return t.detach().cpu().numpy()


def continuous_assign_full(vol, imgs, rot0, tilt0, psi0, sx0=None, sy0=None,
                           defU0=None, defV0=None, def_ang=None,
                           voltage=300.0, Cs=2.7, Q0=0.07, Ts=1.0,
                           optimize_gray=False, optimize_defocus=False,
                           optimize_angles=True, optimize_shift=True,
                           optimize_scale=False, phase_flipped=False,
                           same_defocus=False, n_steps: int = 80,
                           pad_factor: float = 2.0, max_freq: float = 0.35,
                           Rmax: float | None = None,
                           max_angular_change: float | None = None,
                           max_shift: float | None = None,
                           max_scale: float | None = None,
                           max_defocus_change: float | None = None,
                           max_gray_scale: float | None = None,
                           max_gray_shift: float | None = None,
                           compute_outputs: bool = False,
                           verbose: int = 0, device=None,
                           chunk: int | None = None):
    """Full continuous refinement: pose + optional scale, gray (a, b) and
    per-particle defocus (reference angular_continuous_assign2
    --optimize* family), with the reference's per-parameter trust regions
    and --Rmax evaluation mask. Returns a dict of host arrays: refined
    pose, scale, gray a/b, defocusU/V, the per-particle cost (negated
    residual ratio) at the last step and at the first (`cost_first`); with
    compute_outputs=True also the final model projections and residuals
    (--oprojections / --oresiduals). `imgs` (B, N, N) and `vol` go to
    `device` (the card by default for host arrays)."""
    imgs = as_tensor(imgs, device)
    dev = imgs.device
    B, N, _ = imgs.shape
    vf, _pad = prepare_fourier_volume(as_tensor(vol, dev), pad_factor)
    use_ctf = defU0 is not None
    z = np.zeros(B, np.float32)
    defU0 = z if defU0 is None else np.asarray(defU0, np.float32)
    defV0 = defU0 if defV0 is None else np.asarray(defV0, np.float32)
    def_ang = z if def_ang is None else np.asarray(def_ang, np.float32)
    lam = 12.2643247 / np.sqrt(voltage * 1e3
                               * (1 + 0.978466e-6 * voltage * 1e3))
    ctf_consts = (float(np.pi * lam), float(np.pi / 2 * Cs * 1e7 * lam ** 3),
                  float(np.sqrt(max(1 - Q0 ** 2, 0.0))), float(Q0),
                  float(Ts))
    p_init = [np.asarray(rot0, np.float32),
              np.asarray(tilt0, np.float32),
              np.asarray(psi0, np.float32),
              z if sx0 is None else -np.asarray(sx0, np.float32),
              z if sy0 is None else -np.asarray(sy0, np.float32),
              np.ones(B, np.float32),                # scale
              np.ones(B, np.float32),                # gray a
              z, z, z]                               # gray b, ddefU, ddefV
    p0 = np.stack(p_init)
    lr_ang = 0.5 if optimize_angles else 0.0
    lr_sh = 0.2 if optimize_shift else 0.0
    lr_def = 30.0 if optimize_defocus and use_ctf else 0.0
    lr_gray = 0.02 if optimize_gray else 0.0
    lrs = torch.tensor([lr_ang, lr_ang, lr_ang, lr_sh, lr_sh,
                        0.002 if optimize_scale else 0.0, lr_gray, lr_gray,
                        lr_def, lr_def], dtype=torch.float32, device=dev)
    # trust region (reference max_* bounds): clip around the init values
    BIG = 1e30
    img_std = _host(imgs.std(dim=(1, 2), correction=0))
    lo = np.full((10, B), -BIG, np.float32)
    hi = np.full((10, B), BIG, np.float32)
    if max_angular_change is not None and max_angular_change >= 0:
        for k in range(3):
            lo[k] = p_init[k] - max_angular_change
            hi[k] = p_init[k] + max_angular_change
    if max_shift is not None and max_shift >= 0:
        for k in (3, 4):
            lo[k], hi[k] = -max_shift, max_shift
    if max_scale is not None and max_scale >= 0:
        lo[5], hi[5] = 1.0 - max_scale, 1.0 + max_scale
    if max_gray_scale is not None and max_gray_scale >= 0:
        lo[6], hi[6] = 1.0 - max_gray_scale, 1.0 + max_gray_scale
    if max_gray_shift is not None and max_gray_shift >= 0:
        lo[7] = -max_gray_shift * img_std
        hi[7] = max_gray_shift * img_std
    if max_defocus_change is not None and max_defocus_change >= 0:
        for k in (8, 9):
            lo[k], hi[k] = -max_defocus_change, max_defocus_change
    mask = _radial_mask(N, Rmax, dev)
    _, _, r = _freq_grid(N, dev)
    band = torch.where(r <= max_freq, 1.0, 0.0)
    args = (N, float(max_freq), use_ctf, bool(phase_flipped),
            bool(same_defocus))
    step = _chunk_size(N, chunk)
    outs = []
    for s in range(0, B, step):
        sl = slice(s, min(s + step, B))
        on = lambda a: torch.as_tensor(np.ascontiguousarray(a[..., sl]),
                                       device=dev)
        imgs_f = torch.fft.irfft2(torch.fft.rfft2(imgs[sl]) * band,
                                  s=(N, N))
        defs = (on(defU0), on(defV0), on(def_ang))
        p, first, last = _adam_run(
            lambda q: _l2_loss_full(q, vf, imgs_f, mask, defs, ctf_consts,
                                    *args),
            on(p0), lrs, int(n_steps), on(lo), on(hi))
        o = {"p": p, "cost": last, "cost_first": first}
        if compute_outputs:
            with torch.no_grad():
                model = _model_full(tuple(p.unbind(0)), vf, defs,
                                    ctf_consts, *args)
                o["projections"] = _host(model)
                o["residuals"] = _host((imgs_f - model) * mask)
        outs.append({k: _host(v) if torch.is_tensor(v) else v
                     for k, v in o.items()})
    p = np.concatenate([o["p"] for o in outs], axis=1)
    cost = np.concatenate([o["cost"] for o in outs])
    if verbose:
        print(f"  continuous-full refine ({n_steps} steps): mean cost "
              f"{float(-cost.mean()):.5f}")
    rot, tilt, psi, sx, sy, sc, a, bb, ddU, ddV = p
    if same_defocus:
        ddV = ddU
    out = dict(rot=rot, tilt=tilt, psi=psi, sx=-sx, sy=-sy, scale=sc,
               grayA=a, grayB=bb, defocusU=defU0 + ddU,
               defocusV=defV0 + ddV, cost=cost,
               cost_first=np.concatenate([o["cost_first"] for o in outs]))
    if compute_outputs:
        for k in ("projections", "residuals"):
            out[k] = np.concatenate([o[k] for o in outs])
    return out


def _weight_masks(N: int, gaussian_fourier, gaussian_real, zerofreq_weight,
                  device):
    """The weighting masks of the ORIGINAL continuous assign (reference
    angular_continuous_assign.cpp:104-112: Gaussian weights in Fourier and
    real space + a zero-frequency weight); None where not asked for."""
    spec_w = real_w = None
    if gaussian_fourier is not None or zerofreq_weight is not None:
        fy = np.fft.fftfreq(N)[:, None]
        fx = np.fft.rfftfreq(N)[None, :]
        f2 = fy * fy + fx * fx
        sF = gaussian_fourier if gaussian_fourier is not None else 0.5
        w = np.exp(-f2 / (2 * sF * sF))
        if zerofreq_weight is not None:
            w[0, 0] = zerofreq_weight
        spec_w = torch.as_tensor(w.astype(np.float32), device=device)
    if gaussian_real is not None:
        yy, xx = np.mgrid[0:N, 0:N].astype(np.float32) - N // 2
        sR = gaussian_real * N
        real_w = torch.as_tensor(np.exp(-(yy * yy + xx * xx)
                                        / (2 * sR * sR)).astype(np.float32),
                                 device=device)
    return spec_w, real_w


def continuous_assign(vol, imgs, rot0, tilt0, psi0, sx0=None, sy0=None,
                      n_steps: int = 60, lr_angles: float = 0.5,
                      lr_shifts: float = 0.2, pad_factor: float = 2.0,
                      max_freq: float = 0.35, verbose: int = 0,
                      domain: str = "fourier",
                      max_angular_change: float | None = None,
                      max_shift: float | None = None,
                      gaussian_fourier: float | None = None,
                      gaussian_real: float | None = None,
                      zerofreq_weight: float | None = None,
                      device=None, chunk: int | None = None):
    """Refine poses continuously. Returns a dict of host arrays (rot, tilt,
    psi, sx, sy, cost = the per-particle NCC at the last step, cost_first =
    at the first).

    sx0/sy0 and the returned sx/sy follow the METADATA shift convention
    (shift(img, s) = proj(pose)); internally the projector applies -s.
    Optimization: per-particle Adam on band-limited frequency-weighted NCC
    (domain "fourier") or on the Haar pyramid (domain "wavelet"), over the
    particle set in chunks."""
    imgs = as_tensor(imgs, device)
    dev = imgs.device
    B, N, _ = imgs.shape
    vf, _pad = prepare_fourier_volume(as_tensor(vol, dev), pad_factor)
    z = np.zeros(B, np.float32)
    p_init = [np.asarray(rot0, np.float32),
              np.asarray(tilt0, np.float32),
              np.asarray(psi0, np.float32),
              z if sx0 is None else -np.asarray(sx0, np.float32),
              z if sy0 is None else -np.asarray(sy0, np.float32)]
    p0 = np.stack(p_init)
    lrs = torch.tensor([lr_angles, lr_angles, lr_angles, lr_shifts,
                        lr_shifts], dtype=torch.float32, device=dev)
    BIG = 1e30
    lo = np.full((5, B), -BIG, np.float32)
    hi = np.full((5, B), BIG, np.float32)
    if max_angular_change is not None and max_angular_change >= 0:
        for k in range(3):
            lo[k] = p_init[k] - max_angular_change
            hi[k] = p_init[k] + max_angular_change
    if max_shift is not None and max_shift >= 0:
        lo[3] = lo[4] = -max_shift
        hi[3] = hi[4] = max_shift
    spec_w, real_w = _weight_masks(N, gaussian_fourier, gaussian_real,
                                   zerofreq_weight, dev)
    step = _chunk_size(N, chunk)
    ps, firsts, lasts = [], [], []
    for s in range(0, B, step):
        sl = slice(s, min(s + step, B))
        on = lambda a: torch.as_tensor(np.ascontiguousarray(a[..., sl]),
                                       device=dev)
        x = imgs[sl]
        if domain == "wavelet":
            loss = lambda q: _wavelet_loss(q, vf, x, N, 2, spec_w, real_w)
        else:
            loss = lambda q: _ncc_loss(q, vf, x, N, float(max_freq))
        p, first, last = _adam_run(loss, on(p0), lrs, int(n_steps), on(lo),
                                   on(hi))
        ps.append(_host(p))
        firsts.append(_host(first))
        lasts.append(_host(last))
    rot, tilt, psi, sx, sy = np.concatenate(ps, axis=1)
    ncc = np.concatenate(lasts)
    if verbose:
        print(f"  continuous refine ({n_steps} steps): mean wNCC "
              f"{float(ncc.mean()):.4f}")
    return dict(rot=rot, tilt=tilt, psi=psi, sx=-sx, sy=-sy, cost=ncc,
                cost_first=np.concatenate(firsts))
