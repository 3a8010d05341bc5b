"""ML2D: multi-reference 2-D maximum-likelihood refinement (ml_align2d), and
MLF2D's per-resolution noise model (mlf_align2d).

Counterpart of the reference package's models/ml2d.py (reference
ml_align2d.cpp:700-926, mlf_align2d.h:70). On the ring-weighted polar
annulus the residual of an image against a rotated, shifted reference is
||X_t||^2 + ||R||^2 - 2 <X_t, R(psi)>, and every psi of the cross term
comes from one inverse rFFT of the cross-spectrum
    sum_r f_img[b, r, k] * w[r] * conj(f_ref[R, r, k]),
which is K4 (ops/cross.cross_spectrum, a CUDA kernel on the card) without
the mirror output. The E-step forms the (image, trial, class, psi)
log-posterior of a chunk of ESTEP_CHUNK images at a time, with the class
sums and the top-K poses of each image; the chunks' sums stay on the card
and meet the host once an iteration. The M-step registers every image at
its top-K poses and adds them into the class averages with `index_add_`.

`mesh` (parallel/mesh.Mesh) shards the particle axis over the ranks of a
torch.distributed group: each rank runs the E and M steps on its rows and
the sums meet in one all_reduce, the poses in one all_gather (the
reference's shard_map with one psum, ml2d.py:312-395).

Two faults of the reference are not copied (ROADMAP.md §3 items 9-10): the
mesh path takes the gray-corrected images under --norm, as the serial
path does, and --iem updates the model after every block.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor, resolve_device
from xmipp3_tpu_torch.ops.cross import cross_spectrum
from xmipp3_tpu_torch.ops.dft_mm import irfft_mm_last
from xmipp3_tpu_torch.ops.fourier import fourier_shift_2d
from xmipp3_tpu_torch.ops.geo import (alignment_to_md_pose,
                                      apply_md_geometry, centered_flip)
from xmipp3_tpu_torch.ops.match import _trial_shift_grid
from xmipp3_tpu_torch.ops.polar import cartesian_to_polar, ring_ffts

# images of one E-step chunk: at N=128 (13 trials, 32 classes, 512 angles)
# each (chunk, T, R, A) float32 tensor of the E-step is 0.87 GB
ESTEP_CHUNK = 1024


def _dup(k: int, A: int, device):
    """rfft bin multiplicities (interior bins count twice)."""
    d = torch.full((k,), 2.0, device=device)
    d[0] = 1.0
    if A % 2 == 0:
        d[-1] = 1.0
    return d


def _ring_spectra(imgs, rmin: int, rmax: int):
    """Ring FFTs (B, nr, k) complex64, contiguous, on the default polar
    grid (2^ceil(log2(2 pi rmax)) angles)."""
    return ring_ffts(cartesian_to_polar(imgs, rmin, rmax)).contiguous()


def _weights(f_refs, rmin: int, ring_w):
    """Per-sample area weights w_r = r / A * ring_w (nr,) and the bins'
    multiplicities (k,)."""
    _, nr, k = f_refs.shape
    A = 2 * (k - 1)
    radii = torch.arange(rmin, rmin + nr, dtype=torch.float32,
                         device=f_refs.device)
    w = (radii / A * as_tensor(ring_w, f_refs.device)).contiguous()
    return w, _dup(k, A, f_refs.device)


def _trial_terms(f_refs, imgs, trials, w, dup, rmin: int, rmax: int,
                 cross: bool = True):
    """e_img (B, T) and, with cross=True, the cross-correlation curves
    (B, T, R, A) of images shifted by each trial against the references'
    ring FFTs f_refs, through K4."""
    B = imgs.shape[0]
    R, _, k = f_refs.shape
    A = 2 * (k - 1)
    T = len(trials)
    e_img = torch.empty((B, T), dtype=torch.float32, device=imgs.device)
    out = torch.empty((B, T, R, A), dtype=torch.float32,
                      device=imgs.device) if cross else None
    for ti, (tx, ty) in enumerate(np.asarray(trials, np.float32)):
        f_im = _ring_spectra(fourier_shift_2d(imgs, float(tx), float(ty)),
                             rmin, rmax)
        e_img[:, ti] = torch.einsum("brk,r,k->b", f_im.abs() ** 2, w,
                                    dup) / A
        if cross:
            # irfft's 1/A is the reference's (ml2d.py:83)
            out[:, ti] = irfft_mm_last(cross_spectrum(f_im, f_refs, w), A)
    return e_img, out


def _energy_terms(refs, imgs, trials, ring_w, rmin: int, rmax: int,
                  device=None):
    """Raw weighted polar-annulus energy terms.

    Returns cross (B, T, R, A) = <X_t, R(psi)>, e_img (B, T) = ||X_t||^2,
    e_ref (R,) = ||R||^2, all under ring weights w_r = r / A * ring_w."""
    imgs = as_tensor(imgs, device)
    f_refs = _ring_spectra(as_tensor(refs, imgs.device), rmin, rmax)
    w, dup = _weights(f_refs, rmin, ring_w)
    A = 2 * (f_refs.shape[-1] - 1)
    e_ref = torch.einsum("Rrk,r,k->R", f_refs.abs() ** 2, w, dup) / A
    e_img, cross = _trial_terms(f_refs, imgs, trials, w, dup, rmin, rmax)
    return cross, e_img, e_ref


def _log_const(d_eff: float, s2: float, student_df):
    """The likelihood's normalisation constant per image."""
    if student_df is None:
        return -0.5 * d_eff * math.log(2 * math.pi * s2)
    df = float(student_df)
    return (math.lgamma(0.5 * (df + d_eff)) - math.lgamma(0.5 * df)
            - 0.5 * d_eff * math.log(df * math.pi * s2))


def _e_step(cross, e_img, e_ref, trials, log_alpha, sigma2, sigma_off2,
            d_eff, top_k: int, valid=None, log_psi_mask=None,
            c_sig: float = 0.0, student_df: float | None = None):
    """Exact E-step over (trial, class, psi); Gaussian or student-t.

    Returns the posterior's top-K weights and flat indices per image and
    the SUMMED class masses, posterior moments and data log-likelihood
    (callers divide by the row count; `valid` (B,) zeroes padded rows).
    `log_psi_mask` (A,) restricts the in-plane search (--psi_step /
    --search_rot); `c_sig` zeroes posterior cells below c_sig times the
    image's maximum (the reference -C criterion); with student_df the
    residual sum carries the t-EM weights u."""
    B, T, R, A = cross.shape
    dev = cross.device
    if valid is None:
        valid = torch.ones((B,), dtype=torch.float32, device=dev)
    trials = as_tensor(trials, dev)
    resid2 = (e_img[:, :, None, None] + e_ref[None, None, :, None]
              - 2.0 * cross).clamp_(min=0.0)
    t2 = trials[:, 0] ** 2 + trials[:, 1] ** 2
    log_pt = -t2 / (2.0 * max(float(sigma_off2), 1e-8))
    s2 = max(float(sigma2), 1e-12)
    if student_df is None:
        loge = resid2 * (-1.0 / (2.0 * s2))
        u = None
    else:
        df = float(student_df)
        loge = torch.log1p(resid2 / (df * s2)) * (-0.5 * (df + d_eff))
        u = (df + d_eff) / (df + resid2 / s2)
    loge += log_pt[None, :, None, None]
    loge += as_tensor(log_alpha, dev)[None, None, :, None]
    if log_psi_mask is not None:
        loge += as_tensor(log_psi_mask, dev)[None, None, None, :]
    flat = loge.reshape(B, -1)
    m = flat.max(dim=1, keepdim=True).values
    p = flat.sub_(m).exp_()                 # the image's maximum is 1
    if c_sig > 0:
        p.masked_fill_(p < c_sig, 0.0)
    Z = p.sum(dim=1, keepdim=True)
    post = p.div_(Z).mul_(valid[:, None])
    ll_sum = ((m[:, 0] + torch.log(Z[:, 0])
               + _log_const(d_eff, s2, student_df)) * valid).sum()
    post4 = post.reshape(B, T, R, A)
    resid2_sum = (post4 * (resid2 if u is None else u * resid2)).sum()
    t2_sum = (post4.sum(dim=(0, 2, 3)) * t2).sum()
    frac_sum = post4.sum(dim=(0, 1, 3))
    wk, ik = torch.topk(post, top_k, dim=1)
    wk = wk / wk.sum(dim=1, keepdim=True).clamp(min=1e-12)
    wk = wk * valid[:, None]
    return wk, ik, frac_sum, resid2_sum, t2_sum, ll_sum


def _m_step(imgs, wk, ik, trials, n_refs: int, A: int, mirror: bool = False):
    """Batched top-K warp + class scatter (the weighted class sums).

    With mirror=True the class axis is 2 * n_refs wide: classes >= n_refs
    matched the x-mirrored reference, so the stored pose carries flip=1 and
    the registered image lands in the BASE class accumulator."""
    B, K = wk.shape
    dev = imgs.device
    n_cls = 2 * n_refs if mirror else n_refs
    t_idx = ik // (n_cls * A)
    c_idx = (ik // A) % n_cls
    a_idx = ik % A
    r_idx = (c_idx % n_refs).reshape(-1)
    flip = c_idx >= n_refs
    psi = a_idx.to(torch.float32).reshape(-1) * (360.0 / A)
    psi = torch.where(psi > 180.0, psi - 360.0, psi)
    t = as_tensor(trials, dev)[t_idx.reshape(-1)]           # (B*K, 2)
    rad = torch.deg2rad(psi)
    c, s = torch.cos(rad), torch.sin(rad)
    sx = c * t[:, 0] + s * t[:, 1]
    sy = -s * t[:, 0] + c * t[:, 1]
    psi_md, sx_md, sy_md, _ = alignment_to_md_pose(psi, sx, sy)
    reg = apply_md_geometry(imgs.repeat_interleave(K, dim=0), psi_md, sx_md,
                            sy_md, flip.reshape(-1) if mirror else None)
    wflat = wk.reshape(-1)
    acc = torch.zeros((n_refs,) + tuple(imgs.shape[1:]), dtype=torch.float32,
                      device=dev)
    acc.index_add_(0, r_idx, reg * wflat[:, None, None])
    cnt = torch.zeros((n_refs,), dtype=torch.float32,
                      device=dev).index_add_(0, r_idx, wflat)
    first = lambda v: v.reshape(B, K)[:, 0]
    return (acc, cnt, first(r_idx), first(psi_md), first(sx_md),
            first(sy_md), flip[:, 0])


def _ring_noise_spectra(refs, imgs, best_ref, psi_md, sx_md, sy_md, flip,
                        rmin: int, rmax: int):
    """Per-ring residual noise spectra at the best pose (MLF2D,
    mlf_align2d.h:70): sigma_r^2 = mean ring power of (X_aligned - R)."""
    B = len(imgs)
    total = None
    for s in range(0, B, ESTEP_CHUNK):
        sl = slice(s, s + ESTEP_CHUNK)
        reg = apply_md_geometry(imgs[sl], psi_md[sl], sx_md[sl], sy_md[sl],
                                flip[sl])
        f = _ring_spectra(reg - refs[best_ref[sl]], rmin, rmax)
        k = f.shape[-1]
        part = torch.einsum("brk,k->r", f.abs() ** 2,
                            _dup(k, 2 * (k - 1), f.device))
        total = part if total is None else total + part
    k = f.shape[-1]
    return total / (2 * (k - 1) * B)


def _fit_gray(imgs, refs, best_ref, psi_md, sx_md, sy_md, flip):
    """Per-particle (a, b) gray fit at the best pose (--norm): least squares
    of the registered raw image against its class average."""
    a_parts, b_parts = [], []
    for s in range(0, len(imgs), ESTEP_CHUNK):
        sl = slice(s, s + ESTEP_CHUNK)
        reg = apply_md_geometry(imgs[sl], psi_md[sl], sx_md[sl], sy_md[sl],
                                flip[sl])
        ref = refs[best_ref[sl]]
        my = reg.mean(dim=(1, 2))
        mr = ref.mean(dim=(1, 2))
        dr = ref - mr[:, None, None]
        cov = ((reg - my[:, None, None]) * dr).mean(dim=(1, 2))
        var = (dr * dr).mean(dim=(1, 2))
        a = (cov / var.clamp(min=1e-12)).clamp(0.1, 10.0)
        a_parts.append(a)
        b_parts.append(my - a * mr)
    return torch.cat(a_parts), torch.cat(b_parts)


def _psi_log_mask(A: int, psi_step: float | None, search_rot: float | None):
    """(A,) float32 log-mask over the sampled psi angles (None when it
    keeps all): every round(psi_step / (360 / A))-th angle and |psi| <=
    search_rot."""
    if psi_step is None and (search_rot is None or search_rot >= 180.0):
        return None
    keep = np.ones(A, bool)
    if psi_step is not None:
        stride = max(int(round(psi_step / (360.0 / A))), 1)
        keep &= (np.arange(A) % stride) == 0
    if search_rot is not None and search_rot < 180.0:
        psi = np.arange(A) * (360.0 / A)
        psi = np.where(psi > 180.0, psi - 360.0, psi)
        keep &= np.abs(psi) <= search_rot + 1e-6
    if not keep.any():
        keep[0] = True
    return np.where(keep, 0.0, -np.inf).astype(np.float32)


def _chunked_stats(imgs, valid, f_refs, trials, ring_w, rmin, rmax, model,
                   top_k, n_refs, mirror, psi_mask, c_sig, student_df,
                   chunk):
    """The E and M steps over `imgs` in chunks of `chunk` rows: the summed
    statistics [sums, acc (n_refs, H, W), cnt (n_refs,)], sums being the
    float64 vector (class masses (n_cls,), resid2, t2, ll), and the best
    poses (ref, psi_md, sx_md, sy_md, flip) of every row, all on the
    card."""
    log_alpha, sigma2, sigma_off2, d_eff = model
    w, dup = _weights(f_refs, rmin, ring_w)
    A = 2 * (f_refs.shape[-1] - 1)
    e_ref = torch.einsum("Rrk,r,k->R", f_refs.abs() ** 2, w, dup) / A
    dev = imgs.device
    sums = torch.zeros(len(f_refs) + 3, dtype=torch.float64, device=dev)
    acc = torch.zeros((n_refs,) + tuple(imgs.shape[1:]), dtype=torch.float32,
                      device=dev)
    cnt = torch.zeros((n_refs,), dtype=torch.float32, device=dev)
    poses = []
    for s in range(0, len(imgs), chunk):
        part = imgs[s:s + chunk]
        e_img, cross = _trial_terms(f_refs, part, trials, w, dup, rmin, rmax)
        wk, ik, frac_s, r2_s, t2_s, ll_s = _e_step(
            cross, e_img, e_ref, trials, log_alpha, sigma2, sigma_off2,
            d_eff, top_k, valid=None if valid is None else
            valid[s:s + chunk], log_psi_mask=psi_mask, c_sig=c_sig,
            student_df=student_df)
        del cross, e_img
        a, c, *pose = _m_step(part, wk, ik, trials, n_refs, A, mirror)
        sums += torch.cat([frac_s, torch.stack([r2_s, t2_s, ll_s])]) \
            .to(torch.float64)
        acc += a
        cnt += c
        poses.append(pose)
    return [sums, acc, cnt], [torch.cat(p) for p in zip(*poses)]


def _add_stats(a, b):
    return [x + y for x, y in zip(a, b)]


def ml2d(imgs, n_refs: int, n_iters: int = 15, max_shift: int = 4,
         sigma_init: float | None = None, seed: int = 0, top_k: int = 8,
         verbose: int = 0, fourier_noise_model: bool = False, mesh=None,
         refs_init=None, mirror: bool = False, psi_step: float | None = None,
         search_rot: float | None = None, eps: float = 5e-5,
         offset_sigma: float | None = None, fractions_init=None,
         fix_sigma_noise: bool = False, fix_sigma_offset: bool = False,
         fix_fractions: bool = False, student_df: float | None = None,
         norm: bool = False, c_significance: float = 0.0,
         iem_blocks: int = 1, kstest: bool = False, device=None):
    """Returns dict(refs, fractions, sigma, sigma_offset, assignments, psi,
    sx, sy, flip, gray_a, gray_b, loglike, kstest) as numpy values.

    The reported loglike is the data log-likelihood of the mixture over
    (class, psi, trial) in the ring-weighted polar domain (monotone under
    EM up to the top-K M-step truncation). Runs on `device` (default: the
    card; the mesh's device on a mesh). The E and M steps take
    ESTEP_CHUNK images at a time."""
    from xmipp3_tpu_torch.models.cl2d import initial_references
    if iem_blocks > 1 and mesh is not None:
        raise ValueError("--iem blocks and --mesh are mutually exclusive "
                         "(the mesh already shards the particle axis)")
    dev = mesh.device if mesh is not None else resolve_device(device)
    imgs = as_tensor(imgs, dev)
    B, H, W = imgs.shape
    rmin, rmax = 2, H // 2 - 2
    if refs_init is not None:
        refs = as_tensor(refs_init, dev)
        if refs.ndim == 2:
            refs = refs[None]
        n_refs = len(refs)
    else:
        refs = initial_references(imgs, n_refs, seed)
    if fractions_init is not None:
        alpha = np.maximum(np.asarray(fractions_init, np.float64), 1e-8)
        alpha = alpha / alpha.sum()
        if len(alpha) != n_refs:
            raise ValueError(
                f"--frac has {len(alpha)} fractions for {n_refs} refs")
    else:
        alpha = np.full(n_refs, 1.0 / n_refs)
    trials = _trial_shift_grid(max_shift, step=max(max_shift / 2, 1.0))
    nr = rmax - rmin + 1        # polar_grid rings include rmax
    radii = np.arange(rmin, rmax + 1, dtype=np.float64)
    psi_mask = None
    ring_w = torch.ones((nr,), dtype=torch.float32, device=dev)
    d_eff = float(radii.sum())     # = sum_r w_r * A with w_r = r / A
    sigma2 = None
    sigma_off2 = float(offset_sigma) ** 2 if offset_sigma is not None \
        else max((max_shift / 2.0) ** 2, 1.0)
    ll_hist, ks_hist = [], []
    gray_a = torch.ones(B, device=dev)
    gray_b = torch.zeros(B, device=dev)
    block_slices = [s for s in np.array_split(np.arange(B),
                                              max(int(iem_blocks), 1))
                    if len(s)]
    block_stats = [None] * len(block_slices)
    if mesh is not None:
        from xmipp3_tpu_torch.parallel.mesh import (all_gather, all_reduce,
                                                    shard_rows)
        axis = next(iter(mesh.shape))
        B_pad = -(-B // mesh.shape[axis]) * mesh.shape[axis]
        mine = shard_rows(B_pad, mesh, axis)
        valid = (torch.arange(B_pad, device=dev)[mine] < B).to(torch.float32)

    def class_log_alpha():
        """log-prior per E-step class cell (the mirror halves the mass)."""
        la = np.log(np.maximum(alpha, 1e-8))
        if mirror:
            la = np.concatenate([la, la]) - np.log(2.0)
        return torch.as_tensor(la, dtype=torch.float32, device=dev)

    def aug_refs(r):
        return torch.cat([r, centered_flip(r, -1)]) if mirror else r

    def stats_of(rows, valid_rows=None):
        return _chunked_stats(
            rows, valid_rows, _ring_spectra(aug_refs(refs), rmin, rmax),
            trials, ring_w, rmin, rmax,
            (class_log_alpha(), sigma2, sigma_off2, d_eff), top_k, n_refs,
            mirror, psi_mask, c_significance, student_df, ESTEP_CHUNK)

    def update(total, n_rows):
        """The M-step's model update from summed statistics over n_rows
        images; returns the data log-likelihood per image."""
        nonlocal refs, alpha, sigma2, sigma_off2
        sums, acc, cnt = total
        frac = sums[:-3]
        r2, t2, ll_sum = sums[-3:].tolist()
        refs = torch.where(cnt[:, None, None] > 1e-6,
                           acc / cnt.clamp(min=1e-30)[:, None, None], refs)
        if not fix_fractions:
            frac = frac.cpu().numpy()
            if mirror:      # fold mirrored-class mass into the base class
                frac = frac[:n_refs] + frac[n_refs:]
            alpha = np.maximum(frac / n_rows, 1e-6)
            alpha /= alpha.sum()
        if not fix_sigma_noise:
            sigma2 = r2 / (n_rows * d_eff)
        if not fix_sigma_offset:
            sigma_off2 = max(t2 / (2.0 * n_rows), 0.01)
        return ll_sum / n_rows

    pose = None
    for it in range(n_iters):
        corr = (imgs - gray_b[:, None, None]) / gray_a[:, None, None] \
            if norm else imgs
        if sigma2 is None:
            f_refs = _ring_spectra(aug_refs(refs), rmin, rmax)
            psi_mask = _psi_log_mask(2 * (f_refs.shape[-1] - 1), psi_step,
                                     search_rot)
            if sigma_init is None:
                w, dup = _weights(f_refs, rmin, ring_w)
                e_sum = sum(float(_trial_terms(
                    f_refs, corr[s:s + ESTEP_CHUNK], trials, w, dup, rmin,
                    rmax, cross=False)[0].sum())
                    for s in range(0, B, ESTEP_CHUNK))
                sigma2 = e_sum / (B * len(trials)) / d_eff
            else:
                sigma2 = float(sigma_init ** 2)
        d_eff = float(np.sum(radii * ring_w.cpu().numpy()))
        if mesh is not None:
            rows = torch.cat([corr, corr.new_zeros((B_pad - B, H, W))])
            total, pose = stats_of(rows[mine], valid)
            for t in total:
                all_reduce(t, mesh, axis)
            pose = [all_gather(p, mesh, axis)[:B] for p in pose]
            ll = update(total, B)
        elif len(block_slices) == 1:
            total, pose = stats_of(corr)
            ll = update(total, B)
        else:
            # incremental EM (ml2d.cpp --iem): refresh one block's
            # statistics at a time and update the model from the sum of
            # every block's latest statistics before the next block
            pose = pose if pose is not None else [None] * 5
            for bi, sl in enumerate(block_slices):
                sl_t = torch.as_tensor(sl, device=dev)
                block_stats[bi], p = stats_of(corr[sl_t])
                pose = _scatter_pose(pose, p, sl_t, B)
                have = [s for s in block_stats if s is not None]
                total = have[0]
                for s in have[1:]:
                    total = _add_stats(total, s)
                n_seen = sum(len(block_slices[j]) for j, s in
                             enumerate(block_stats) if s is not None)
                ll = update(total, n_seen)
        ll_hist.append(ll)
        best_ref, psi_md, sx_md, sy_md, flip = pose
        if norm:
            gray_a, gray_b = _fit_gray(imgs, refs, *pose)
        if fourier_noise_model:
            src = (imgs - gray_b[:, None, None]) / gray_a[:, None, None] \
                if norm else imgs
            sig_r = _ring_noise_spectra(refs, src, *pose, rmin, rmax)
            w = 1.0 / torch.maximum(sig_r, 1e-8 * sig_r.max())
            ring_w = w / w.mean()
        if kstest:
            # KS statistic of the whitened best-pose residuals against
            # N(0, 1) (mlf_align2d --kstest)
            from scipy import stats as sps
            reg = apply_md_geometry(imgs, psi_md, sx_md, sy_md, flip)
            resid = (reg - refs[best_ref]).reshape(-1)
            resid = resid / max(float(resid.std(unbiased=False)), 1e-12)
            ks_hist.append(float(sps.kstest(
                resid[:: max(resid.numel() // 20000, 1)].cpu().numpy(),
                "norm").statistic))
        if verbose:
            print(f"  ML2D iter {it + 1}: LL {ll_hist[-1]:.4f} "
                  f"sigma {np.sqrt(sigma2):.5f} "
                  f"fractions {np.round(alpha, 3)}")
        if it > 1 and abs(ll_hist[-1] - ll_hist[-2]) < \
                eps * max(abs(ll_hist[-2]), 1.0):
            break

    best_ref, psi_md, sx_md, sy_md, flip = (p.cpu().numpy() for p in pose)
    return dict(refs=refs.cpu().numpy(), fractions=alpha,
                sigma=float(np.sqrt(sigma2)),
                sigma_offset=float(np.sqrt(sigma_off2)),
                assignments=best_ref, psi=psi_md, sx=sx_md, sy=sy_md,
                flip=flip.astype(int), gray_a=gray_a.cpu().numpy(),
                gray_b=gray_b.cpu().numpy(), loglike=ll_hist,
                kstest=ks_hist)


def _scatter_pose(pose, part, rows, B):
    """The per-row poses of a block written into the (B,) pose tensors
    (made on the first block)."""
    out = []
    for full, p in zip(pose, part):
        if full is None:
            full = torch.zeros((B,), dtype=p.dtype, device=p.device)
        full = full.clone()
        full[rows] = p
        out.append(full)
    return out
