"""Gallery matching: batched multireference rotational correlation + shift
refinement — the projection-matching inner loop.

Counterpart of the reference package's ops/match.py: each particle batch
correlates against ALL references at every trial translation as one
contraction over the rings, per angular frequency — K4, ops/cross.py, a
hand-written CUDA kernel on the card — followed by a batched inverse rFFT
and an argmax. Mirrors come free as conjugate ring-FFTs. Shift is then
refined only for the winning reference.

The (B, R, k) spectra and (B, R, A) curves of one trial are some hundreds of
MB at full width; they are released at the end of each trial, so that the
caching allocator hands the same blocks to the next trial of the batch.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import as_tensor
from xmipp3_tpu_torch.ops.cross import cross_spectrum
from xmipp3_tpu_torch.ops.dft_mm import irfft_mm_last
from xmipp3_tpu_torch.ops.geo import alignment_to_md_pose, centered_flip
from xmipp3_tpu_torch.ops.polar import (cartesian_to_polar,
                                        polar_at_static_offsets, ring_ffts)
from xmipp3_tpu_torch.ops.shear_rotate import (rotate_shift_fourier,
                                               translate_fourier)
from xmipp3_tpu_torch.ops.shift import (_parabola_peak_1d,
                                        best_shift_from_spectra,
                                        correlation_index, rfft2_any)


def _ring_weights(nr: int, radius_min: int, device):
    radii = torch.arange(radius_min, radius_min + nr, dtype=torch.float32,
                         device=device)
    return radii / radii.sum()


def _masked_spectra(f_refs, f_imgs, w):
    """Both ring-FFT sets with the k=0 bin (per-ring mean) zeroed, so that a
    flat background does not dominate, and the normalization (B, R) that
    turns cross-spectra into correlation coefficients: the ring energies,
    interior rfft bins counted twice (conjugate half)."""
    k = f_refs.shape[-1]
    A = 2 * (k - 1)
    fi = f_imgs.to(torch.complex64).clone()
    fr = f_refs.to(torch.complex64).clone()
    fi[..., 0] = 0
    fr[..., 0] = 0
    dup = torch.full((k,), 2.0, device=fi.device)
    dup[0] = 1.0
    dup[-1] = 1.0 if A % 2 == 0 else 2.0
    e_img = torch.einsum("brk,r,k->b", fi.abs() ** 2, w, dup)
    e_ref = torch.einsum("Rrk,r,k->R", fr.abs() ** 2, w, dup)
    norm = torch.sqrt((e_img[:, None] * e_ref[None, :]).clamp(min=1e-20))
    return fi, fr, norm


def rotational_corr_matrix(f_refs, f_imgs, radius_min: int = 2,
                           ring_weights=None):
    """All-pairs angular correlation curves.

    f_refs (R, nr, k), f_imgs (B, nr, k) complex ring FFTs ->
    (B, R, A) correlation curves (A = 2*(k-1)). Optional ring_weights (nr,)
    multiply the default radius weighting (the per-resolution noise model
    hook)."""
    R, nr, k = f_refs.shape
    A = 2 * (k - 1)
    w = _ring_weights(nr, radius_min, f_refs.device)
    if ring_weights is not None:
        w = w * as_tensor(ring_weights, w.device)
        w = w / w.sum().clamp(min=1e-12)
    fi, fr, norm = _masked_spectra(f_refs, f_imgs, w)
    cross = cross_spectrum(fi, fr, w.contiguous())
    corr = irfft_mm_last(cross, A) * A
    return corr / norm[:, :, None]


def best_rotation_matrix(f_refs, f_imgs, radius_min: int = 2,
                         psi_allow=None):
    """Best psi + peak for every (image, ref) pair, straight and mirrored.

    Mirroring an image about x reverses its polar angle axis; the ring FFT of
    the mirrored image is the conjugate of the original's (up to angle
    reversal), so mirror correlations reuse the same gallery FFTs, and both
    cross-spectra come out of one launch of K4 (ops/cross.py).

    psi_allow (B, A') optionally restricts the searched in-plane angles
    per image: masked angles score -1e30. A mask on another angular grid
    than this function's A = 2*(k-1) is resampled (nearest angle).

    Returns (psi (B,R), peak (B,R), psi_m (B,R), peak_m (B,R))."""
    R, nr, k = f_refs.shape
    A = 2 * (k - 1)
    dev = f_refs.device
    w = _ring_weights(nr, radius_min, dev)
    fi, fr, norm = _masked_spectra(f_refs, f_imgs, w)
    cross, cross_m = cross_spectrum(fi, fr, w, mirror=True)

    if psi_allow is not None and psi_allow.shape[-1] != A:
        src = np.round(np.arange(A) * (psi_allow.shape[-1] / A)) \
            .astype(np.int64) % psi_allow.shape[-1]
        psi_allow = psi_allow[:, torch.as_tensor(src, device=dev)]

    def peaks(spec):
        # the inverse rFFT of the Hermitian spectrum; its 1/A and the
        # normalization are applied to the three samples the parabola
        # needs, not to the whole (B, R, A) curve
        with timed_phase("match.peaks"):
            corr = irfft_mm_last(spec, A)
            scale = A / norm
            if psi_allow is not None:
                # large finite negative (not -inf): the winner's parabola
                # neighbors may be masked and -inf arithmetic would NaN psi
                corr = torch.where(psi_allow[:, None, :] > 0,
                                   corr * scale[:, :, None], -1e30)
                scale = 1.0
            idx = corr.argmax(dim=-1, keepdim=True)
            y0 = corr.gather(-1, idx)[..., 0] * scale
            ym1 = corr.gather(-1, (idx - 1) % A)[..., 0] * scale
            yp1 = corr.gather(-1, (idx + 1) % A)[..., 0] * scale
            off = _parabola_peak_1d(ym1, y0, yp1)
            ang = (idx[..., 0].to(torch.float32) + off) * (360.0 / A)
            ang = torch.where(ang > 180.0, ang - 360.0, ang)
            return ang, y0

    psi, peak = peaks(cross)
    del cross
    psi_m, peak_m = peaks(cross_m)
    return psi, peak, psi_m, peak_m


def _trial_shift_grid(max_shift: int, step: float | None = None):
    """Coarse translation search grid (reference search5d itrans loop,
    angular_projection_matching.cpp:570-584)."""
    if max_shift <= 0:
        return np.zeros((1, 2), np.float32)
    if step is None:
        step = max(max_shift / 2.0, 1.0)
    v = np.arange(-max_shift, max_shift + 1e-6, step, dtype=np.float32)
    tx, ty = np.meshgrid(v, v)
    pts = np.stack([tx.ravel(), ty.ravel()], axis=1)
    keep = np.linalg.norm(pts, axis=1) <= max_shift + 1e-6
    return pts[keep].astype(np.float32)


def _trial_spectra(refs, imgs, trials, radius_min, radius_max, stride,
                   n_harmonics):
    """Ring FFTs of the gallery (R, nr, k) and of every image at every
    trial translation (T, B, nr, k), truncated to n_harmonics bins."""
    n_ang = 2 * n_harmonics
    f_refs = ring_ffts(cartesian_to_polar(
        refs, radius_min, radius_max, n_angles=n_ang,
        stride=stride))[..., :n_harmonics].contiguous()
    pol = polar_at_static_offsets(imgs, trials, radius_min, radius_max,
                                  n_angles=n_ang, stride=stride)  # (B,T,R,A)
    f_all = ring_ffts(pol)[..., :n_harmonics]                     # (B,T,R,k)
    return f_refs, f_all.movedim(1, 0)


def _trial_best(f_refs, f_im, radius_min, check_mirror, psi_allow):
    """Per (image, ref) of one trial: the better of the straight and the
    mirrored match (peak, psi, flip)."""
    psi, peak, psi_m, peak_m = best_rotation_matrix(
        f_refs, f_im.contiguous(), radius_min, psi_allow)
    if not check_mirror:
        return peak, psi, torch.zeros_like(peak, dtype=torch.bool)
    use_m = peak_m > peak
    return (torch.where(use_m, peak_m, peak), torch.where(use_m, psi_m, psi),
            use_m)


def _scan_trials(refs, imgs, trials, radius_min: int, radius_max: int,
                 check_mirror: bool, stride: int = 2, n_harmonics: int = 64,
                 psi_allow=None):
    """Rotational matching over a static trial-translation grid.

    Every (trial, ring, angle) sample of every image comes from one gather
    on static grids (the trial shifts are baked into the polar grids — no
    per-trial Fourier shifts), every stride-th ring, angular sampling at the
    Nyquist rate of the kept n_harmonics (~2.9 deg coarse psi at the default
    64; the winner refinement restores full psi precision). The first trial
    wins ties. Returns per-image best (peak, psi, ref, trial_idx, flip)."""
    B = imgs.shape[0]
    dev = imgs.device
    f_refs, f_all = _trial_spectra(refs, imgs, trials, radius_min,
                                   radius_max, stride, n_harmonics)
    best_peak = torch.full((B,), -torch.inf, device=dev)
    best_psi = torch.zeros(B, device=dev)
    best_ref = torch.zeros(B, dtype=torch.int64, device=dev)
    best_trial = torch.zeros(B, dtype=torch.int64, device=dev)
    best_flip = torch.zeros(B, dtype=torch.bool, device=dev)
    for ti, f_im in enumerate(f_all):
        peak_t, psi_t, use_m = _trial_best(f_refs, f_im, radius_min,
                                           check_mirror, psi_allow)
        pk, ref_t = peak_t.max(dim=1)
        pick = ref_t[:, None]
        better = pk > best_peak
        best_peak = torch.where(better, pk, best_peak)
        best_psi = torch.where(better, psi_t.gather(1, pick)[:, 0], best_psi)
        best_ref = torch.where(better, ref_t, best_ref)
        best_trial = torch.where(better, ti, best_trial)
        best_flip = torch.where(better, use_m.gather(1, pick)[:, 0],
                                best_flip)
    return best_peak, best_psi, best_ref, best_trial, best_flip


def _scan_trials_full(refs, imgs, trials, radius_min: int, radius_max: int,
                      check_mirror: bool, stride: int = 2,
                      n_harmonics: int = 64, psi_allow=None):
    """Like _scan_trials but keeps the FULL (B, R) best-over-trials score
    matrix (per-pair best psi/trial/flip) — the basis of top-N orientation
    tracking and of significance weights."""
    B, R = imgs.shape[0], refs.shape[0]
    dev = imgs.device
    f_refs, f_all = _trial_spectra(refs, imgs, trials, radius_min,
                                   radius_max, stride, n_harmonics)
    bpeak = torch.full((B, R), -torch.inf, device=dev)
    bpsi = torch.zeros((B, R), device=dev)
    btrial = torch.zeros((B, R), dtype=torch.int64, device=dev)
    bflip = torch.zeros((B, R), dtype=torch.bool, device=dev)
    for ti, f_im in enumerate(f_all):
        peak_t, psi_t, use_m = _trial_best(f_refs, f_im, radius_min,
                                           check_mirror, psi_allow)
        better = peak_t > bpeak
        bpeak = torch.where(better, peak_t, bpeak)
        bpsi = torch.where(better, psi_t, bpsi)
        btrial = torch.where(better, ti, btrial)
        bflip = torch.where(better, use_m, bflip)
    return bpeak, bpsi, btrial, bflip


def refine_winners(refs, imgs, best_ref, psi0, t, flip, max_shift: int,
                   radius_min: int, radius_max: int, refine_iters: int = 2):
    """Refine the coarse winners (shift + psi) and convert to the metadata
    pose convention. t: (B,2) coarse trial translations."""
    B, H, W = imgs.shape
    chosen_refs = refs[best_ref]                             # (B,H,W)

    # Mirror convention: conj ring-FFT correlation corresponds to the
    # y-flipped image (polar angle reversal θ -> -θ); y-flipping T(t)·img
    # gives T(tx,-ty)·yflip(img). The flip must be about the exact center
    # (ops.geo.centered_flip) or a 1 px ghost shift leaks into the pose.
    work = torch.where(flip[:, None, None], centered_flip(imgs, 1), imgs)
    tx = t[:, 0]
    ty = torch.where(flip, -t[:, 1], t[:, 1])

    # initial pose: R(psi)·T(t) == T(R(psi) t)·R(psi)
    rad = torch.deg2rad(psi0)
    c, s = torch.cos(rad), torch.sin(rad)
    sx = c * tx + s * ty
    sy = -s * tx + c * ty
    psi_cur = psi0

    # refinement ring FFTs use every second ring as the scan does: the
    # parabolic peak keeps sub-degree psi
    f_chosen = ring_ffts(cartesian_to_polar(chosen_refs, radius_min,
                                            radius_max, stride=2))
    nr = f_chosen.shape[1]
    A = 2 * (f_chosen.shape[2] - 1)
    rw = _ring_weights(nr, radius_min, imgs.device)

    # the chosen-reference shift spectrum is fixed across iterations
    F_chosen = rfft2_any(chosen_refs)

    for _ in range(refine_iters):
        aligned = rotate_shift_fourier(work, psi_cur, sx, sy)
        # Jacobi update: dpsi and (dsx, dsy) are both measured on this SAME
        # warp; the final half-step below restores the last shift
        dsx, dsy, _ = best_shift_from_spectra(F_chosen, rfft2_any(aligned),
                                              max_shift=max_shift, W=W)
        f_al = ring_ffts(cartesian_to_polar(aligned, radius_min, radius_max,
                                            stride=2))
        # pairwise angular correlation vs the chosen reference
        cross = (f_al * f_chosen.conj() * rw[None, :, None]).sum(dim=1)
        curve = irfft_mm_last(cross, A)                           # (B,A)
        idx = curve.argmax(dim=-1, keepdim=True)
        off = _parabola_peak_1d(curve.gather(1, (idx - 1) % A)[:, 0],
                                curve.gather(1, idx)[:, 0],
                                curve.gather(1, (idx + 1) % A)[:, 0])
        dpsi = (idx[:, 0].to(torch.float32) + off) * (360.0 / A)
        dpsi = torch.where(dpsi > 180.0, dpsi - 360.0, dpsi)
        rad = torch.deg2rad(dpsi)
        c, s = torch.cos(rad), torch.sin(rad)
        psi_cur = psi_cur + dpsi
        # first-order composite T(ds)·R(dpsi)·T(s)·R(psi)
        #   = T(ds + R(dpsi)s)·R(psi+dpsi)
        sx, sy = c * sx + s * sy + dsx, -s * sx + c * sy + dsy

    aligned = rotate_shift_fourier(work, psi_cur, sx, sy)
    # final shift half-step at the converged rotation (the loop's last ds
    # was measured before its last dpsi); exact compose via sinc translate
    dsx, dsy, _ = best_shift_from_spectra(F_chosen, rfft2_any(aligned),
                                          max_shift=max_shift, W=W)
    sx = sx + dsx
    sy = sy + dsy
    aligned = translate_fourier(aligned, dsx, dsy)
    corr = correlation_index(chosen_refs, aligned)

    # Convert to the framework-wide metadata pose convention
    # (ops.geo: shift(img, s_md) ≈ M_x^flip proj(A(rot, tilt, psi_md))).
    # The matcher's mirror candidates are Y-flips (polar angle reversal);
    # alignment_to_md_pose takes the X-mirror convention (xmipp MDL_FLIP),
    # and F_y = F_x·R(180), so flipped rows carry psi+180.
    psi_x = torch.where(flip, psi_cur + 180.0, psi_cur)
    psi_md, sx_md, sy_md, _ = alignment_to_md_pose(psi_x, sx, sy, flip)
    return dict(ref_idx=best_ref, psi=psi_md, sx=sx_md, sy=sy_md, corr=corr,
                flip=flip, aligned=aligned)


def _match(refs, imgs, trials, max_shift: int, radius_min: int,
           radius_max: int, refine_iters: int, check_mirror: bool,
           psi_allow=None):
    """Gallery match: the scan over the trials, then the winner's
    refinement."""
    with timed_phase("scan", sync=imgs):
        peak0, psi0, best_ref, trial_idx, flip = _scan_trials(
            refs, imgs, trials, radius_min, radius_max, check_mirror,
            psi_allow=psi_allow)
    t = torch.as_tensor(np.asarray(trials, np.float32),
                        device=imgs.device)[trial_idx]            # (B,2)
    with timed_phase("refine", sync=imgs):
        out = refine_winners(refs, imgs, best_ref, psi0, t, flip, max_shift,
                             radius_min, radius_max, refine_iters)
    out["peak"] = peak0
    return out


def _match_topn(refs, imgs, trials, allowed, max_shift: int,
                radius_min: int, radius_max: int, refine_iters: int,
                check_mirror: bool, n_orientations: int, psi_allow=None):
    """Top-N orientations per image over a (possibly) restricted gallery.

    allowed: (B, R) float mask (1 = candidate, 0 = excluded) — the per-image
    neighborhood restriction, consumed as a score mask over the dense
    gallery correlation."""
    with timed_phase("scan", sync=imgs):
        peak, psi, trial, flip = _scan_trials_full(
            refs, imgs, trials, radius_min, radius_max, check_mirror,
            psi_allow=psi_allow)
    peak = torch.where(allowed > 0, peak, -torch.inf)
    topv, topi = torch.topk(peak, n_orientations, dim=1)      # (B, N)
    tgrid = torch.as_tensor(np.asarray(trials, np.float32),
                            device=imgs.device)
    outs = []
    with timed_phase("refine", sync=imgs):
        for k in range(n_orientations):
            rk = topi[:, k:k + 1]
            out = refine_winners(refs, imgs, rk[:, 0], psi.gather(1, rk)[:, 0],
                                 tgrid[trial.gather(1, rk)[:, 0]],
                                 flip.gather(1, rk)[:, 0], max_shift,
                                 radius_min, radius_max, refine_iters)
            out.pop("aligned", None)
            out["peak"] = topv[:, k]
            outs.append(out)
    return {key: torch.stack([o[key] for o in outs], dim=1)
            for key in outs[0]}


N_ANGLES = 254   # the psi mask grid of the matching programs


def _prepare(refs, imgs, max_shift, radius_max, trial_step, device):
    refs = as_tensor(refs, device)
    imgs = as_tensor(imgs, refs.device)
    if imgs.ndim == 2:
        imgs = imgs[None]
    if radius_max is None:
        radius_max = imgs.shape[-2] // 2 - 2
    trials = tuple(map(tuple, _trial_shift_grid(max_shift, trial_step)
                       .astype(float).tolist()))
    return refs, imgs, radius_max, trials


def match_to_gallery(refs, imgs, max_shift: int = 8, radius_min: int = 2,
                     radius_max: int | None = None, refine_iters: int = 2,
                     check_mirror: bool = True, trial_step: float | None = None,
                     n_orientations: int = 1, allowed=None, psi_allow=None,
                     device=None):
    """Match each image to its best gallery reference + in-plane pose.

    5-D search: rotational ring correlation against all references at each
    trial translation of a coarse grid, then shift+rotation refinement of the
    winner. Returns dict(ref_idx, psi, sx, sy, corr, flip, peak) of (B,)
    tensors on `device` (default: the card; tensors stay where they are).

    n_orientations > 1 keeps the top-N orientations per image (outputs get
    a trailing axis of size N). allowed (B, R) restricts the candidate
    references per image (neighborhood restriction)."""
    refs, imgs, radius_max, trials = _prepare(refs, imgs, max_shift,
                                              radius_max, trial_step, device)
    if psi_allow is not None:
        psi_allow = as_tensor(psi_allow, refs.device)
    if n_orientations == 1 and allowed is None:
        return _match(refs, imgs, trials, max_shift, radius_min, radius_max,
                      refine_iters, check_mirror, psi_allow=psi_allow)
    if allowed is None:
        allowed = torch.ones((imgs.shape[0], refs.shape[0]),
                             device=refs.device)
    else:
        allowed = as_tensor(allowed, refs.device)
    out = _match_topn(refs, imgs, trials, allowed, max_shift, radius_min,
                      radius_max, refine_iters, check_mirror, n_orientations,
                      psi_allow=psi_allow)
    if n_orientations == 1:
        out = {k: v[:, 0] for k, v in out.items()}
    return out


def match_score_matrix(refs, imgs, max_shift: int = 8, radius_min: int = 2,
                       radius_max: int | None = None,
                       check_mirror: bool = True,
                       trial_step: float | None = None, device=None):
    """Full (B, R) best-over-(psi, trial) correlation matrix + per-pair
    pose — the align_significant front end."""
    refs, imgs, radius_max, trials = _prepare(refs, imgs, max_shift,
                                              radius_max, trial_step, device)
    peak, psi, trial, flip = _scan_trials_full(refs, imgs, trials,
                                               radius_min, radius_max,
                                               check_mirror)
    return dict(peak=peak, psi=psi, trial=trial, flip=flip,
                trials=np.asarray(trials, np.float32))
