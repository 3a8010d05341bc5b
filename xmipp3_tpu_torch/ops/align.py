"""2-D alignment: iterative rotation+shift estimation, mirror handling,
multireference alignment.

Counterpart of the reference package's ops/align.py (reference
IterativeAlignmentEstimator, reconstruction/iterative_alignment_estimator.h
:46-90; alignImages / alignImagesConsideringMirrors, data/filters.h
:538-623): every step processes the whole (B,H,W) stack on its device.

`ref` is one (H,W) image for the whole stack, or a (B,H,W) stack with one
reference per image (the pairs of image_align --pspc): every step
broadcasts the reference against the images.
"""
from __future__ import annotations

import torch

from xmipp3_tpu_torch.device import as_tensor
from xmipp3_tpu_torch.ops.dft_mm import fft2_abs_shifted_mm
from xmipp3_tpu_torch.ops.geo import (alignment_matrices_2d, apply_affine_2d,
                                      centered_flip)
from xmipp3_tpu_torch.ops.polar import (best_rotation_from_ffts,
                                        cartesian_to_polar, ring_ffts)
from xmipp3_tpu_torch.ops.shear_rotate import (rotate_shift_fourier,
                                               translate_fourier)
from xmipp3_tpu_torch.ops.shift import best_shift, correlation_index


def _stack(ref, others, device):
    """others as a (B,H,W) float32 tensor on its device (or `device`), and
    ref on the same device."""
    others = as_tensor(others, device)
    if others.ndim == 2:
        others = others[None]
    return as_tensor(ref, others.device), others


def rotation_from_fourier_mag(ref, others, radius_min: int = 3,
                              radius_max: int | None = None, device=None):
    """Shift-invariant rotation estimate from |FFT| polar correlation.

    |F(img)| is invariant to translation and rotates with the image, so the
    polar ring correlation of magnitudes gives psi regardless of shifts (the
    approach of the reference's angular_assignment_mag). |F| is
    centrosymmetric, so the result carries a 180° ambiguity the caller
    resolves by merit. Returns (angle_deg, peak), each (B,)."""
    ref, others = _stack(ref, others, device)
    H = others.shape[-2]
    if radius_max is None:
        radius_max = H // 2 - 2

    def logmag(x):
        m = fft2_abs_shifted_mm(x[None] if x.ndim == 2 else x)
        return torch.log1p(m[0] if x.ndim == 2 else m)

    f_ref = ring_ffts(cartesian_to_polar(logmag(ref), radius_min, radius_max))
    f_oth = ring_ffts(cartesian_to_polar(logmag(others), radius_min,
                                         radius_max))
    return best_rotation_from_ffts(f_ref, f_oth, radius_min)


def iterative_align(ref, others, n_iters: int = 3, max_shift: int | None = None,
                    radius_min: int = 2, radius_max: int | None = None,
                    order: int = 1, device=None):
    """Estimate (psi, sx, sy) registering each of `others` onto `ref`.

    The rotation is solved shift-invariantly from Fourier magnitudes
    (180°-ambiguous); both candidates are completed with a shift estimate,
    and the second is kept only where its correlation is strictly greater;
    then n_iters refinement passes polish the pose. Everything is batched
    over the stack.

    Composition convention matches ops.geo.apply_alignment_2d:
    aligned = shift(rotate(other, psi), sx, sy).
    Returns (psi_deg, sx, sy, corr, aligned)."""
    ref, others = _stack(ref, others, device)
    B, H, W = others.shape
    if radius_max is None:
        radius_max = H // 2 - 2

    ang, _ = rotation_from_fourier_mag(ref, others,
                                       radius_min=max(radius_min, 3),
                                       radius_max=radius_max)

    # estimation warps use the three-shear Fourier rotation; only the
    # returned image uses the spatial warp (zero fill, requested order)
    zeros = torch.zeros(B, device=others.device)

    def candidate(psi):
        rotated = rotate_shift_fourier(others, psi, zeros, zeros)
        dsx, dsy, _ = best_shift(ref, rotated, max_shift=max_shift)
        # periodic sinc translations compose exactly: translate `rotated`
        aligned = translate_fourier(rotated, dsx, dsy)
        return psi, dsx, dsy, correlation_index(ref, aligned)

    cands = [candidate(ang), candidate(ang + 180.0)]
    use2 = cands[1][3] > cands[0][3]
    psi, sx, sy = (torch.where(use2, cands[1][i], cands[0][i])
                   for i in range(3))

    psi, sx, sy = _iterative_align_refine(ref, others, psi, sx, sy, n_iters,
                                          max_shift, radius_min, radius_max)
    aligned = apply_affine_2d(others, alignment_matrices_2d(psi, sx, sy),
                              order=order)
    corr = correlation_index(ref, aligned)
    psi = torch.remainder(psi + 180.0, 360.0) - 180.0
    return psi, sx, sy, corr, aligned


def _iterative_align_refine(ref, others, psi, sx, sy, n_iters: int,
                            max_shift, radius_min: int, radius_max: int):
    """n_iters Jacobi updates, dpsi and (dsx, dsy) both measured on the same
    warp (T(ds)·R(dpsi)·T(s)·R(psi) = T(ds + R(dpsi)s)·R(psi+dpsi)), then a
    final shift half-step at the converged rotation."""
    f_ref = ring_ffts(cartesian_to_polar(ref, radius_min, radius_max))
    for _ in range(n_iters):
        cur = rotate_shift_fourier(others, psi, sx, sy)
        f_cur = ring_ffts(cartesian_to_polar(cur, radius_min, radius_max))
        dpsi, _ = best_rotation_from_ffts(f_ref, f_cur, radius_min)
        dsx, dsy, _ = best_shift(ref, cur, max_shift=max_shift)
        rad = torch.deg2rad(dpsi)
        c, s = torch.cos(rad), torch.sin(rad)
        psi, sx, sy = (psi + dpsi, c * sx + s * sy + dsx,
                       -s * sx + c * sy + dsy)
    cur = rotate_shift_fourier(others, psi, sx, sy)
    dsx, dsy, _ = best_shift(ref, cur, max_shift=max_shift)
    return psi, sx + dsx, sy + dsy


def align_considering_mirrors(ref, others, device=None, **kw):
    """Try straight and x-mirrored alignment, keep the mirror only where its
    correlation is strictly greater (reference
    alignImagesConsideringMirrors, data/filters.h:544,623).

    Returns (psi, sx, sy, flip, corr, aligned)."""
    ref, others = _stack(ref, others, device)
    mirrored = centered_flip(others, 2)
    psi1, sx1, sy1, c1, a1 = iterative_align(ref, others, **kw)
    psi2, sx2, sy2, c2, a2 = iterative_align(ref, mirrored, **kw)
    use2 = c2 > c1
    pick = lambda a, b: torch.where(use2, b, a)
    aligned = torch.where(use2[:, None, None], a2, a1)
    return (pick(psi1, psi2), pick(sx1, sx2), pick(sy1, sy2), use2,
            pick(c1, c2), aligned)


def multireference_align(refs, others, max_shift: int | None = None,
                         radius_min: int = 2, radius_max: int | None = None,
                         n_iters: int = 2, order: int = 1, device=None):
    """Align every image against every reference; return per-image best.

    Returns a dict with ref_idx, psi, sx, sy, corr — each (B,) — and the
    full correlation matrix (B, R); the first reference wins a tie."""
    refs, others = _stack(refs, others, device)
    if refs.ndim == 2:
        refs = refs[None]
    B = others.shape[0]
    per_ref = [iterative_align(ref, others, n_iters=n_iters,
                               max_shift=max_shift, radius_min=radius_min,
                               radius_max=radius_max, order=order)[:4]
               for ref in refs]
    psi, sx, sy, corr = (torch.stack(v) for v in zip(*per_ref))  # (R, B)
    best = corr.argmax(dim=0)
    take = lambda M: M[best, torch.arange(B, device=M.device)]
    return dict(ref_idx=best, psi=take(psi), sx=take(sx), sy=take(sy),
                corr=take(corr), corr_matrix=corr.T)
