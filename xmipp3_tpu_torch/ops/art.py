"""Iterative algebraic reconstruction (ART/SIRT family) and WBP in torch.

Counterpart of the reference package's ops/art.py (the reference
reconstruct_art/basic_art parallel modes, basic_art.h:92: ART, pSART,
pSIRT, ...; reconstruct_wbp, reconstruct_wbp.h:47). The forward operator
is the batched Fourier central-slice extractor of ops/project.py and the
adjoint its gridding scatter (ops/reconstruct.py): every block of an ART
pass is one projection of the current volume at the block's poses and one
reconstruction of the residuals, trilinear (K2, ops/scatter_tri.py), and
SIRT, WBP and SIRT's start grid with the Kaiser-Bessel window (K3,
ops/scatter_kb.py).

The volume, the projections and the residuals stay on the device (the
card by default, the mesh's device on a mesh); the POCS constraints and
the regularisers run there in float32, as the reference runs them in
numpy float32. What the reference decides on the host stays there: the
projection orders (numpy Generator permutations, the greedy orthogonal
order), the block bookkeeping and the stopping rule, which reads one
residual a pass. WBP's arbitrary-geometry filter sums its normalised
sincs over the directions in chunks of images, so that a chunk's (C, N,
N, K) terms stay within WBP_CHUNK_BYTES.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.geometry import euler_matrix
from xmipp3_tpu_torch.device import as_tensor, resolve_device
from xmipp3_tpu_torch.ops.project import (extract_central_slices,
                                          prepare_fourier_volume,
                                          slices_to_projections)
from xmipp3_tpu_torch.ops.reconstruct import reconstruct_fourier

# bytes of one chunk's (C, N, N, K) float32 sinc terms in WBP's filter
WBP_CHUNK_BYTES = 1 << 30


def _forward(vol, mats, N, pad_factor=2.0):
    """Projections (B, N, N) of the volume tensor at (B, 3, 3) poses, on
    the volume's device."""
    vf, _ = prepare_fourier_volume(vol, pad_factor)
    return slices_to_projections(extract_central_slices(vf, mats, N), N)


def _backproject(imgs, rot, tilt, psi, pad_factor, interp="kb"):
    """reconstruct_fourier of an image tensor in one batch, on its device
    (the reference passes batch=len(imgs))."""
    return reconstruct_fourier(imgs, rot, tilt, psi, pad_factor=pad_factor,
                               batch=max(len(imgs), 1), interp=interp,
                               device=imgs.device)


def _shifted(imgs, sx, sy):
    """imgs moved by the rows' (sx, sy) in Fourier space, when given."""
    if sx is None and sy is None:
        return imgs
    from xmipp3_tpu_torch.ops.fourier import fourier_shift_2d
    z = np.zeros(len(imgs), np.float32)
    return fourier_shift_2d(imgs, z if sx is None else np.asarray(
        sx, np.float32), z if sy is None else np.asarray(sy, np.float32))


def _gradient(v, dim):
    return torch.gradient(v, dim=dim)[0]


def sirt_reconstruct(imgs, rot, tilt, psi, n_iters: int = 10,
                     lam: float = 1.0, positivity: bool = False,
                     pad_factor: float = 2.0, verbose: int = 0,
                     sx=None, sy=None, ridge: float = 0.0,
                     tv: float = 0.0, l1: float = 0.0,
                     soft_threshold: float = 0.0, vol_mask=None,
                     iter_callback=None, device=None):
    """SIRT: vol <- vol + lam * R^T(b - R vol) with R normalized per pass.

    Initialization = the weighted direct Fourier reconstruction; the
    iterations correct interpolation and coverage bias. Optional
    regularizers after each step (the cuda11_forward_art_zernike3d family,
    forward_art_zernike3d_gpu.cpp:145-148): ridge = Tikhonov shrinkage
    (--ltk), tv = smoothed total-variation subgradient step (--ltv), l1 =
    L1 subgradient (--ll1), soft_threshold = proximal soft threshold
    (--lst); vol_mask multiplies the volume each iteration (--maskb),
    positivity clamps negatives (--onlyPositive); iter_callback(it, vol)
    fires after each iteration with the volume tensor. Returns (volume
    tensor on `device` (the card by default), residual_history)."""
    dev = resolve_device(device)
    imgs = _shifted(as_tensor(imgs, dev), sx, sy)
    B, N, _ = imgs.shape
    mats = np.asarray(euler_matrix(
        np.asarray(rot, np.float32), np.asarray(tilt, np.float32),
        np.asarray(psi, np.float32)), np.float32)
    vol = _backproject(imgs, rot, tilt, psi, pad_factor)
    mask = None if vol_mask is None else as_tensor(vol_mask, dev)
    hist = []
    for it in range(n_iters):
        resid = imgs - _forward(vol, mats, N, pad_factor)
        rms = float(torch.sqrt((resid ** 2).mean()))
        hist.append(rms)
        # adjoint of the projector: reconstruct the residuals (normalized
        # scatter) and add
        vol = vol + lam * _backproject(resid, rot, tilt, psi, pad_factor)
        if ridge > 0:
            vol = vol * (1.0 - ridge)
        if tv > 0:
            gz, gy, gx = torch.gradient(vol)
            mag = torch.sqrt(gz * gz + gy * gy + gx * gx + 1e-8)
            div = (_gradient(gz / mag, 0) + _gradient(gy / mag, 1)
                   + _gradient(gx / mag, 2))
            vol = vol + tv * div
        if l1 > 0:
            vol = vol - l1 * torch.sign(vol)
        if soft_threshold > 0:
            vol = torch.sign(vol) * torch.clamp(vol.abs() - soft_threshold,
                                                min=0.0)
        if mask is not None:
            vol = vol * mask
        if positivity:
            vol = torch.clamp(vol, min=0.0)
        if iter_callback is not None:
            iter_callback(it + 1, vol)
        if verbose:
            print(f"  SIRT iter {it + 1}: residual rms {rms:.5f}")
        if it > 1 and hist[-2] - hist[-1] < 1e-6 * hist[0]:
            break
    return vol, hist


ART_MODES = ("ART", "pCAV", "pAVSP", "pSART", "pBiCAV", "pSIRT", "pfSIRT",
             "SIRT")


def _orthogonal_order(rot, tilt, psi, sort_last: int = 2):
    """Greedy most-orthogonal ordering on the host: the next projection
    minimizes the summed |dot| of its direction with the last `sort_last`
    chosen ones (reference sortPerpendicular / --sort_last, basic_art.cpp;
    -1 = use all previous)."""
    A = np.asarray(euler_matrix(np.asarray(rot, np.float32),
                                np.asarray(tilt, np.float32),
                                np.asarray(psi, np.float32)))
    dirs = A[:, 2, :]
    B = len(dirs)
    order = [0]
    remaining = set(range(1, B))
    while remaining:
        last = order if sort_last < 0 else order[-sort_last:]
        rem = np.fromiter(remaining, int)
        cost = np.abs(dirs[rem] @ dirs[last].T).sum(axis=1)
        pick = int(rem[np.argmin(cost)])
        order.append(pick)
        remaining.discard(pick)
    return np.asarray(order)


def _symmetrized(v, sym_mats):
    from xmipp3_tpu_torch.ops.geo import apply_affine_3d
    return apply_affine_3d(v, np.asarray(sym_mats, np.float32)).mean(dim=0)


def _pocs_extras(v, known_volume: float = -1, sparse_eps: float = -1,
                 diffusion_eps: float = -1, sphere_mask=None,
                 sym_mats=None):
    """Extra POCS projections on the volume tensor (reference
    basic_art.cpp POCS chain): --known_volume top-mass cut, --sparse soft
    support, --diffusion smoothing, -R interest sphere, volume
    symmetrization."""
    if known_volume > 0:
        k = int(min(known_volume, v.numel()))
        thr = torch.sort(v.reshape(-1)).values[-k]
        v = torch.where(v >= thr, v, 0.0)
    if sparse_eps > 0:
        vmax = torch.clamp(v.abs().max(), min=1e-12)
        v = torch.where(v.abs() >= sparse_eps * vmax, v, 0.0)
    if diffusion_eps > 0:
        lap = -6.0 * v
        for d in range(3):
            lap = lap + torch.roll(v, 1, d) + torch.roll(v, -1, d)
        v = v + diffusion_eps * lap
    if sphere_mask is not None:
        v = torch.where(sphere_mask, v, 0.0)
    if sym_mats is not None and len(sym_mats) > 1:
        v = _symmetrized(v, sym_mats)
    return v


def art_reconstruct(imgs, rot, tilt, psi, mode: str = "SIRT",
                    n_iters: int = 5, lambda_list=(0.5,),
                    block_size: int | None = None,
                    positivity: bool = False, surface_mask=None,
                    pocs_freq: int = 1, random_sort: bool = False,
                    pad_factor: float = 2.0, verbose: int = 0,
                    sx=None, sy=None, seed: int = 0, mesh=None,
                    init_vol=None, stop_at: int = 0, sort_last: int = 0,
                    no_sort: bool = True, known_volume: float = -1,
                    sparse_eps: float = -1, diffusion_eps: float = -1,
                    sphere_R: float = -1, sym_mats=None, sym_each: int = 0,
                    force_sym: int = 0, wls: bool = False,
                    kappa_list=(0.5,), pixel_masks=None, ctf=None,
                    refine: bool = False, ref_trans_after: int = -1,
                    ref_trans_step: float = -1.0, show_error: bool = False,
                    save_intermediate=None, device=None):
    """Algebraic reconstruction with the reference's parallel-mode family
    (basic_art.h:92 ARTParallelMode {ART, pCAV, pAVSP, pSART, pBiCAV,
    pSIRT, pfSIRT, SIRT}) and POCS constraints (:373-376).

    Every block is one batched project/backproject pass on the device:
      ART        sequential Kaczmarz: block_size=1, update per projection;
      pAVSP      like ART, but a sweep's corrections are averaged into one
                 update at the sweep's end;
      pSART      update after each block, the correction normalized by the
                 block's density (the D/W compensation of the adjoint);
      pBiCAV     block-iterative CAV: pSART's update (the weight cube is
                 the per-voxel equation count the CAV normalization needs);
      pCAV       CAV: one simultaneous update;
      pSIRT/SIRT simultaneous update from all projections;
      pfSIRT     SIRT with the correction rescaled to the block's max
                 |residual|.

    POCS constraints: positivity clip and an optional surface mask (volume
    forced to 0 where mask==1), applied every pocs_freq block updates.
    lambda_list gives per-iteration relaxation (reference lambda_list,
    basic_art.h:438; the last value repeats). On a mesh every block's
    correction comes from parallel_art_correction (the block's projections
    dealt to the ranks, one all_reduce).

    Returns (volume tensor on `device` (the card by default; the mesh's
    device on a mesh), residual_history)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    imgs = as_tensor(imgs, dev)
    if refine or ref_trans_after > 0 or wls:
        imgs = imgs.clone()         # refined in place below
    B, N, _ = imgs.shape
    rot = np.asarray(rot, np.float32)
    tilt = np.asarray(tilt, np.float32)
    psi = np.asarray(psi, np.float32)
    imgs = _shifted(imgs, sx, sy)
    mats_all = np.asarray(euler_matrix(rot, tilt, psi), np.float32)
    if mode not in ART_MODES:
        raise ValueError(f"unknown ART mode {mode!r} (valid: {ART_MODES})")
    if block_size is None:
        block_size = {"ART": 1, "pAVSP": 1}.get(mode, max(B // 8, 1))
    if mode in ("SIRT", "pSIRT", "pfSIRT", "pCAV"):
        block_size = B
    lambda_list = list(np.atleast_1d(lambda_list).astype(np.float64))

    rng = np.random.default_rng(seed)
    vol = torch.zeros((N, N, N), dtype=torch.float32, device=dev) \
        if init_vol is None else as_tensor(init_vol, dev).clone()
    mask = None if surface_mask is None else \
        as_tensor(surface_mask, dev) > 0.5
    sphere = None
    if sphere_R > 0:
        zz, yy, xx = np.mgrid[0:N, 0:N, 0:N].astype(np.float32) - N // 2
        sphere = torch.as_tensor(
            (zz * zz + yy * yy + xx * xx) <= sphere_R * sphere_R, device=dev)
    if pixel_masks is not None:
        pixel_masks = as_tensor(pixel_masks, dev)
    kappa_list = list(np.atleast_1d(kappa_list).astype(np.float64))
    resid_store = torch.zeros_like(imgs) if wls else None
    ortho = None
    if not random_sort and (not no_sort or sort_last != 0):
        ortho = _orthogonal_order(rot, tilt, psi,
                                  sort_last if sort_last != 0 else 2)
    hist = []
    upd_count = 0
    stopped = False

    def pocs(v):
        if positivity:
            v = torch.clamp(v, min=0.0)
        if mask is not None:
            v = torch.where(mask, 0.0, v)
        return _pocs_extras(v, known_volume, sparse_eps, diffusion_eps,
                            sphere, sym_mats if force_sym > 0 else None)

    for it in range(n_iters):
        lam = lambda_list[min(it, len(lambda_list) - 1)]
        kappa = kappa_list[min(it, len(kappa_list) - 1)]
        if random_sort:
            order = rng.permutation(B)
        elif ortho is not None:
            order = ortho
        else:
            order = np.arange(B)
        sweep_resid = torch.zeros((), dtype=torch.float64, device=dev)
        sweep_corr = torch.zeros_like(vol) if mode == "pAVSP" else None
        nblk = 0
        for s in range(0, B, block_size):
            sel = order[s:s + block_size]
            sel_t = torch.as_tensor(sel, device=dev)
            if mesh is not None:
                # data-parallel block update: the block's projections dealt
                # to the ranks, one all_reduce of the partial cubes
                # (parallel/reconstruct.py; the reference distributes ART
                # blocks across MPI workers the same way, basic_art.h:92-116)
                from xmipp3_tpu_torch.parallel.reconstruct import \
                    parallel_art_correction
                corr, ss, rmax = parallel_art_correction(
                    mesh, vol, imgs[sel_t], rot[sel], tilt[sel], psi[sel],
                    pad_factor=pad_factor, interp="tri")
                sweep_resid += ss
            else:
                proj = _forward(vol, mats_all[sel], N, pad_factor)
                if ctf is not None:
                    # theoretical projections see the same CTF as the data
                    # (reference --ctf, basic_art.cpp)
                    from xmipp3_tpu_torch.ops.ctf import apply_ctf
                    proj = apply_ctf(proj, ctf)
                if refine or (ref_trans_after > 0
                              and upd_count >= ref_trans_after):
                    # translational re-alignment of the experimental
                    # projections against the theoretical ones
                    # (reference --refine / --ref_trans_after/_step)
                    from xmipp3_tpu_torch.ops.geo import shift_2d_real
                    from xmipp3_tpu_torch.ops.shift import best_shift
                    sx_r, sy_r, _ = best_shift(proj, imgs[sel_t])
                    if ref_trans_step > 0:
                        sx_r = sx_r.clamp(-ref_trans_step, ref_trans_step)
                        sy_r = sy_r.clamp(-ref_trans_step, ref_trans_step)
                    imgs[sel_t] = shift_2d_real(imgs[sel_t], -sx_r, -sy_r)
                resid = imgs[sel_t] - proj
                if pixel_masks is not None:
                    resid = resid * pixel_masks[sel_t]
                if wls:
                    # weighted-least-squares ART: the backprojected
                    # residual is the kappa-relaxed running residual
                    # (reference --WLS / -k kappa list)
                    resid_store[sel_t] = (1.0 - kappa) * resid_store[sel_t] \
                        + kappa * resid
                    resid = resid_store[sel_t]
                sweep_resid += (resid ** 2).sum()
                rmax = resid.abs().max()
                if show_error:
                    print(f"    block {nblk}: |resid|_rms "
                          f"{float(torch.sqrt((resid ** 2).mean())):.5f}")
                corr = _backproject(resid, rot[sel], tilt[sel], psi[sel],
                                    pad_factor, interp="tri")
            if mode == "pfSIRT":
                m = corr.abs().max()
                corr = torch.where(m > 1e-12, corr * (rmax / m), corr)
            if mode == "pAVSP":
                sweep_corr += corr
            else:
                vol = vol + lam * corr
                upd_count += 1
                if pocs_freq > 0 and upd_count % pocs_freq == 0:
                    vol = pocs(vol)
                if sym_mats is not None and sym_each > 0 \
                        and (upd_count * block_size) % sym_each < block_size:
                    vol = _symmetrized(vol, sym_mats)
            nblk += 1
            if stop_at > 0 and (it * B + s + len(sel)) >= stop_at:
                stopped = True
                break
        if mode == "pAVSP":
            vol = pocs(vol + lam * sweep_corr / max(nblk, 1))
        else:
            vol = pocs(vol)
        rms = float(torch.sqrt(sweep_resid / (B * N * N)))
        hist.append(rms)
        if verbose:
            print(f"  {mode} iter {it + 1}: residual rms {rms:.5f} "
                  f"(lambda {lam})")
        if save_intermediate is not None:
            save_intermediate(it, vol)
        if stopped:
            break
        if it > 1 and hist[-2] - hist[-1] < 1e-6 * hist[0]:
            break
    return vol, hist


def wbp_direction_set(rot, tilt, psi=None, weights=None, filsam: float = 5.0,
                      sym: str = "c1", use_each_image: bool = False):
    """The mat_g table of the Radermacher arbitrary-geometry filter, on the
    host (reconstruct_wbp.cpp:231-358, getSampledMatrices / getAllMatrices):
    beam-direction rows (z-row of Euler(rot, -tilt, psi)) with
    per-direction image counts — one per symmetry-expanded image
    (--use_each_image), or binned onto an even distribution sampled every
    `filsam` degrees. Returns numpy (g_rows (K,3), counts (K,))."""
    from xmipp3_tpu_torch.core import sampling as smp
    from xmipp3_tpu_torch.core.sym import SymList
    rot = np.asarray(rot, np.float64)
    tilt = np.asarray(tilt, np.float64)
    psi_arr = (np.zeros_like(rot) if psi is None
               else np.asarray(psi, np.float64))
    w = (np.ones(len(rot)) if weights is None
         else np.asarray(weights, np.float64))
    sl = SymList(sym if sym else "c1")
    if use_each_image:
        base = np.stack([rot, tilt, psi_arr, w], axis=1)
    else:
        pts = smp.remove_redundant_points(
            smp.compute_sampling_points(filsam), sl)
        d_ref = smp.directions_from_angles(pts)
        d_img = smp.directions_from_angles(np.stack([rot, tilt], axis=1))
        mats = sl.sym_matrices().astype(np.float64)
        orb = np.einsum("sij,nj->nsi", mats, d_img)          # (N,S,3)
        idx = np.argmax(
            np.einsum("nsi,mi->nsm", orb, d_ref).max(axis=1), axis=1)
        counts = np.zeros(len(pts))
        np.add.at(counts, idx, w)
        # the reference floors each bin count to int (reconstruct_wbp.cpp:276)
        counts = np.floor(counts)
        keep = counts > 0
        base = np.stack([pts[keep, 0], pts[keep, 1],
                         np.zeros(int(keep.sum())), counts[keep]], axis=1)
    rows, cnts = [], []
    for r, t, p, c in base:
        triplets = ([(r, t, p)] if len(sl) == 1
                    else sl.expand_euler(r, t, p))
        for er, et, ep in triplets:
            rows.append((er, et, ep))
            cnts.append(c)
    ang = np.array(rows, np.float64)
    A = np.asarray(euler_matrix(ang[:, 0].astype(np.float32),
                                (-ang[:, 1]).astype(np.float32),
                                ang[:, 2].astype(np.float32)))
    return A[:, 2, :].astype(np.float32), np.asarray(cnts, np.float32)


def _wbp_filter_chunk(imgs, f2, counts, K, thr_abs, diameter):
    """Divide each centered spectrum of a (C, N, N) chunk by its
    direction-summed sinc weighting (filterOneImage,
    reconstruct_wbp.cpp:437-492); f2 (C, K, 2)."""
    N = imgs.shape[-1]
    coords = K * (torch.arange(N, device=imgs.device) - N // 2).to(
        torch.float32)
    # (C, N, N, K): [c, y, x, k] = K * (x f2x[c, k] + y f2y[c, k])
    args = (coords[None, None, :, None] * f2[:, None, None, :, 0]
            + coords[None, :, None, None] * f2[:, None, None, :, 1])
    w = args.sinc_().mul_(counts).sum(dim=-1)      # one (C, N, N, K) buffer
    sgn = torch.where(w < 0, -1.0, 1.0)
    denom = torch.where(w.abs() < thr_abs, sgn * thr_abs, w) * diameter
    dims = (-2, -1)
    spec = torch.fft.fftshift(torch.fft.fft2(imgs), dim=dims)
    out = torch.fft.ifft2(torch.fft.ifftshift(spec / denom, dim=dims))
    return out.real


def wbp_arbitrary_filter(imgs, rot, tilt, psi, g_rows, counts,
                         diameter: float | None = None,
                         threshold: float = 0.005, device=None):
    """Radermacher arbitrary-geometry weighting of a projection batch, on
    the images' device (a tensor stays where it is; an array goes to
    `device`, the card by default).

    For image matrix A = Euler(-rot, tilt, -psi), each direction's in-plane
    frequency footprint is f_k = (A^T g_k)_{xy}; the 2-D weight at centered
    frequency index (j, i) is sum_k count_k * sinc(K*(j*f_x + i*f_y)) with
    K = diameter/dim, clamped at threshold*totimgs (the reference's relative
    threshold, reconstruct_wbp.cpp:304/461-472). The images go through in
    chunks whose sinc terms fit WBP_CHUNK_BYTES."""
    imgs = as_tensor(imgs, device)
    dev = imgs.device
    B, N = imgs.shape[0], imgs.shape[1]
    if diameter is None or diameter <= 0:
        diameter = float(N)
    A = torch.as_tensor(np.asarray(euler_matrix(
        -np.asarray(rot, np.float32), np.asarray(tilt, np.float32),
        -np.asarray(psi, np.float32)), np.float32), device=dev)
    g = as_tensor(g_rows, dev)
    f2 = torch.einsum("kc,bcd->bkd", g, A)[..., :2].contiguous()  # (B,K,2)
    thr_abs = float(np.float32(threshold * float(np.sum(counts))))
    Kc = float(np.float32(diameter / N))
    cj = as_tensor(counts, dev)
    dia = float(np.float32(diameter))
    n_dirs = max(len(cj), 1)
    C = max(1, min(B, WBP_CHUNK_BYTES // (4 * N * N * n_dirs)))
    return torch.cat([_wbp_filter_chunk(imgs[s:s + C], f2[s:s + C], cj, Kc,
                                        thr_abs, dia)
                      for s in range(0, B, C)])


def wbp_reconstruct(imgs, rot, tilt, psi, pad_factor: float = 2.0,
                    filter_diameter: float | None = None,
                    mode: str = "ramp", weights=None, filsam: float = 5.0,
                    sym: str = "c1", use_each_image: bool = False,
                    threshold: float = 0.005, device=None):
    """Weighted back-projection (reconstruct_wbp.cpp).

    mode="arbitrary" applies the reference's Radermacher arbitrary-geometry
    filter (sampled every `filsam` degrees, or per-image with
    use_each_image; optional per-image weights, symmetry expansion, relative
    threshold). mode="ramp" is the classic |k| ramp pre-filter. Both paths
    back-project with the Fourier adjoint scatter of direct inversion (the
    reference's kb gridding, K3). Returns the volume tensor on `device`
    (the card by default; a tensor's own device)."""
    imgs = as_tensor(imgs, device)
    dev = imgs.device
    B, N, _ = imgs.shape
    if filter_diameter is None or filter_diameter <= 0:
        filter_diameter = N
    if mode == "arbitrary":
        if weights is not None:
            imgs = imgs * as_tensor(weights, dev)[:, None, None]
        g_rows, counts = wbp_direction_set(
            rot, tilt, psi=psi, weights=weights, filsam=filsam, sym=sym,
            use_each_image=use_each_image)
        filtered = wbp_arbitrary_filter(
            imgs, rot, tilt, psi, g_rows, counts,
            diameter=filter_diameter, threshold=threshold)
    else:
        fy = np.fft.fftfreq(N).astype(np.float32)[:, None]
        fx = np.fft.rfftfreq(N).astype(np.float32)[None, :]
        r = np.sqrt(fx * fx + fy * fy)
        # ramp with flat region below 1/diameter (avoid DC null blowup)
        f0 = 1.0 / filter_diameter
        ramp = np.where(r < f0, r / f0 * f0, r).astype(np.float32)
        ramp[0, 0] = f0
        spec = torch.fft.rfft2(imgs)
        filtered = torch.fft.irfft2(spec * torch.as_tensor(ramp, device=dev),
                                    s=(N, N))
    # adjoint scatter: the accumulated weights normalize the interpolation
    # while the pre-filter provides the angular weighting
    return _backproject(filtered, rot, tilt, psi, pad_factor)


def wedge_aware_average(subs, rot, tilt, psi, t1: float = -60.0,
                        t2: float = 60.0, apply_alignment: bool = True,
                        device=None):
    """Missing-wedge-compensated subtomogram average (the
    forward_art_zernike3d_subtomos / tomo_average_subtomos data model):
    each subtomogram is rotated into the reference frame by its row pose,
    its wedge pass-band (tilt range t1..t2 about y) rotates analytically
    with it, and the Fourier sum is normalized by the accumulated
    per-voxel wedge coverage, clamped at 1. On `device` (the card by
    default), the sums in float64 as in the reference; returns a float32
    tensor."""
    from xmipp3_tpu_torch.ops.fourier_filter import wedge_mask_3d
    from xmipp3_tpu_torch.ops.geo import apply_affine_3d
    subs = as_tensor(subs, device)
    dev = subs.device
    B, n = subs.shape[0], subs.shape[-1]
    Fsum = torch.zeros((n, n, n // 2 + 1), dtype=torch.complex128, device=dev)
    Wsum = torch.zeros((n, n, n // 2 + 1), dtype=torch.float64, device=dev)
    rot, tilt, psi = (np.asarray(a, np.float32) for a in (rot, tilt, psi))
    A = np.asarray(euler_matrix(rot, tilt, psi), np.float32)
    for k in range(B):
        if apply_alignment:
            aligned = apply_affine_3d(subs[k], A[k].T)[0]
            w = wedge_mask_3d(n, n, n, t1, t2, rot=float(rot[k]),
                              tilt=float(tilt[k]), psi=float(psi[k]))
        else:
            aligned = subs[k]
            w = wedge_mask_3d(n, n, n, t1, t2)
        w = torch.as_tensor(w, device=dev)
        Fsum += torch.fft.rfftn(aligned.to(torch.float64)) * w
        Wsum += w
    # clamp coverage at 1: never amplify a barely-covered voxel (the
    # analytic wedge only approximates the pass-band of the interpolated
    # rotation; dividing by <1 coverage blows up interpolation leakage)
    avg = torch.fft.irfftn(Fsum / torch.clamp(Wsum, min=1.0), s=(n, n, n),
                           dim=(0, 1, 2))
    return avg.to(torch.float32)
