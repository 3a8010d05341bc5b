"""Movie (dose-fractionated stack) alignment: the FlexAlign path.

Counterpart of the reference package's ops/movie.py, in torch on the
movie's device:

  global:  frames -> rfft2 cropped to corr_n x corr_n with a Gaussian LPF
           -> the cross spectra of ALL i<j frame pairs -> sub-pixel peaks
           (windowed DFT on the search window, or a batched irfft2) ->
           host float64 least-squares solve of the per-frame trajectory
  local:   patches of the globally corrected frames (each patch frame
           optionally the mean of its neighbours in time); per patch the
           same pairwise pipeline, batched over patches in chunks; one
           least-squares trajectory per patch gives the (ny, nx, F, 2)
           shift field
  warp:    Hann-blended tiles, each Fourier-shifted by the field at its
           centre and summed over frames before one inverse FFT
  dose:    Grant & Grigorieff critical-exposure weights as a frequency
           filter of the weighted sum
  gain:    the rank-histogram gain estimate, in float64 on the device

The movie goes to its device once; only the (P, 2) shifts and peaks come
back to the host for the least-squares solves. Batched steps are chunked
so that their complex work stays near CHUNK_BYTES.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor
from xmipp3_tpu_torch.ops.fourier import freq_grid_2d, phase_ramp_1d
from xmipp3_tpu_torch.ops.shift import (correlation_peaks_2d,
                                        windowed_cross_peaks)

CHUNK_BYTES = 1 << 30


def _chunk(n: int, bytes_per_item: int) -> int:
    """Items per chunk that keep a chunk's work near CHUNK_BYTES."""
    return max(1, min(n, CHUNK_BYTES // max(int(bytes_per_item), 1)))


def _pairs(n_frames: int) -> np.ndarray:
    """(P, 2) frame pairs (i, j), i < j, in np.triu_indices order."""
    ii, jj = np.triu_indices(n_frames, k=1)
    return np.stack([ii, jj], axis=1)


def _shift_phases(shifts_x, shifts_y, H: int, W: int, device):
    """(F, H, 1) and (F, 1, W//2+1) separable phases exp(-2 pi i f s) of
    per-frame shifts, for an rfft2 layout."""
    sx = as_tensor(shifts_x, device).reshape(-1)
    sy = as_tensor(shifts_y, device).reshape(-1)
    px = phase_ramp_1d(torch.fft.rfftfreq(W, device=device), sx)
    py = phase_ramp_1d(torch.fft.fftfreq(H, device=device), sy)
    return py[:, :, None], px[:, None, :]


# ---------------------------------------------------------------------------
# global alignment
# ---------------------------------------------------------------------------

def _gaussian_lpf(corr_n: int, lpf_cutoff: float, device):
    fy, fx = freq_grid_2d(corr_n, corr_n)
    r = torch.as_tensor(np.sqrt(fy * fy + fx * fx), device=device)
    sigma = torch.tensor(lpf_cutoff, dtype=torch.float32) / 2.355
    return torch.exp(-0.5 * (r / sigma.to(device)) ** 2)


def frame_ffts_scaled(frames, corr_n: int, lpf_cutoff: float = 0.5,
                      device=None):
    """Per-frame rfft2 of the mean-subtracted frames, cropped to the
    corr_n x (corr_n//2+1) low frequencies and Gaussian low-pass filtered
    (the CUDAFlexAlignScale stage). frames (F, H, W) -> complex64
    (F, corr_n, corr_n//2+1), in chunks of frames."""
    frames = as_tensor(frames, device)
    F, H, W = frames.shape
    h2, k = corr_n // 2, corr_n // 2 + 1
    out = torch.empty((F, corr_n, k), dtype=torch.complex64,
                      device=frames.device)
    step = _chunk(F, 8 * H * (W // 2 + 1) + 4 * H * W)
    for f0 in range(0, F, step):
        x = frames[f0:f0 + step]
        spec = torch.fft.rfft2(x - x.mean(dim=(-2, -1), keepdim=True))
        out[f0:f0 + step, :h2] = spec[:, :h2, :k]
        out[f0:f0 + step, h2:] = spec[:, H - h2:, :k]
    return out * _gaussian_lpf(corr_n, lpf_cutoff, frames.device)


def pair_peaks(specs, corr_n: int, max_shift_px: int):
    """Sub-pixel correlation peaks of every i<j frame pair of each batch
    item: specs (..., F, corr_n, corr_n//2+1) -> shifts (..., P, 2) as
    (sx, sy) in cropped-grid pixels, peaks (..., P). A peak at +s means
    frame j's content sits at +s relative to frame i. Rows of (item, pair)
    are processed in chunks."""
    lead = specs.shape[:-3]
    F, n, k = specs.shape[-3:]
    specs = specs.reshape((-1, F, n, k))
    T = specs.shape[0]
    pairs = torch.as_tensor(_pairs(F), device=specs.device)
    P = len(pairs)
    windowed = 2 * max_shift_px + 3 <= corr_n // 2
    rows = torch.arange(T * P, device=specs.device)
    shifts = torch.empty((T * P, 2), dtype=torch.float32,
                         device=specs.device)
    peaks = torch.empty(T * P, dtype=torch.float32, device=specs.device)
    step = _chunk(T * P, 8 * n * k * (3 if windowed else 4))
    for r0 in range(0, T * P, step):
        r = rows[r0:r0 + step]
        t, p = r // P, r % P
        cross = specs[t, pairs[p, 1]] * specs[t, pairs[p, 0]].conj()
        if windowed:
            # direct window evaluation: the full irfft2 computes corr_n^2
            # values per pair and uses (2 ms + 1)^2 of them
            sx, sy, pk = windowed_cross_peaks(cross, n, n, int(max_shift_px))
        else:
            corr = torch.fft.fftshift(torch.fft.irfft2(cross, s=(n, n)),
                                      dim=(-2, -1))
            sx, sy, pk = correlation_peaks_2d(corr, max_shift_px)
        shifts[r0:r0 + step, 0] = sx
        shifts[r0:r0 + step, 1] = sy
        peaks[r0:r0 + step] = pk
    return shifts.reshape(lead + (P, 2)), peaks.reshape(lead + (P,))


def pairwise_shifts(specs, corr_n: int, max_shift_px: int):
    """Relative shifts between ALL frame pairs (i<j): (P, 2) shifts in the
    cropped-grid pixels, the (P, 2) pair indices (numpy) and (P,) peaks."""
    shifts, peaks = pair_peaks(specs, corr_n, max_shift_px)
    return shifts, _pairs(specs.shape[-3]), peaks


def solve_frame_trajectory(pair_shifts, pairs, n_frames: int,
                           weights=None) -> np.ndarray:
    """Least-squares per-frame positions from pairwise measurements (the
    host LSQ after the FlexAlign correlations), in float64 on the host.

    pair_shifts (P, 2): measured x_j - x_i. Gauge: mean position = 0.
    Returns (F, 2) frame positions."""
    pairs = np.asarray(pairs)
    P = len(pairs)
    w = np.ones(P) if weights is None else np.asarray(weights)
    A = np.zeros((P + 1, n_frames))
    b = np.zeros((P + 1, 2))
    k = np.arange(P)
    A[k, pairs[:, 0]] = -w
    A[k, pairs[:, 1]] = w
    b[:P] = w[:, None] * np.asarray(pair_shifts)
    A[P, :] = 1.0  # gauge fixing
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    return sol


def _shifted_chunks(frames, shifts_x, shifts_y, weights=None):
    """Yield (f0, spectra) of the frames Fourier-shifted by (shifts_x,
    shifts_y), optionally times per-frame frequency weights, in chunks of
    frames."""
    F, H, W = frames.shape
    py, px = _shift_phases(shifts_x, shifts_y, H, W, frames.device)
    step = _chunk(F, 16 * H * (W // 2 + 1))
    for f0 in range(0, F, step):
        sl = slice(f0, f0 + step)
        spec = torch.fft.rfft2(frames[sl]) * py[sl] * px[sl]
        if weights is not None:
            spec = spec * weights[sl]
        yield f0, spec


def shift_sum_frames(frames, shifts_x, shifts_y, dose_filter=None,
                     device=None):
    """Shift every frame by its correction (undo motion) and sum, in one
    Fourier pass; optional per-frame frequency weights (dose filter), in
    which case the weighted sum is normalised per frequency by the
    weights' sum. Returns an (H, W) tensor."""
    frames = as_tensor(frames, device)
    F, H, W = frames.shape
    if dose_filter is not None:
        dose_filter = as_tensor(dose_filter, frames.device)
    total = torch.zeros((H, W // 2 + 1), dtype=torch.complex64,
                        device=frames.device)
    for _, spec in _shifted_chunks(frames, shifts_x, shifts_y, dose_filter):
        total += spec.sum(dim=0)
    if dose_filter is not None:
        norm = dose_filter.sum(dim=0).clamp(min=1e-6)
        return torch.fft.irfft2(total * (F / norm), s=(H, W)) / F
    return torch.fft.irfft2(total, s=(H, W))


def shift_sum_frames_keep(frames, shifts_x, shifts_y, device=None):
    """Shift frames by their corrections without summing: (F, H, W)."""
    frames = as_tensor(frames, device)
    F, H, W = frames.shape
    out = torch.empty_like(frames)
    for f0, spec in _shifted_chunks(frames, shifts_x, shifts_y):
        out[f0:f0 + len(spec)] = torch.fft.irfft2(spec, s=(H, W))
    return out


def global_align(frames, max_shift_px: int = 40, corr_n: int | None = None,
                 device=None) -> np.ndarray:
    """Global movie alignment. Returns per-frame positions (F, 2) in FULL
    resolution pixels (x, y), float64 on the host. The frames stay on
    their device; only the (P, 2) shifts and (P,) peaks come back."""
    frames = as_tensor(frames, device)
    F, H, W = frames.shape
    if corr_n is None:
        corr_n = min(512, H, W)
        corr_n -= corr_n % 2
    scale = H / corr_n
    ms = max(int(max_shift_px / scale), 2)
    shifts, peaks = pair_peaks(frame_ffts_scaled(frames, corr_n), corr_n, ms)
    return solve_frame_trajectory(
        shifts.cpu().numpy() * scale, _pairs(F), F,
        weights=np.maximum(peaks.cpu().numpy(), 0))


# ---------------------------------------------------------------------------
# local (patch) alignment
# ---------------------------------------------------------------------------

def patch_grid(H, W, ny: int, nx: int, patch: int):
    """Centres (rows, columns) of an ny x nx patch grid."""
    cys = np.linspace(patch // 2, H - patch // 2 - 1, ny).astype(int)
    cxs = np.linspace(patch // 2, W - patch // 2 - 1, nx).astype(int)
    return cys, cxs


def local_patch_size(H: int, W: int, patch_size: int) -> int:
    patch_size = min(patch_size, H // 2, W // 2)
    return patch_size - patch_size % 2


def _box_mean_in_time(tiles, patches_avg: int):
    """Each frame t of (T, F, ...) tiles replaced by the mean of frames
    [t-(avg-1)//2, t+avg//2] (clipped to the movie), by cumulative sum."""
    F = tiles.shape[1]
    lo = np.maximum(0, np.arange(F) - (patches_avg - 1) // 2)
    hi = np.minimum(F - 1, np.arange(F) + patches_avg // 2)
    cs = torch.cat([torch.zeros_like(tiles[:, :1]),
                    torch.cumsum(tiles, dim=1)], dim=1)
    n = torch.as_tensor((hi - lo + 1).astype(np.float32),
                        device=tiles.device)
    return (cs[:, hi + 1] - cs[:, lo]) / n[None, :, None, None]


def local_patch_shifts(frames, global_pos, centres, patch_size: int,
                       max_shift_px: int, patches_avg: int = 1,
                       device=None):
    """Pairwise shifts (T, P, 2) and peaks (T, P) of the patches centred
    at `centres` ((T, 2) rows and columns) after the global correction
    -global_pos, as tensors on the frames' device.

    patches_avg == 1: the integer part of each frame's correction is a
    periodic roll, gathered straight into the patches, and the fractional
    residual is folded into each patch spectrum as a separable phase (no
    full-frame FFT). patches_avg > 1: the frames are Fourier-shifted in
    chunks, the patches cut from them, and each patch frame replaced by its
    temporal box mean (GPU reference movie_alignment_correlation_gpu.cpp:179
    frame windowing)."""
    frames = as_tensor(frames, device)
    dev = frames.device
    F, H, W = frames.shape
    h = patch_size // 2
    gpos = np.asarray(global_pos, np.float32)
    gx = torch.as_tensor(-gpos[:, 0], device=dev)
    gy = torch.as_tensor(-gpos[:, 1], device=dev)
    centres = np.asarray(centres, np.int64).reshape(-1, 2)
    T = len(centres)
    offs = torch.arange(-h, h, device=dev)
    tiles = torch.empty((T, F, patch_size, patch_size), dtype=torch.float32,
                        device=dev)
    if patches_avg <= 1:
        gxi = torch.round(gx).to(torch.int64)
        gyi = torch.round(gy).to(torch.int64)
        fi = torch.arange(F, device=dev)[:, None, None]
        for t, (cy, cx) in enumerate(centres):
            rows = (int(cy) + offs[None, :] - gyi[:, None]) % H
            cols = (int(cx) + offs[None, :] - gxi[:, None]) % W
            tiles[t] = frames[fi, rows[:, :, None], cols[:, None, :]]
        specs = frame_ffts_scaled(tiles.reshape(-1, patch_size, patch_size),
                                  patch_size).reshape(
            T, F, patch_size, patch_size // 2 + 1)
        py, px = _shift_phases(gx - gxi.to(torch.float32),
                               gy - gyi.to(torch.float32), patch_size,
                               patch_size, dev)
        specs = specs * py * px
    else:
        for f0, spec in _shifted_chunks(frames, gx, gy):
            shifted = torch.fft.irfft2(spec, s=(H, W))
            for t, (cy, cx) in enumerate(centres):
                tiles[t, f0:f0 + len(spec)] = shifted[
                    :, cy - h: cy + h, cx - h: cx + h]
        tiles = _box_mean_in_time(tiles, patches_avg)
        specs = frame_ffts_scaled(tiles.reshape(-1, patch_size, patch_size),
                                  patch_size).reshape(
            T, F, patch_size, patch_size // 2 + 1)
    del tiles
    return pair_peaks(specs, patch_size, max_shift_px)


def field_from_patch_shifts(shifts, peaks, ny: int, nx: int,
                            n_frames: int) -> np.ndarray:
    """The (ny, nx, F, 2) field: one least-squares trajectory per patch
    from its (P, 2) pair shifts, weighted by max(peak, 0)."""
    shifts = np.asarray(shifts)
    peaks = np.asarray(peaks)
    pairs = _pairs(n_frames)
    field = np.zeros((ny, nx, n_frames, 2), np.float32)
    for p in range(ny * nx):
        field[p // nx, p % nx] = solve_frame_trajectory(
            shifts[p], pairs, n_frames, weights=np.maximum(peaks[p], 0))
    return field


def local_align(frames, global_pos, patches=(5, 5), patch_size: int = 256,
                max_shift_px: int = 8, patches_avg: int = 1, device=None):
    """Per-patch residual shifts after global correction.

    Returns the (ny, nx, F, 2) local shift field and the patch centres."""
    frames = as_tensor(frames, device)
    F, H, W = frames.shape
    patch_size = local_patch_size(H, W, patch_size)
    ny, nx = patches
    cys, cxs = patch_grid(H, W, ny, nx, patch_size)
    centres = [(cy, cx) for cy in cys for cx in cxs]
    shifts, peaks = local_patch_shifts(frames, global_pos, centres,
                                       patch_size, max_shift_px,
                                       int(patches_avg))
    field = field_from_patch_shifts(shifts.cpu().numpy(),
                                    peaks.cpu().numpy(), ny, nx, F)
    return field, cys, cxs


def interpolate_shift_field(field, cys, cxs, H, W):
    """Bilinear interpolation of the (ny,nx,F,2) patch field to per-pixel
    shift maps (F,H,W,2) on the host (the B-spline control grid role,
    localAlignmentControlPoints)."""
    from scipy.interpolate import RegularGridInterpolator
    ny, nx, F, _ = field.shape
    out = np.zeros((F, H, W, 2), np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    pts = np.stack([yy.ravel(), xx.ravel()], axis=1)
    for f in range(F):
        for c in range(2):
            interp = RegularGridInterpolator(
                (cys, cxs), field[:, :, f, c], bounds_error=False,
                fill_value=None)
            out[f, :, :, c] = interp(pts).reshape(H, W)
    return out


# ---------------------------------------------------------------------------
# local-motion correction (the warp)
# ---------------------------------------------------------------------------

def _tile_origins(H: int, W: int, tile: int, overlap: float):
    """The tile set of the warp: with overlap 0.5 and H, W multiples of the
    tile (and larger), offsets {0, tile//2} plus multiples of the tile (the
    reference's 4-pass tile set); otherwise a step of tile*(1-overlap)
    with a last tile flush with the far edge."""
    half = tile // 2
    if (overlap == 0.5 and H % tile == 0 and W % tile == 0
            and H > tile and W > tile):
        ys = sorted({y0 + i * tile for y0 in (0, half)
                     for i in range((H - 2 * y0) // tile)})
        xs = sorted({x0 + i * tile for x0 in (0, half)
                     for i in range((W - 2 * x0) // tile)})
        return [(y0, x0) for y0 in ys for x0 in xs], True
    step = max(int(tile * (1 - overlap)), 1)
    ys = list(range(0, max(H - tile, 0) + 1, step))
    xs = list(range(0, max(W - tile, 0) + 1, step))
    if ys[-1] != H - tile:
        ys.append(H - tile)
    if xs[-1] != W - tile:
        xs.append(W - tile)
    return [(y0, x0) for y0 in ys for x0 in xs], len(ys) * len(xs) > 1


def _field_at(field, cys, cxs, cy, cx):
    """Bilinear interpolation of the (ny, nx, F, 2) patch field at one
    point -> (F, 2), on the host."""
    iy = np.clip(np.searchsorted(cys, cy) - 1, 0, len(cys) - 2)
    ix = np.clip(np.searchsorted(cxs, cx) - 1, 0, len(cxs) - 2)
    ty = np.clip((cy - cys[iy]) / max(cys[iy + 1] - cys[iy], 1e-9), 0, 1)
    tx = np.clip((cx - cxs[ix]) / max(cxs[ix + 1] - cxs[ix], 1e-9), 0, 1)
    f00, f01 = field[iy, ix], field[iy, ix + 1]
    f10, f11 = field[iy + 1, ix], field[iy + 1, ix + 1]
    return ((1 - ty) * ((1 - tx) * f00 + tx * f01)
            + ty * ((1 - tx) * f10 + tx * f11))


def warp_sum_frames_tiled(frames, field, cys, cxs, tile: int = 512,
                          overlap: float = 0.5, device=None):
    """Gather-free local-motion correction: overlapping Hann-windowed
    tiles, each Fourier-shifted by the (bilinearly interpolated) local
    position at its centre (corrected with -position), summed over frames
    before one inverse FFT per tile, blended by the window sum. Tiles are
    processed in chunks; returns the (H, W) sum over frames."""
    frames = as_tensor(frames, device)
    dev = frames.device
    F, H, W = frames.shape
    tile = int(min(tile, H, W))
    origins, blend = _tile_origins(H, W, tile, overlap)
    # one tile covering the whole frame has no seams to blend: a window
    # there would only amplify border noise when divided back out
    win1 = (np.hanning(tile).astype(np.float32) + 1e-3) if blend \
        else np.ones(tile, np.float32)
    win = torch.as_tensor(win1[:, None] * win1[None, :], device=dev)
    field = np.asarray(field, np.float32)
    cys = np.asarray(cys, np.float64)
    cxs = np.asarray(cxs, np.float64)
    tshifts = torch.as_tensor(np.stack([
        _field_at(field, cys, cxs, y0 + tile / 2, x0 + tile / 2)
        for y0, x0 in origins]), dtype=torch.float32, device=dev)
    fyg = torch.fft.fftfreq(tile, device=dev)
    fxg = torch.fft.rfftfreq(tile, device=dev)
    out = torch.zeros((H, W), dtype=torch.float32, device=dev)
    wsum = torch.zeros((H, W), dtype=torch.float32, device=dev)
    step = _chunk(len(origins), F * tile * (12 * (tile // 2 + 1) + 4 * tile))
    for c0 in range(0, len(origins), step):
        chunk = origins[c0:c0 + step]
        tiles = torch.stack([frames[:, y0:y0 + tile, x0:x0 + tile]
                             for y0, x0 in chunk]) * win
        s = tshifts[c0:c0 + step]
        px = phase_ramp_1d(fxg, -s[..., 0])          # correct = -position
        py = phase_ramp_1d(fyg, -s[..., 1])
        spec = (torch.fft.rfft2(tiles) * py[..., :, None]
                * px[..., None, :]).sum(dim=1)
        planes = torch.fft.irfft2(spec, s=(tile, tile))
        for (y0, x0), plane in zip(chunk, planes):
            out[y0:y0 + tile, x0:x0 + tile] += plane
            wsum[y0:y0 + tile, x0:x0 + tile] += win * F
    return out / wsum.clamp(min=1e-6) * F


def warp_sum_frames(frames, shift_maps, device=None):
    """Warp each frame by its per-pixel shift map (undo local motion) with
    bilinear gathers, and sum. shift_maps (F, H, W, 2) carry measured
    content POSITIONS (x, y); the warp samples at x + s so content returns
    to its reference position."""
    frames = as_tensor(frames, device)
    F, H, W = frames.shape
    smap = as_tensor(shift_maps, frames.device)
    yy = torch.arange(H, dtype=torch.float32, device=frames.device)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=frames.device)[None, :]
    ys = yy + smap[..., 1]
    xs = xx + smap[..., 0]
    y0 = torch.floor(ys).to(torch.int64)
    x0 = torch.floor(xs).to(torch.int64)
    fy = ys - y0
    fx = xs - x0
    flat = frames.reshape(F, -1)

    def tap(dy, dx):
        idx = ((y0 + dy).clamp(0, H - 1) * W + (x0 + dx).clamp(0, W - 1))
        return flat.gather(1, idx.reshape(F, -1)).reshape(F, H, W)

    return (tap(0, 0) * (1 - fy) * (1 - fx) + tap(0, 1) * (1 - fy) * fx
            + tap(1, 0) * fy * (1 - fx) + tap(1, 1) * fy * fx).sum(dim=0)


# ---------------------------------------------------------------------------
# dose weighting (Grant & Grigorieff)
# ---------------------------------------------------------------------------

def dose_filter(n: int, n_frames: int, dose_per_frame: float,
                sampling: float, pre_dose: float = 0.0,
                voltage: float = 300.0, device=None, width: int | None = None):
    """(F, n, width//2+1) float32 frequency weights q = exp(-d / (2 Nc(k)))
    with the published critical-exposure fit Nc(k) = a k^b + c
    (a=0.24499, b=-1.6649, c=2.8141), reference movie_filter_dose.h:72;
    the critical exposure computed in float64 on the host, the weights in
    float64 on the device. `width` defaults to n (the reference's square
    weights, which do not fit the spectra of non-square frames:
    ROADMAP.md section 3)."""
    fy, fx = freq_grid_2d(n, n if width is None else width)
    k = np.sqrt(fy * fy + fx * fx) / sampling          # 1/A
    k = np.maximum(k, 1e-6)
    Nc = 0.24499 * k ** (-1.6649) + 2.8141
    if abs(voltage - 200.0) < 50.0:
        Nc = Nc * 0.8       # 200 kV correction factor (Grant & Grigorieff)
    doses = pre_dose + dose_per_frame * (np.arange(n_frames) + 1)
    Nc = as_tensor(Nc, device, torch.float64)
    doses = torch.as_tensor(doses, device=Nc.device)
    return torch.exp(-doses[:, None, None] / (2.0 * Nc[None])).to(
        torch.float32)


def filter_frames(frames, weights, device=None):
    """irfft2(rfft2(frames) * weights) per frame: (F, H, W), in chunks."""
    frames = as_tensor(frames, device)
    weights = as_tensor(weights, frames.device)
    F, H, W = frames.shape
    out = torch.empty_like(frames)
    step = _chunk(F, 16 * H * (W // 2 + 1))
    for f0 in range(0, F, step):
        sl = slice(f0, f0 + step)
        out[sl] = torch.fft.irfft2(torch.fft.rfft2(frames[sl]) * weights[sl],
                                   s=(H, W))
    return out


# scalar dose-model API (reference ProgMovieFilterDose::doseFilter/
# criticalDose/optimalDoseGivenCriticalDose/initVoltage,
# movie_filter_dose.cpp:85-122)

def voltage_scaling_factor(voltage: float) -> float:
    if 299.0 < voltage < 301.0:
        return 1.0
    if 199.0 < voltage < 201.0:
        return 0.8
    raise ValueError("acceleration voltage must be 200 or 300 kV")


def critical_dose(spatial_frequency: float, voltage: float = 300.0) -> float:
    """Nc(k) = (a·k^b + c) · voltage_scale, a=0.24499 b=-1.6649 c=2.8141."""
    return ((0.24499 * spatial_frequency ** (-1.6649) + 2.8141)
            * voltage_scaling_factor(voltage))


def dose_filter_value(dose_at_end_of_frame: float,
                      critical_dose_: float) -> float:
    return float(np.exp(-0.5 * dose_at_end_of_frame / critical_dose_))


def optimal_dose(critical_dose_: float) -> float:
    return 2.51284 * critical_dose_


# ---------------------------------------------------------------------------
# gain estimation (movie_estimate_gain)
# ---------------------------------------------------------------------------

def estimate_gain(frames, device=None) -> np.ndarray:
    """Per-pixel inverse gain from temporal statistics: the mean frame
    normalised to unit average (reference ProgMovieEstimateGain idea)."""
    mean = as_tensor(frames, device).mean(dim=0)
    m = mean.mean()
    gain = torch.where(mean > 1e-6 * m, m / mean.clamp(min=1e-12), 1.0)
    return gain.cpu().numpy().astype(np.float32)


def _rank_indices(vals, axis: int):
    """The values sorted along `axis`, and upper_bound(sorted, v) - 1 for
    each element v of its own row/column (movie_estimate_gain.cpp
    transformGrayValues*)."""
    v = vals.T.contiguous() if axis == 0 else vals.contiguous()
    s = torch.sort(v, dim=1).values
    idx = torch.searchsorted(s, v, right=True) - 1
    return (s.T, idx.T) if axis == 0 else (s, idx)


def _smooth_hist(sorted_h, weights, width: int, axis: int, single_ref: bool):
    """Gaussian-smooth the per-row/column sorted histograms across
    neighbouring rows/columns (constructSmoothHistogramsBy*), in the
    reference's order of the neighbour offsets."""
    n = sorted_h.shape[1 - axis]
    out = torch.zeros_like(sorted_h)
    wsum = torch.zeros(n, dtype=torch.float64, device=sorted_h.device)
    along = (lambda a, sl: a[:, sl]) if axis == 0 else (lambda a, sl: a[sl])
    for k in range(-width, width + 1):
        if abs(k) >= n:
            continue
        w = float(weights[abs(k)])
        dst = slice(max(-k, 0), n - max(k, 0))
        src = slice(max(k, 0), n - max(-k, 0))
        along(out, dst).add_(w * along(sorted_h, src))
        wsum[dst] += w
    out /= wsum[None, :] if axis == 0 else wsum[:, None]
    if single_ref:
        out[:] = out.mean(dim=1 - axis, keepdim=True)
    return out


def estimate_gain_histogram(frames, n_iter: int = 3, sigma: float = -1.0,
                            max_sigma: float = 3.0, sigma_step: float = 0.5,
                            frame_step: int = 1, single_ref: bool = False,
                            gain0=None, verbose: int = 0,
                            device=None) -> np.ndarray:
    """Reference ProgMovieEstimateGain::run (movie_estimate_gain.cpp:
    67-530): iterative rank-histogram gain, in float64 on the device. Each
    frame's per-column/per-row sorted histograms are smoothed across
    neighbouring columns/rows (sigma chosen by minimal total variation if
    sigma<0) and the frame is replaced by the smoothed value at each
    pixel's own rank; the gain is sumIdeal/sumObs, mean-normalized.
    Returns IGain (Observed = Ideal * Gain) as float32 numpy."""
    frames = as_tensor(frames, device, dtype=None)
    dev = frames.device
    used = frames[::max(frame_step, 1)]
    igain = torch.ones(frames.shape[1:], dtype=torch.float64, device=dev) \
        if gain0 is None else as_tensor(gain0, dev, torch.float64).clone()
    sum_obs = 2.0 * used.to(torch.float64).sum(dim=0)
    sigmas = [i * sigma_step
              for i in range(int(max_sigma / sigma_step) + 1)]
    widths = [int(np.ceil(3 * s)) for s in sigmas]
    weights = [np.exp((-0.5 / (s * s) if s > 0 else 0.0)
                      * np.arange(w + 1) ** 2) if s > 0
               else np.ones(w + 1) for s, w in zip(sigmas, widths)]

    def tv(img, axis):
        return float(torch.diff(img, dim=axis).abs().mean())

    for it in range(n_iter):
        sum_ideal = torch.zeros_like(sum_obs)
        for f in used:
            ideal = f.to(torch.float64) / igain
            colH, idxC = _rank_indices(ideal, axis=0)
            rowH, idxR = _rank_indices(ideal, axis=1)
            if sigma >= 0:
                s_best = int(np.argmin([abs(s - sigma) for s in sigmas]))
                sC = sR = s_best
            else:
                # TV-minimizing sigma; the rank indices are reused so only
                # the smoothing changes per candidate
                tvC, tvR = [], []
                for s in range(len(sigmas)):
                    sm = _smooth_hist(colH, weights[s], widths[s], 0,
                                      single_ref)
                    tvC.append(tv(sm.gather(0, idxC), 1))
                    sm = _smooth_hist(rowH, weights[s], widths[s], 1,
                                      single_ref)
                    tvR.append(tv(sm.gather(1, idxR), 0))
                sC, sR = int(np.argmin(tvC)), int(np.argmin(tvR))
            smR = _smooth_hist(rowH, weights[sR], widths[sR], 1, single_ref)
            sum_ideal += smR.gather(1, idxR)
            smC = _smooth_hist(colH, weights[sC], widths[sC], 0, single_ref)
            sum_ideal += smC.gather(0, idxC)
        small = sum_obs.abs() < 1e-6
        igain = torch.where(small, 1.0, sum_ideal /
                            torch.where(small, 1.0, sum_obs))
        igain /= igain.mean()
        if verbose:
            print(f"Gain iteration {it}: spread {float(igain.std()):.5f}")
    return igain.cpu().numpy().astype(np.float32)
