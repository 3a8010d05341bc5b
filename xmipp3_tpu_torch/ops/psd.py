"""PSD estimation: periodogram averaging over overlapped windowed tiles.

Counterpart of the reference package's ops/psd.py (the reference
PSDEstimator, reconstruction/psd_estimator.cpp:74, and the piece loop of
ctf_estimate_from_micrograph.cpp:310-350): only the micrograph goes to the
card, the tiles are gathered there by their start offsets (the last offset
of an axis, n - piece, lies off the step grid, so this is a gather and not
an unfold), and the windowed |FFT|^2 of every tile is averaged in one
batched rfft2. Tile and patch geometry, the Hermitian expansions and the
display normalisation are host numpy, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor
from xmipp3_tpu_torch.ops.mask import raised_cosine_window_1d


def tile_positions(n: int, piece: int, overlap: float = 0.5) -> np.ndarray:
    """Start offsets of overlapped tiles covering an axis (reference
    division math, ctf_estimate_from_micrograph.cpp:310-327)."""
    step = max(int(piece * (1.0 - overlap)), 1)
    pos = list(range(0, max(n - piece, 0) + 1, step))
    if pos and pos[-1] != n - piece:
        pos.append(n - piece)
    return np.array(pos or [0], np.int32)


def extract_tiles(mic: np.ndarray, piece: int, overlap: float = 0.5):
    """(H,W) -> (T, piece, piece) tile stack, on the host."""
    H, W = mic.shape
    ys = tile_positions(H, piece, overlap)
    xs = tile_positions(W, piece, overlap)
    tiles = np.empty((len(ys) * len(xs), piece, piece), np.float32)
    k = 0
    for y0 in ys:
        for x0 in xs:
            tiles[k] = mic[y0:y0 + piece, x0:x0 + piece]
            k += 1
    return tiles


def gather_pieces(mic: torch.Tensor, y0s, x0s, piece: int) -> torch.Tensor:
    """The (len(y0s), piece, piece) pieces of a (H, W) tensor whose corners
    are the pairs (y0s[k], x0s[k]), gathered on its device."""
    ar = torch.arange(piece, device=mic.device)
    rows = torch.as_tensor(np.asarray(y0s), device=mic.device)[:, None] + ar
    cols = torch.as_tensor(np.asarray(x0s), device=mic.device)[:, None] + ar
    return mic[rows[:, :, None], cols[:, None, :]]


def gather_tiles(mic: torch.Tensor, ys, xs, piece: int) -> torch.Tensor:
    """The (len(ys)·len(xs), piece, piece) tiles of a (H, W) tensor at the
    start offsets ys × xs (row-major), gathered on its device."""
    yy, xx = np.meshgrid(np.asarray(ys), np.asarray(xs), indexing="ij")
    return gather_pieces(mic, yy.ravel(), xx.ravel(), piece)


def periodogram_average(tiles, window, device=None):
    """Mean windowed |FFT|^2 / N over the tile stack -> rfft-layout PSD."""
    t = as_tensor(tiles, device)
    t = t - t.mean(dim=(-2, -1), keepdim=True)
    t = t * as_tensor(window, t.device)[None]
    N = t.shape[-1] * t.shape[-2]
    return (torch.fft.rfft2(t).abs() ** 2 / N).mean(dim=0)


def tile_window(piece: int) -> np.ndarray:
    """The separable raised-cosine piece window of estimate_psd."""
    w1 = raised_cosine_window_1d(piece, overlap_frac=0.4)
    return np.outer(w1, w1).astype(np.float32)


def estimate_psd(mic, piece: int = 512, overlap: float = 0.5, device=None):
    """Micrograph -> averaged PSD (rfft layout, (piece, piece//2+1)) as a
    tensor on the micrograph's device (numpy goes to `device`, the card by
    default). Only the micrograph crosses to the card; the tiles are
    gathered there."""
    mic = as_tensor(mic, device)
    mic = mic.reshape(mic.shape[-2:]) if mic.ndim > 2 else mic
    piece = min(piece, *mic.shape)
    ys = tile_positions(mic.shape[0], piece, overlap)
    xs = tile_positions(mic.shape[1], piece, overlap)
    return periodogram_average(gather_tiles(mic, ys, xs, piece),
                               tile_window(piece))


def psd_half_to_full_centered(psd_half, n: int):
    """rfft-layout PSD -> full centered (fftshifted) image for display/fit
    (reference half2whole, psd_estimator.h:53)."""
    if isinstance(psd_half, torch.Tensor):
        psd_half = psd_half.cpu().numpy()
    psd_half = np.asarray(psd_half)
    full = np.zeros((n, n), np.float32)
    h = psd_half.shape[1]
    full[:, :h] = psd_half
    # mirror: P(-f) = P(f)
    for xi in range(h, n):
        src = (n - xi) % n
        full[:, xi] = psd_half[(-np.arange(n)) % n, src]
    return np.fft.fftshift(full)


def radial_profile(psd_half, nbins: int | None = None, device=None):
    """Radially averaged 1-D profile of an rfft-layout PSD: (freqs, prof),
    numpy; the average runs on the tensor's device (numpy goes to
    `device`)."""
    from xmipp3_tpu_torch.ops.fourier import radial_average_half
    H = psd_half.shape[0]
    if nbins is None:
        nbins = H // 2
    prof = radial_average_half(as_tensor(psd_half, device)[None],
                               nbins)[0].cpu().numpy()
    freqs = (np.arange(nbins) + 0.5) * (0.5 / nbins)
    return freqs, prof


def get_patches_location(borders, mic_dims, patch_dims, overlap: float):
    """Patch rectangles (xs, ys, xe, ye), inclusive, exactly the reference
    PSDEstimator::getPatchesLocation stepping (psd_estimator.cpp:35-71)."""
    bx, by = borders
    mx, my = mic_dims
    px, py = patch_dims
    step_x = max(int((1.0 - overlap) * px), 1)
    step_y = max(int((1.0 - overlap) * py), 1)
    max_x = mx - bx - px
    max_y = my - by - py
    out = []
    y = by
    while y < max_y + step_y:
        ys = min(y, max_y)
        x = bx
        while x < max_x + step_x:
            xs = min(x, max_x)
            out.append((xs, ys, xs + px - 1, ys + py - 1))
            x += step_x
        y += step_y
    return out


def half2whole(half: np.ndarray) -> np.ndarray:
    """Expand an rfft half-spectrum (sy, fx) to the full (sy, sx) plane by
    Hermitian mirroring: out[y, sx-1-x] = in[(sy-y) % sy, x+1]
    (PSDEstimator::half2whole), assuming an even full size (use
    half2whole_sized for explicit sizes)."""
    half = np.asarray(half)
    sy, fx = half.shape
    sx = (fx - 1) * 2 if (fx - 1) * 2 >= fx else fx
    return half2whole_sized(half, sx)


def half2whole_sized(half: np.ndarray, sx: int) -> np.ndarray:
    half = np.asarray(half)
    sy, fx = half.shape
    out = np.empty((sy, sx), half.dtype)
    out[:, :fx] = half
    for x in range(sx - fx):
        x_in = x + 1
        y_in = (sy - np.arange(sy)) % sy
        out[:, sx - x - 1] = half[y_in, x_in]
    return out


def _piece_smoother(py: int, px: int) -> np.ndarray:
    """The reference border-attenuation window
    (ProgCTFEstimateFromMicrograph::constructPieceSmoother,
    ctf_estimate_from_micrograph.cpp:145-190): separable raised cosine over
    the outer alpha=2.5% of each centered axis."""
    alpha = 0.025
    out = np.ones((py, px))
    for axis, n in ((0, py), (1, px)):
        coords = np.abs((np.arange(n) - n // 2) * (2.0 / n))
        m = np.where(coords > 1 - alpha,
                     0.5 * (1 + np.cos(np.pi * ((coords - 1) / alpha + 1))),
                     1.0)
        out *= m[:, None] if axis == 0 else m[None, :]
    return out


def estimate_psd_reference(mic: np.ndarray, overlap: float = 0.4,
                           patch=(384, 384), normalize: bool = True,
                           device=None):
    """The psd_estimate program engine (PSDEstimator::estimatePSD,
    psd_estimator.cpp:74-150): overlapped patches -> per-patch (0,1)
    normalization -> piece smoother -> summed |FFT| magnitude ->
    Hermitian full plane -> optional 10·log10 display normalization. The
    patches are gathered and transformed on `device` (the card by
    default) in one batch; the expansion and normalisation are host
    numpy."""
    mic = np.asarray(mic, np.float32)
    H, W = mic.shape
    px, py = patch
    rects = get_patches_location((0, 0), (W, H), (px, py), overlap)
    m = as_tensor(mic, device)
    ar_y = torch.arange(py, device=m.device)
    ar_x = torch.arange(px, device=m.device)
    y0 = torch.as_tensor([r[1] for r in rects], device=m.device)
    x0 = torch.as_tensor([r[0] for r in rects], device=m.device)
    t = m[(y0[:, None] + ar_y)[:, :, None], (x0[:, None] + ar_x)[:, None, :]]
    mean = t.mean(dim=(-2, -1), keepdim=True)
    std = torch.clamp(t.std(dim=(-2, -1), keepdim=True, correction=0),
                      min=1e-12)
    t = (t - mean) / std
    t = t * as_tensor(_piece_smoother(py, px).astype(np.float32), m.device)
    mags = torch.fft.rfft2(t).abs().sum(dim=0).cpu().numpy()
    psd = half2whole_sized(mags, px)
    if normalize:
        pos = psd > 0
        minv = 10 * np.log10(psd[pos].min()) if pos.any() else 0.0
        psd = np.where(pos, 10 * np.log10(np.maximum(psd, 1e-30)), minv)
        # outlier rejection (reference reject_outliers): clamp beyond
        # 3 sigma of the map statistics
        m, s = psd.mean(), psd.std()
        psd = np.clip(psd, m - 3 * s, m + 3 * s)
    return psd.astype(np.float32)
