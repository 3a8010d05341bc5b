"""Monogenic signal and local resolution (the MonoRes family), in torch.

Counterpart of the reference package's ops/monogenic.py (the reference
data/monogenic_signal and resolution_monogenic_signal.cpp:349-460): the
Riesz transform is three multiplies in Fourier space, each MonoRes band
is a mask-multiply of ONE forward transform and one batched inverse
transform of four spectra, and the significance test compares voxel
amplitudes with the exact order statistic (or the Gaussian model) of the
noise amplitudes. FSO's directional cones are batched on the device with
float64 shell sums (index_add_). Layouts are the reference's: rfftn with
fftfreq/rfftfreq grids for the volumes, full complex fft2 for
phase_cong_mono.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor
from xmipp3_tpu_torch.ops.fourier import freq_grid_3d

# elements of a (directions x voxels) float64 block of FSO's cone sums
FSO_BLOCK = 1 << 26


def _riesz_kernels(D, H, W):
    fz, fy, fx = freq_grid_3d(D, H, W)
    r = np.sqrt(fz * fz + fy * fy + fx * fx)
    r = np.where(r == 0, 1.0, r)
    return (fx / r).astype(np.float32), (fy / r).astype(np.float32), \
        (fz / r).astype(np.float32)


@lru_cache(maxsize=4)
def _riesz_on(D: int, H: int, W: int, device: torch.device):
    """The Riesz kernels of one shape on one device, made once (on the
    H100 their upload was 16.6 of a 256^3 x 12 amplitude's 36.6 ms)."""
    return tuple(torch.as_tensor(k, device=device)
                 for k in _riesz_kernels(D, H, W))


def freq_radius_3d(D, H, W, device):
    """The (D, H, W//2+1) float32 frequency radius of the rfftn layout and
    its three components, on `device`."""
    fz = torch.fft.fftfreq(D, device=device)[:, None, None]
    fy = torch.fft.fftfreq(H, device=device)[None, :, None]
    fx = torch.fft.rfftfreq(W, device=device)[None, None, :]
    return torch.sqrt(fz ** 2 + fy ** 2 + fx ** 2), fz, fy, fx


def _amplitude(spec, ux, uy, uz, shape):
    """sqrt(b^2 + rx^2 + ry^2 + rz^2) of the band `spec` (rfftn layout) and
    its Riesz components 1j*u*spec, with one batched inverse transform."""
    stack = torch.stack([spec, 1j * ux * spec, 1j * uy * spec,
                         1j * uz * spec])
    b, rx, ry, rz = torch.fft.irfftn(stack, s=shape, dim=(-3, -2, -1))
    return torch.sqrt(b ** 2 + rx ** 2 + ry ** 2 + rz ** 2)


def monogenic_amplitude_3d(vol, device=None):
    """sqrt(f^2 + |R f|^2): local amplitude of the monogenic signal of a
    volume, or of each volume of a (..., D, H, W) batch."""
    vol = as_tensor(vol, device)
    D, H, W = vol.shape[-3:]
    dims = (-3, -2, -1)
    kx, ky, kz = _riesz_on(D, H, W, vol.device)
    F = torch.fft.rfftn(vol, dim=dims)
    rx, ry, rz = torch.fft.irfftn(
        torch.stack([1j * kx * F, 1j * ky * F, 1j * kz * F]), s=(D, H, W),
        dim=dims)
    return torch.sqrt(vol * vol + rx * rx + ry * ry + rz * rz)


def phase_cong_mono(im, n_scale: int = 2, min_wavelength: float = 80.0,
                    mult: float = 1.25, sigma_onf: float = 2.0, device=None):
    """2-D monogenic phase congruency (Kovesi-style log-Gabor scales +
    Riesz transform), reference data/wavelet.cpp:850-1025 phaseCongMono as
    the reference package computes it: butterworth lowpass cutoff .4 order
    10, DC radius substituted to 1, Or=atan2(h1,h2), Ph=atan2(F,|h|),
    Energy=sqrt(F^2+h1^2+h2^2)+1e-4, with the Riesz kernel in the same fft
    layout as the spectrum. Returns (Ph, Or, Energy) float32 tensors."""
    im = as_tensor(im, device)
    dev = im.device
    H, W = im.shape
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    wy = torch.fft.fftfreq(H, device=dev)[:, None]
    wx = torch.fft.fftfreq(W, device=dev)[None, :]
    r = torch.sqrt(wy * wy + wx * wx)
    r0 = torch.where(r < 1e-10, 1.0, r)            # DC substitution (ref :901)
    lowpass = 1.0 / (1.0 + (r0 / 0.4) ** 10)
    spec = torch.fft.fft2(im)
    riesz = torch.complex(wy.expand(H, W), wx.expand(H, W)) / r0
    log_so2 = 2.0 * torch.log(f32(sigma_onf)) ** 2
    F = torch.zeros((H, W), dtype=torch.float32, device=dev)
    h1 = torch.zeros_like(F)
    h2 = torch.zeros_like(F)
    for s in range(n_scale):
        fo = 1.0 / (f32(min_wavelength) * f32(mult) ** s)
        lg = torch.exp(-torch.log(r0 / fo) ** 2 / log_so2) * lowpass
        bp = spec * lg
        f = torch.fft.ifft2(bp)
        h = torch.fft.ifft2(bp * riesz)
        F = F + f.real
        h1 = h1 + h.real
        h2 = h2 + h.imag
    ph = torch.atan2(F, torch.sqrt(h1 * h1 + h2 * h2))
    orient = torch.atan2(h1, h2)
    energy = torch.sqrt(F * F + h1 * h1 + h2 * h2) + 1e-4
    return ph, orient, energy


def bandpass_3d(vol, w1, w2, device=None):
    """Raised-cosine bandpass in digital frequency (float32 cutoffs)."""
    vol = as_tensor(vol, device)
    D, H, W = vol.shape
    r = freq_radius_3d(D, H, W, vol.device)[0]
    f32 = lambda v: torch.tensor(float(v), dtype=torch.float32,
                                 device=vol.device)
    rw = 0.02
    lo = torch.clamp((r - (f32(w1) - rw)) / rw, 0.0, 1.0)
    hi = torch.clamp(((f32(w2) + rw) - r) / rw, 0.0, 1.0)
    mask = 0.5 * (1 - torch.cos(torch.pi * lo)) * 0.5 * \
        (1 - torch.cos(torch.pi * hi))
    return torch.fft.irfftn(torch.fft.rfftn(vol) * mask, s=(D, H, W))


def percentile_linear(x, qs):
    """np.percentile(x, qs, axis=-1) (method "linear") of a float tensor,
    on its device: numpy's own float64 index arithmetic on the host, the
    order statistics from one sort of the last axis (on the H100, sorting
    12.5M values takes 0.73 ms where torch.kthvalue takes 50; PERF.md), and
    numpy's interpolation (the difference of the two order statistics in
    the input's type, the rest in float64). x (..., n) -> float64
    (..., len(qs))."""
    n = x.shape[-1]
    q = np.true_divide(np.asarray(qs, np.float64), 100)
    virt = n * q + (1 + q * (1 - 1 - 1)) - 1
    prev = np.floor(virt).astype(np.int64)
    prev[virt >= n - 1] = n - 1
    prev[virt < 0] = 0
    nxt = np.minimum(prev + 1, n - 1)
    nxt[virt >= n - 1] = n - 1
    gamma = virt - np.floor(virt)
    gamma[(virt >= n - 1) | (virt < 0)] = 0.0
    s = torch.sort(x, dim=-1).values
    a = s[..., torch.as_tensor(prev, device=x.device)]
    b = s[..., torch.as_tensor(nxt, device=x.device)]
    return _lerp(a, b, torch.as_tensor(gamma, device=x.device))


def _lerp(a, b, t):
    """numpy's _lerp of float32 bounds a, b with float64 weights t."""
    diff = (b - a).to(torch.float64)
    a, b = a.to(torch.float64), b.to(torch.float64)
    return torch.where(t >= 0.5, b - diff * (1 - t), a + diff * t)


def _monores_bands(vol, noise, mask, noise_region, freqs, significance,
                   has_noise_vol, noise_in_mask, gaussian):
    """Per-band monogenic hypothesis test on the device: the band mask from
    the frequency radius grid, the amplitude by one inverse transform of
    four spectra (resolution_monogenic_signal.cpp:349-460).

    Noise model (reference flags):
    - default: noise = signal amplitudes in `noise_region` (outside the
      mask minus any --maskExcl region);
    - `has_noise_vol` (two half maps): noise = amplitudes of the
      half-difference map, over the same region, or inside the mask when
      `noise_in_mask` (--noiseonlyinhalves);
    - threshold = the exact order statistic int(significance*(n-1)) of the
      region's noise amplitudes (a sort of those values alone), or mean +
      z_crit*std when `gaussian`.

    A running "still resolved" mask gives the count of leading bands that
    each voxel resolves and the resolved fraction per band, without the
    (K, D, H, W) stack. Returns (count int32 tensor, frac float32 numpy)."""
    D, H, W = vol.shape
    dev = vol.device
    r, fz, fy, fx = freq_radius_3d(D, H, W, dev)
    rr = torch.clamp(r, min=1e-12)
    uz, uy, ux = fz / rr, fy / rr, fx / rr
    F = torch.fft.rfftn(vol)
    FN = torch.fft.rfftn(noise) if has_noise_vol else None
    region = mask if (has_noise_vol and noise_in_mask) else noise_region
    ridx = torch.nonzero(region.reshape(-1)).reshape(-1)
    n_noise = int(ridx.numel())
    # the reference's float32 index arithmetic: int(significance*(n-1))
    k = int(np.float32(significance) * np.float32(n_noise - 1))
    z_crit = (torch.sqrt(torch.tensor(2.0)) * torch.special.erfinv(
        torch.tensor(2.0 * significance - 1.0))).to(dev)
    still = mask.clone()
    count = torch.zeros((D, H, W), dtype=torch.int32, device=dev)
    resolved = []
    freqs_t = torch.as_tensor(np.asarray(freqs, np.float32), device=dev)
    for f in freqs_t:
        bmask = ((r >= torch.clamp(f - 0.02, min=0.001))
                 & (r <= torch.clamp(f + 0.02, max=0.5))).to(torch.float32)
        amp = _amplitude(F * bmask, ux, uy, uz, (D, H, W))
        amp_n = _amplitude(FN * bmask, ux, uy, uz, (D, H, W)) \
            if has_noise_vol else amp
        vals = amp_n.reshape(-1)[ridx]
        if n_noise == 0:
            thresh = torch.tensor(-torch.inf, device=dev)
        elif gaussian:
            mean_n = vals.sum() / n_noise
            var_n = ((vals - mean_n) ** 2).sum() / n_noise
            thresh = mean_n + z_crit * torch.sqrt(var_n)
        else:
            thresh = torch.sort(vals).values[k]
        still &= mask & (amp > thresh)
        count += still
        resolved.append(still.sum())
    frac = (torch.stack(resolved).to(torch.float32)
            / max(int(mask.sum()), 1)).cpu().numpy()
    return count, frac


def local_resolution_monores(vol, mask, sampling: float,
                             min_res: float | None = None,
                             max_res: float | None = None,
                             n_freqs: int = 30,
                             significance: float = 0.95,
                             noise_vol=None,
                             mask_excl=None,
                             noise_only_in_halves: bool = False,
                             gaussian: bool = False,
                             step: float | None = None,
                             device=None):
    """MonoRes local resolution map.

    For each tested frequency band, voxels whose monogenic amplitude exceeds
    the `significance` order statistic of the noise amplitudes (outside the
    mask) are resolved at that frequency; a voxel's resolution is that of
    the last band of its leading run of resolved bands. Returns (res_map
    float32 tensor in Angstroms, freqs, fraction resolved per freq)."""
    vol = as_tensor(vol, device)
    dev = vol.device
    mask = as_tensor(mask, dev, None) > 0.5
    if min_res is None:
        min_res = vol.shape[0] * sampling / 3
    if max_res is None:
        max_res = 2.2 * sampling
    f_lo = sampling / min_res
    f_hi = min(sampling / max_res, 0.45)
    if step is not None and step > 0:
        # resolutions swept from minRes down to maxRes in steps of `step`
        # Angstroms (--step)
        res_list = np.arange(min_res, max(max_res, sampling / 0.45),
                             -step, dtype=np.float32)
        freqs = np.clip(sampling / res_list, f_lo, f_hi).astype(np.float32)
        freqs = np.unique(freqs)
    else:
        freqs = np.linspace(f_lo, f_hi, n_freqs).astype(np.float32)
    noise_region = ~mask
    if mask_excl is not None:
        noise_region &= ~(as_tensor(mask_excl, dev, None) > 0.5)
    has_noise = noise_vol is not None
    noise = as_tensor(noise_vol, dev) if has_noise else vol
    count, frac = _monores_bands(vol, noise, mask, noise_region, freqs,
                                 float(significance), has_noise,
                                 bool(noise_only_in_halves), bool(gaussian))
    table = torch.as_tensor(
        np.concatenate([[min_res], sampling / freqs]).astype(np.float32),
        device=dev)
    return table[count.to(torch.int64)], freqs, frac


def fso_directional(vol1, vol2, sampling: float, n_dirs: int = 60,
                    cone_deg: float = 20.0, threshold: float = 0.143,
                    compute_3dfsc: bool = False, device=None):
    """Fourier Shell Occupancy: fraction of directions whose conical FSC
    stays above threshold, per shell (reference resolution_fso.h:38).

    The cones are evaluated in blocks of directions: a block's selection
    (|u.d| >= cos(cone), in float64) weights the cross and power spectra,
    and one float64 index_add_ per block sums them into shells. With
    `compute_3dfsc` also returns the 3DFSC (per-voxel mean of the
    directional FSC over the cones containing the voxel, rfftn layout) and
    the map irfftn(mean(F1, F2) * 3DFSC) (reference --threedfsc_filter),
    both float32 tensors."""
    from xmipp3_tpu_torch.core.sampling import (compute_sampling_points,
                                                directions_from_angles)
    vol1 = as_tensor(vol1, device)
    dev = vol1.device
    vol2 = as_tensor(vol2, dev)
    D, H, W = vol1.shape
    nbins = D // 2
    F1 = torch.fft.rfftn(vol1)
    F2 = torch.fft.rfftn(vol2)
    fz, fy, fx = freq_grid_3d(D, H, W)
    r = np.sqrt(fz ** 2 + fy ** 2 + fx ** 2)
    bins_np = np.minimum((r / 0.5 * nbins).astype(np.int32), nbins - 1)
    rr = np.where(r == 0, 1.0, r)
    un = torch.as_tensor(np.stack(np.broadcast_arrays(fx / rr, fy / rr,
                                                      fz / rr), axis=-1)
                         .reshape(-1, 3), dtype=torch.float64, device=dev)
    bins = torch.as_tensor(bins_np.ravel(), dtype=torch.int64, device=dev)
    Nv = bins.numel()

    angles = compute_sampling_points(180.0 / np.sqrt(n_dirs))
    dirs = directions_from_angles(angles)
    dirs = dirs[dirs[:, 2] >= 0][:n_dirs]       # half sphere (cones symmetric)
    cos_cone = np.cos(np.deg2rad(cone_deg))

    values = torch.stack([(F1 * F2.conj()).real, F1.abs() ** 2,
                          F2.abs() ** 2]).reshape(3, 1, Nv).to(torch.float64)
    dirs_t = torch.as_tensor(dirs, dtype=torch.float64, device=dev)
    sums = torch.zeros((3, len(dirs), nbins), dtype=torch.float64,
                       device=dev)
    block = max(1, FSO_BLOCK // Nv)
    sels = []
    for d0 in range(0, len(dirs), block):
        sel = (un @ dirs_t[d0:d0 + block].T).abs().T >= cos_cone  # (b, Nv)
        part = (values * sel).reshape(-1, Nv)
        acc = torch.zeros((part.shape[0], nbins), dtype=torch.float64,
                          device=dev).index_add_(1, bins, part)
        sums[:, d0:d0 + block] = acc.reshape(3, -1, nbins)
        if compute_3dfsc:
            sels.append((d0, sel))
    num, d1, d2 = sums
    fsc_d = num / torch.clamp(torch.sqrt(d1 * d2), min=1e-12)
    fso = (fsc_d > threshold).to(torch.float64).mean(dim=0).cpu().numpy()
    freqs = (np.arange(nbins) + 0.5) * (0.5 / nbins)
    if not compute_3dfsc:
        return freqs, fso
    w_sum = torch.zeros(Nv, dtype=torch.float64, device=dev)
    w_cnt = torch.zeros(Nv, dtype=torch.float64, device=dev)
    clipped = fsc_d.clamp(0.0, 1.0)
    for d0, sel in sels:
        w_sum += (clipped[d0:d0 + len(sel)][:, bins] * sel).sum(dim=0)
        w_cnt += sel.sum(dim=0)
    fsc3d = (w_sum / w_cnt.clamp(min=1.0)).reshape(bins_np.shape)
    fsc3d[torch.as_tensor(r == 0, device=dev)] = 1.0
    fmean = 0.5 * (F1 + F2)
    filtered = torch.fft.irfftn(fmean.to(torch.complex128) * fsc3d,
                                s=(D, H, W)).to(torch.float32)
    return freqs, fso, fsc3d.to(torch.float32), filtered


def local_filter_by_resolution(vol, res_map, sampling: float,
                               n_bands: int = 12, device=None):
    """Locally low-pass filter a map according to a local-resolution map
    (reference resolution_localfilter / LocalDeblur application step):
    each voxel takes its value from the band-limited version matching its
    local resolution (piecewise over n_bands). Returns a float32 tensor."""
    vol = as_tensor(vol, device)
    res_map = as_tensor(res_map, vol.device)
    lo, hi = percentile_linear(res_map.reshape(-1), [2, 98]).tolist()
    lo = max(lo, 2.0 * sampling)
    bands = np.linspace(lo, max(hi, lo + 1e-3), n_bands)
    res64 = res_map.to(torch.float64)
    out = torch.zeros_like(vol)
    assigned = torch.zeros(vol.shape, dtype=torch.bool, device=vol.device)
    for res in bands:
        filtered = bandpass_3d(vol, 0.0, sampling / res)
        sel = (~assigned) & (res64 <= res)
        out = torch.where(sel, filtered, out)
        assigned |= sel
    filtered = bandpass_3d(vol, 0.0, sampling / bands[-1])
    return torch.where(assigned, out, filtered)
