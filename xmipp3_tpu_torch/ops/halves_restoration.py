"""Volume restoration from two half-maps.

Counterpart of the reference package's ops/halves_restoration.py (the
reference's volume_halves_restoration.cpp: run 121-169, estimateS 171-215,
significanceRealSpace 217-249, deconvolveS/convolveS/optimizeSigma
251-336, filterBank 338-452, evaluateDifference 454-491; and the FFTW
alias-free flow of reconstruction_cuda/cuda_volume_halves_restorator.cpp:
121-170). Every step runs on `device` (default: the card) in float32
with torch.fft:

- the reference's CDF class tabulates 200 sample quantiles; here, as in
  the reference package, the exact empirical CDF: one sort and a
  `torch.searchsorted` per query batch (`ecdf_prob`);
- the sigma fit stays a 2-parameter scipy Powell on the host, each cost
  evaluated on the card (one host read per evaluation);
- the filter bank loops over its bands, each band's two inverse FFTs,
  noise sort and weights at once.
"""
from __future__ import annotations

import numpy as np
import torch


def make_r2(shape):
    """Squared digital frequency |f|^2 on the rfftn grid (reference
    produceSideInfo, FFT_IDX2DIGFREQ), float32 numpy."""
    d, h, w = shape
    fz = np.fft.fftfreq(d)
    fy = np.fft.fftfreq(h)
    fx = np.fft.rfftfreq(w)
    return (fz[:, None, None] ** 2 + fy[None, :, None] ** 2 +
            fx[None, None, :] ** 2).astype(np.float32)


def _rfftn(v):
    return torch.fft.rfftn(v, dim=(-3, -2, -1))


def _irfftn(f, shape):
    return torch.fft.irfftn(f, s=tuple(shape), dim=(-3, -2, -1))


def ecdf_prob(sorted_vals, n_valid, q):
    """P(X <= q) under the empirical CDF of the sorted 1-D `sorted_vals`
    (invalid entries pushed to +inf; only the first `n_valid` count)."""
    idx = torch.searchsorted(sorted_vals, q.reshape(-1).contiguous(),
                             right=True)
    return (torch.clamp(idx, max=n_valid) / n_valid).reshape(q.shape) \
        .to(torch.float32)


def estimate_s(v1r, v2r, mask, r2, shape):
    """S = lowpass(max(mask*(V1r+V2r)/2, 0)) with the sorted masked S^2
    table of the signal CDF and its valid count (reference estimateS)."""
    s = torch.clamp(0.5 * (v1r + v2r) * mask, min=0.0)
    s = _irfftn(torch.where(r2 > 0.25, 0.0, _rfftn(s)), shape)
    inside = mask.reshape(-1) > 0
    aux = torch.where(inside, (s * s).reshape(-1), float("inf"))
    return s, torch.sort(aux)[0], inside.sum()


def significance_real_space(vi, s, cdf_s, n_valid):
    """Vir = pS*pN*Vi where the voxel energy is not already the largest
    noise energy (reference significanceRealSpace)."""
    n = (vi - s) ** 2
    cdf_n = torch.sort(n.reshape(-1))[0]
    e = vi * vi
    p_n = ecdf_prob(cdf_n, n.numel(), e)
    p_s = ecdf_prob(cdf_s, n_valid, e)
    return torch.where(p_n < 1.0, p_s * p_n * vi, vi)


def sigma_cost(f_s, f_v1, f_v2, r2, sig):
    """sum over R2<=0.25 of |fS*H1-fV1| + |fS*H2-fV2| (reference
    restorationSigmaCost), a 0-d tensor; out-of-range sigmas are barriered
    on the host."""
    h1 = torch.exp(-0.5 / (sig[0] * sig[0]) * r2)
    h2 = torch.exp(-0.5 / (sig[1] * sig[1]) * r2)
    err = torch.abs(f_s * h1 - f_v1) + torch.abs(f_s * h2 - f_v2)
    return torch.where(r2 <= 0.25, err, 0.0).sum()


def forward_ffts(s, v1r, v2r, shape):
    return _rfftn(s), _rfftn(v1r), _rfftn(v2r)


def deconvolve_s(f_s, f_v1, f_v2, r2, lam, sig1, sig2, shape):
    """One deconvolution step (reference deconvolveS): the two-sigma
    Wiener combination for S and per-half Gaussian division for V1r/V2r,
    inside the R2<=0.25 band only."""
    h1 = torch.exp(-0.5 / (sig1 * sig1) * r2)
    h2 = torch.exp(-0.5 / (sig2 * sig2) * r2)
    inband = r2 <= 0.25
    f_vol = torch.where(
        inband, (h1 * f_v1 + h2 * f_v2) / (h1 * h1 + h2 * h2 + lam * r2),
        f_s)
    f_v1 = torch.where(inband, f_v1 / h1, f_v1)
    f_v2 = torch.where(inband, f_v2 / h2, f_v2)
    return f_vol, _irfftn(f_v1, shape), _irfftn(f_v2, shape)


def convolve_s(f_vol, r2, sigma, shape):
    """Re-convolve the deconvolved spectrum with the mean-sigma Gaussian
    (reference convolveS)."""
    k = -0.5 / (sigma * sigma)
    return _irfftn(torch.where(r2 <= 0.25, f_vol * torch.exp(k * r2),
                               f_vol), shape)


def n_bands(bank_step: float, bank_overlap: float) -> int:
    return int(np.ceil(0.5 / (bank_step * (1.0 - bank_overlap)) - 1e-9))


def filter_bank_bands(f_v1, f_v2, r2, shape, ws, bank_step, weight_fun,
                      weight_power):
    """Sums over the bands starting at the frequencies `ws` (a sequence of
    floats) of the probability-weighted band images of both halves and of
    the per-voxel stronger one: (m_v1r, m_v2r, m_s), unscaled."""
    zero = torch.zeros(tuple(shape), device=r2.device)
    m_v1r, m_v2r, m_s = zero, zero.clone(), zero.clone()
    step2 = np.float32(bank_step)
    for w in ws:
        w = np.float32(w)
        band = (r2 >= w * w) & (r2 < (w + step2) ** 2)
        vf1, vf2 = _irfftn(torch.where(band, torch.stack([f_v1, f_v2]), 0.0),
                           shape)
        noise = 0.5 * (vf1 - vf2) ** 2
        cdf_n = torch.sort(noise.reshape(-1))[0]
        e1 = vf1 * vf1
        e2 = vf2 * vf2
        w1 = ecdf_prob(cdf_n, noise.numel(), e1)
        w2 = ecdf_prob(cdf_n, noise.numel(), e2)
        if weight_fun == 0:
            weight = 0.5 * (w1 + w2)
        elif weight_fun == 1:
            weight = torch.minimum(w1, w2)
        else:
            weight = 0.5 * (w1 + w2) * (
                1.0 - torch.abs(w1 - w2) / torch.clamp(w1 + w2, min=1e-38))
        weight = weight ** weight_power
        vf1w = vf1 * weight
        vf2w = vf2 * weight
        m_v1r = m_v1r + vf1w
        m_v2r = m_v2r + vf2w
        m_s = m_s + torch.where(e1 > e2, vf1w, vf2w)
    return m_v1r, m_v2r, m_s


def filter_bank(v1r, v2r, r2, shape, bank_step, bank_overlap, weight_fun,
                weight_power):
    """Frequency filter bank restoration (reference filterBank): for each
    band, weight both half-map band images by the probability of their
    voxel energies exceeding the half-difference noise energy."""
    filter_step = bank_step * (1.0 - bank_overlap)
    ws = np.arange(n_bands(bank_step, bank_overlap),
                   dtype=np.float32) * np.float32(filter_step)
    m = filter_bank_bands(_rfftn(v1r), _rfftn(v2r), r2, shape, ws,
                          bank_step, weight_fun, weight_power)
    scale = 1.0 - bank_overlap
    return tuple(x * scale for x in m)


def evaluate_difference(v1r, v2r, mask, kdiff):
    """Shrink each half toward the mean with a Gaussian weight on the
    half-difference (reference evaluateDifference)."""
    n = v1r - v2r
    s = 0.5 * (v1r + v2r)
    cnt = torch.clamp(mask.sum(), min=1.0)
    mean = (n * mask).sum() / cnt
    var = ((n - mean) ** 2 * mask).sum() / cnt
    std = torch.sqrt(var) * kdiff
    w = torch.exp(-0.5 / torch.clamp(std * std, min=1e-38) * n * n)
    return s + (v1r - s) * w, s + (v2r - s) * w


def optimize_sigma(f_s, f_v1, f_v2, r2, sig1, sig2):
    """2-parameter host Powell over the sigma cost on the card (reference
    optimizeSigma / powellOptimizer)."""
    from scipy.optimize import minimize

    def cost(x):
        if x[0] < 0 or x[1] < 0 or x[0] > 2 or x[1] > 2:
            return 1e38
        return float(sigma_cost(f_s, f_v1, f_v2, r2,
                                torch.as_tensor(np.asarray(x, np.float32),
                                                device=r2.device)))

    res = minimize(cost, np.array([sig1, sig2]), method="Powell",
                   options={"xtol": 0.01, "ftol": 0.01})
    return float(res.x[0]), float(res.x[1])
