"""Fringe processing: spiral phase transform and fringe-pattern
demodulation (used for CTF ring demodulation).

Contract: reference reconstruction/fringe_processing.{h,cpp} — SPTH
(spiral phase transform, Larkin's 2D quadrature), orientation/direction
maps, and demodulate() which recovers the modulating phase and envelope of
a fringe pattern. Whole-image FFT multiplies on the image's device (the
card by default for a host image); the pattern simulator and the ray
walk of first_psd_zero are host numpy, as in the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor


def _freqs(H, W, device):
    fy = torch.as_tensor(np.fft.fftfreq(H).astype(np.float32),
                         device=device)[:, None]
    fx = torch.as_tensor(np.fft.fftfreq(W).astype(np.float32),
                         device=device)[None, :]
    return fy, fx


def spth(im, device=None):
    """Spiral phase transform: IFFT( FFT(im) * e^{i phi_f} ) with
    e^{i phi_f} = (fx + i fy)/|f| (fringe_processing.cpp SPTH). Returns the
    complex quadrature image."""
    im = as_tensor(im, device)
    fy, fx = _freqs(*im.shape[-2:], im.device)
    r = torch.sqrt(fx ** 2 + fy ** 2)
    spiral = torch.where(r > 0, torch.complex(fx, fy)
                         / torch.clamp(r, min=1e-12),
                         torch.zeros((), dtype=torch.complex64,
                                     device=im.device))
    return torch.fft.ifft2(torch.fft.fft2(im) * spiral)


def _smooth(x, G):
    return torch.fft.ifft2(torch.fft.fft2(x) * G).real


def orientation_map(im, sigma=2.0, device=None):
    """Local fringe orientation in [-pi/2, pi/2) from smoothed gradient
    tensor components (fringe_processing orMinDer role)."""
    im = as_tensor(im, device)
    gy, gx = torch.gradient(im)
    fy, fx = _freqs(*im.shape, im.device)
    G = torch.exp(-2 * (math.pi * sigma) ** 2 * (fx ** 2 + fy ** 2))
    jxx, jxy, jyy = (_smooth(a, G) for a in (gx * gx, gx * gy, gy * gy))
    return 0.5 * torch.atan2(2 * jxy, jxx - jyy)


def demodulate(im, sigma_or=2.0, device=None):
    """Demodulate a fringe pattern: returns (phase, mod).

    mod (the envelope) = sqrt(im^2 + |Q|^2) where Q is the direction-
    corrected quadrature from the SPTH; phase = atan2(Q, im) (reference
    demodulate(); the direction map resolves the quadrature sign)."""
    im = as_tensor(im, device)
    im = im - im.mean()
    q = spth(im)
    beta = orientation_map(im, sigma_or)
    # direction-corrected real quadrature: Re{ conj(i e^{i beta}) * q }
    Q = (torch.conj(1j * torch.exp(1j * beta)) * q).real
    return torch.atan2(Q, im), torch.sqrt(im ** 2 + Q ** 2)


def simul_pattern(kind: str, nx: int, ny: int, noise_level: float = 0.0,
                  freq: float = 1.0, coefs=None, rng=None):
    """Synthetic fringe patterns (reference simulPattern,
    fringe_processing.cpp:42-108), output in DIRECT coordinates (the
    reference resets STARTING to 0 before returning). Kinds:
      open:        cos(j·c·freq)
      closed:      cos(50·exp(-((i·c·freq)^2+(j·c·freq)^2)/2))
      complex_open/complex_closed: same with a Zernike phase term from
      `coefs` added inside the cosine
      closed_mod:  closed fringes under a Gaussian modulation envelope
    with c = 2/max(nx, ny) over centered logical coords (host numpy)."""
    c = 2.0 / max(nx, ny)
    i = (np.arange(ny) - ny // 2)[:, None] * c
    j = (np.arange(nx) - nx // 2)[None, :] * c
    phase = 0.0
    if kind.startswith("complex") and coefs is not None:
        from xmipp3_tpu_torch.ops.zernike import zernike2d_pols
        phase = zernike2d_pols(np.asarray(coefs, float), (ny, nx))
    if kind in ("open", "complex_open"):
        im = np.cos(j * freq + phase) * np.ones((ny, nx))
    elif kind in ("closed", "complex_closed"):
        im = np.cos(50 * np.exp(-0.5 * ((i * freq) ** 2 + (j * freq) ** 2))
                    + phase)
    elif kind == "closed_mod":
        env = np.exp(-0.5 * ((i * freq) ** 2 + (j * freq) ** 2) / 4.0)
        im = env * np.cos(50 * np.exp(
            -0.5 * ((i * freq) ** 2 + (j * freq) ** 2)))
    else:
        raise ValueError(f"unknown pattern kind '{kind}'")
    if noise_level > 0:
        rng = np.random.default_rng() if rng is None else rng
        im = im + rng.normal(0.0, noise_level, im.shape)
    return np.broadcast_to(im, (ny, nx)).astype(np.float64).copy()


def _annular_bandpass(im, rmin, rmax):
    """normalizeWB's annular filter (fringe_processing.cpp:298-330):
    logistic high cut at freq1 = X/(rang/15), Gaussian low suppression at
    freq2 = X/rang with rang = (rmax - rmin)/2, applied on CENTERED
    frequencies in pixel units."""
    H, W = im.shape[-2:]
    rang = (rmax - rmin) / 2.0
    freq2 = W / max(rang, 1e-6)
    freq1 = W / max(rang / 15.0, 1e-6)
    ii = (torch.arange(H, device=im.device) - H // 2)[:, None].float()
    jj = (torch.arange(W, device=im.device) - W // 2)[None, :].float()
    r2 = ii * ii + jj * jj
    Hf = (1.0 / (1.0 + torch.exp((torch.sqrt(r2) - freq1) / 10.0))) \
        * (1.0 - torch.exp(-r2 / (2.0 * freq2 * freq2)))
    Hf = torch.fft.ifftshift(Hf)
    return torch.fft.ifft2(torch.fft.fft2(im) * Hf).real


def normalize_wb(im, rmin: float, rmax: float, roi=None, device=None):
    """normalizeWB (fringe_processing.cpp:298-360): annular band-pass,
    SPTH quadrature, imN = cos(atan2(|quadrature|, bandpassed)) in
    [-1, 1], mod_map = modulation magnitude; zero outside the ROI."""
    im = as_tensor(im, device)
    bp = _annular_bandpass(im, float(rmin), float(rmax))
    q = spth(bp)
    mod = torch.sqrt(q.abs() ** 2 + bp ** 2)
    imN = torch.cos(torch.atan2(q.abs(), bp))
    if roi is not None:
        roi = torch.as_tensor(np.asarray(roi, bool), device=im.device)
        imN = torch.where(roi, imN, 0.0)
        mod = torch.where(roi, mod, 0.0)
    return imN, mod


def unwrap_phase(wrapped, quality=None, device=None):
    """2-D phase unwrapping (reference `unwrapping`,
    fringe_processing.cpp:552-700 — a quality-guided flood fill with a
    predictor/corrector), as the weighted least-squares problem
    min ||grad(u) - W(grad(wrapped))||^2 solved by the DCT/Poisson method
    (Ghiglia & Romero 1994): the same results on smooth phases (the
    regime the reference's demodulation feeds it), one FFT pass."""
    w = as_tensor(wrapped, device)
    H, W = w.shape

    def wrapd(x):
        return torch.remainder(x + math.pi, 2 * math.pi) - math.pi

    dx = wrapd(torch.diff(w, dim=1, append=w[:, -1:]))
    dy = wrapd(torch.diff(w, dim=0, append=w[-1:, :]))
    rho = (dx - torch.roll(dx, 1, dims=1)) + (dy - torch.roll(dy, 1, dims=0))
    # Neumann Poisson solve via DCT-II (mirror extension)
    ext = torch.cat([rho, rho.flip(0)], dim=0)
    ext = torch.cat([ext, ext.flip(1)], dim=1)
    F = torch.fft.fft2(ext)
    ky = torch.arange(2 * H, device=w.device)[:, None]
    kx = torch.arange(2 * W, device=w.device)[None, :]
    denom = (2 * torch.cos(math.pi * ky / H) + 2 * torch.cos(math.pi * kx / W)
             - 4.0).float()
    denom = torch.where(denom.abs() < 1e-9, 1.0, denom)
    U = torch.where((ky == 0) & (kx == 0),
                    torch.zeros((), dtype=F.dtype, device=w.device),
                    F / denom)
    u = torch.fft.ifft2(U).real[:H, :W]
    # anchor to the wrapped phase at the best-quality pixel
    if quality is not None:
        k = int(torch.as_tensor(np.abs(np.asarray(quality))).argmax())
    else:
        k = (H // 2) * W + W // 2
    return u + (w.reshape(-1)[k] - u.reshape(-1)[k])


def first_psd_zero(enhanced_psd, rmin: float, rmax: float,
                   num_angles: int = 90):
    """firsPSDZero (fringe_processing.cpp:1022-1080): walk a ray per
    angle from rmin/2 outward and record the first point whose enhanced-
    PSD value falls below the (10th-percentile + 98th-percentile)/2
    threshold. Returns (x, y) arrays, one point per angle (centered
    coordinates); every ray is sampled in one vectorized gather (host
    numpy, as in the reference)."""
    psd = np.asarray(enhanced_psd, np.float64)
    H, W = psd.shape
    eff0 = np.percentile(psd, 0.1)
    effF = np.percentile(psd, 98.0)
    thrs = 0.5 * (eff0 + effF)
    angles = np.arange(num_angles) * (2 * np.pi / num_angles)
    n_steps = 256
    tt = np.linspace(rmin / 2.0, rmax / 2.0, n_steps)
    xs = tt[None, :] * np.cos(angles)[:, None]           # (A, S)
    ys = tt[None, :] * np.sin(angles)[:, None]
    xi = np.clip(np.round(xs).astype(int) + W // 2, 0, W - 1)
    yi = np.clip(np.round(ys).astype(int) + H // 2, 0, H - 1)
    below = psd[yi, xi] < thrs                           # (A, S)
    first = np.where(below.any(axis=1), below.argmax(axis=1), n_steps - 1)
    return (xs[np.arange(num_angles), first],
            ys[np.arange(num_angles), first])
