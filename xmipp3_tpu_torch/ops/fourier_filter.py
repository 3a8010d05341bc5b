"""Frequency-domain filter engine (the FourierFilter bank).

Counterpart of the reference package's ops/fourier_filter.py (reference
data/fourier_filter.{h,cpp}): mask generators in the rfft layout, built on
the host in numpy as there, and one fused rfft·mask·irfft application on
the images' device, batched over image stacks.

All cutoffs are in normalized digital frequency (cycles/pixel, Nyquist=0.5);
FourierFilter converts Å to digital frequency with the sampling rate
(the reference CLI contract "freq < 0.5 or Å with --sampling").
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor
from xmipp3_tpu_torch.ops.ctf import CTFDescription
from xmipp3_tpu_torch.ops.fourier import freq_grid_2d, freq_grid_3d


# ---------------------------------------------------------------------------
# mask generators (2D rfft layout)
# ---------------------------------------------------------------------------

def _radius_2d(h, w):
    fy, fx = freq_grid_2d(h, w)
    return np.sqrt(fy * fy + fx * fx)


def raised_cosine_low(r, w1, raised_w):
    """1 below w1, raised-cosine rolloff over [w1, w1+raised_w], 0 above."""
    t = (r - w1) / max(raised_w, 1e-8)
    mask = 0.5 * (1 + np.cos(np.pi * np.clip(t, 0.0, 1.0)))
    return np.where(r <= w1, 1.0, np.where(r >= w1 + raised_w, 0.0, mask)
                    ).astype(np.float32)


def low_pass_mask(h, w, w1, raised_w=0.02):
    return raised_cosine_low(_radius_2d(h, w), w1, raised_w)


def high_pass_mask(h, w, w1, raised_w=0.02):
    """Complement of low_pass: 0 below w1, transition over [w1, w1+raised_w]."""
    return (1.0 - low_pass_mask(h, w, w1, raised_w)).astype(np.float32)


def band_pass_mask(h, w, w1, w2, raised_w=0.02):
    return (low_pass_mask(h, w, w2, raised_w) *
            high_pass_mask(h, w, w1, raised_w)).astype(np.float32)


def stop_band_mask(h, w, w1, w2, raised_w=0.02):
    return (1.0 - band_pass_mask(h, w, w1, w2, raised_w)).astype(np.float32)


def _stop_low_band(r, w1, raised_w):
    """0 below w1, raised-cosine rise over [w1, w1+raised_w], 1 above."""
    return np.where(r > w1 + raised_w, 1.0,
                    np.where(r <= w1, 0.0,
                             0.5 * (1 - np.cos(np.pi * (r - w1) / raised_w)))
                    ).astype(np.float32)


def stop_lowband_x_mask(h, w, w1, raised_w=0.02):
    _, fx = freq_grid_2d(h, w)
    return _stop_low_band(np.abs(np.broadcast_to(fx, (h, fx.shape[1]))),
                          w1, raised_w)


def stop_lowband_y_mask(h, w, w1, raised_w=0.02):
    fy, fx = freq_grid_2d(h, w)
    return _stop_low_band(np.abs(np.broadcast_to(fy, (h, fx.shape[1]))),
                          w1, raised_w)


def gaussian_mask(h, w, sigma):
    """Gaussian in Fourier space with std sigma (digital freq)."""
    r2 = _radius_2d(h, w) ** 2
    return np.exp(-r2 / (2 * sigma ** 2)).astype(np.float32)


def real_gaussian_mask(h, w, sigma_real):
    """Gaussian convolution in real space with std sigma_real pixels =
    Fourier multiplication by exp(-2 π² σ² f²)."""
    r2 = _radius_2d(h, w) ** 2
    return np.exp(-2 * np.pi ** 2 * sigma_real ** 2 * r2).astype(np.float32)


def bfactor_mask(h, w, B, sampling):
    """exp(-(B/4)·R²), R in 1/Å (reference BFACTOR filter)."""
    R2 = (_radius_2d(h, w) / sampling) ** 2
    return np.exp(-(B / 4.0) * R2).astype(np.float32)


def ctf_mask(h, w, ctf: CTFDescription, mode: str = "ctf",
             min_ctf: float = 0.05):
    """The CTF (or |CTF|, or their thresholded inverse) as a host mask;
    the CTF is evaluated in float32 on the CPU, like the other masks."""
    c = ctf.generate_2d(h, w, rfft_layout=True, device="cpu").numpy()
    if mode == "ctf":
        return c.astype(np.float32)
    if mode == "ctfpos":
        return np.abs(c).astype(np.float32)
    if mode in ("ctfinv", "ctfposinv"):
        cc = np.abs(c) if mode == "ctfposinv" else c
        out = np.where(np.abs(cc) > min_ctf, 1.0 / np.where(cc == 0, 1, cc), 0.0)
        return out.astype(np.float32)
    raise ValueError(mode)


def fsc_profile_mask(h, w, freqs, fsc_vals):
    """Interpolate an FSC curve as a radial filter profile."""
    r = _radius_2d(h, w)
    return np.interp(r, np.asarray(freqs), np.asarray(fsc_vals),
                     left=fsc_vals[0], right=fsc_vals[-1]).astype(np.float32)


def wedge_mask_3d(d, h, w, th0, thF, rot=0.0, tilt=0.0, psi=0.0):
    """Missing-wedge pass mask (data between tilt angles th0..thF about y),
    optionally rotated by Euler angles — tomography filter."""
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    fz, fy, fx = freq_grid_3d(d, h, w)
    A = np.asarray(euler_matrix(rot, tilt, psi))
    X = A[0, 0] * fx + A[0, 1] * fy + A[0, 2] * fz
    Z = A[2, 0] * fx + A[2, 1] * fy + A[2, 2] * fz
    ang = np.degrees(np.arctan2(Z, X))
    # pass region: tilt angle of (x,z) within [th0, thF] measured from x-axis
    ang = np.where(ang > 90, ang - 180, np.where(ang < -90, ang + 180, ang))
    return ((ang >= th0) & (ang <= thF)).astype(np.float32)


def cone_mask_3d(d, h, w, th0):
    """Missing-cone stop mask: removes directions within th0 of the z axis."""
    fz, fy, fx = freq_grid_3d(d, h, w)
    rxy = np.sqrt(fx * fx + fy * fy)
    ang = np.degrees(np.arctan2(rxy, np.abs(fz)))
    return (ang >= th0).astype(np.float32)


# ---------------------------------------------------------------------------
# application
# ---------------------------------------------------------------------------

def apply_fourier_mask_2d(imgs, mask, device=None):
    """imgs (B,H,W) or (H,W) float32, mask (H, W//2+1) — fused
    rfft·mask·irfft on the images' device."""
    imgs = as_tensor(imgs, device)
    mask = as_tensor(mask, imgs.device)
    H, W = imgs.shape[-2:]
    return torch.fft.irfft2(torch.fft.rfft2(imgs) * mask, s=(H, W))


def apply_fourier_mask_3d(vol, mask, device=None):
    vol = as_tensor(vol, device)
    mask = as_tensor(mask, vol.device)
    D, H, W = vol.shape[-3:]
    return torch.fft.irfftn(torch.fft.rfftn(vol, dim=(-3, -2, -1)) * mask,
                            s=(D, H, W), dim=(-3, -2, -1))


def sparsify(imgs, p: float = 0.975, device=None):
    """Zero the p fraction of smallest-magnitude Fourier coefficients
    (reference SPARSIFY filter): the threshold is each image's k-th
    smallest magnitude over the full plane (k = int(H·W·p), 0-based), and
    coefficients at or above it are kept. The full plane keeps the
    thresholding Hermitian (|F(-k)| = |F(k)|), so the result is real."""
    imgs = as_tensor(imgs, device)
    single = imgs.ndim == 2
    if single:
        imgs = imgs[None]
    spec = torch.fft.fft2(imgs)
    mag = spec.abs()
    flat = mag.reshape(spec.shape[0], -1)
    k = int(flat.shape[1] * p)
    thresh = flat.kthvalue(k + 1, dim=1).values[:, None, None]
    out = torch.fft.ifft2(torch.where(mag >= thresh, spec, 0.0)).real
    return out[0] if single else out


class FourierFilter:
    """Configured filter (the program-facing engine, reference
    data/fourier_filter.h:69 FourierFilter + program_filter.h binding)."""

    def __init__(self, filter_type: str, args: list[str],
                 sampling: float | None = None):
        self.filter_type = filter_type
        self.args = args
        self.sampling = sampling

    def _digital(self, wval: float) -> float:
        """Å -> digital frequency when a sampling rate is given and the value
        looks like Å (>0.5), matching the reference CLI convention."""
        if self.sampling and wval > 0.5:
            return self.sampling / wval
        return wval

    def mask_2d(self, h: int, w: int) -> np.ndarray:
        t, a = self.filter_type, self.args
        raised = lambda i: float(a[i]) if len(a) > i else 0.02
        if t == "low_pass":
            return low_pass_mask(h, w, self._digital(float(a[0])), raised(1))
        if t == "high_pass":
            return high_pass_mask(h, w, self._digital(float(a[0])),
                                  raised(1))
        if t == "band_pass":
            return band_pass_mask(h, w, self._digital(float(a[0])),
                                  self._digital(float(a[1])), raised(2))
        if t == "stop_band":
            return stop_band_mask(h, w, self._digital(float(a[0])),
                                  self._digital(float(a[1])), raised(2))
        if t == "stop_lowbandx":
            return stop_lowband_x_mask(h, w, self._digital(float(a[0])),
                                       raised(1))
        if t == "stop_lowbandy":
            return stop_lowband_y_mask(h, w, self._digital(float(a[0])),
                                       raised(1))
        if t == "gaussian":
            return gaussian_mask(h, w, float(a[0]))
        if t == "real_gaussian":
            return real_gaussian_mask(h, w, float(a[0]))
        if t == "bfactor":
            return bfactor_mask(h, w, float(a[0]), self.sampling or 1.0)
        if t in ("ctf", "ctfpos", "ctfinv", "ctfposinv"):
            ctf = CTFDescription.from_metadata(a[0])
            if self.sampling:
                ctf.sampling_rate = self.sampling
            min_ctf = float(a[1]) if len(a) > 1 else 0.05
            return ctf_mask(h, w, ctf, mode=t, min_ctf=min_ctf)
        if t == "ctfdef":
            kv, cs, q0, defocus = (float(x) for x in a[:4])
            ctf = CTFDescription(voltage=kv, Cs=cs, Q0=q0, defocusU=defocus,
                                 defocusV=defocus,
                                 sampling_rate=self.sampling or 1.0)
            return ctf_mask(h, w, ctf, mode="ctf")
        if t == "ctfdefastig":
            kv, cs, q0, dU, dV, dAng = (float(x) for x in a[:6])
            ctf = CTFDescription(voltage=kv, Cs=cs, Q0=q0, defocusU=dU,
                                 defocusV=dV, azimuthal_angle=dAng,
                                 sampling_rate=self.sampling or 1.0)
            return ctf_mask(h, w, ctf, mode="ctf")
        if t == "fsc":
            from xmipp3_tpu_torch.core.metadata import MetaData
            md = MetaData(a[0])
            freqs = md.getColumn("resolutionFreq") * (self.sampling or 1.0)
            fsc = md.getColumn("resolutionFRC")
            return fsc_profile_mask(h, w, freqs, fsc)
        if t == "binary_file":
            from xmipp3_tpu_torch.core.image import load_image
            full = np.asarray(load_image(a[0]), np.float32)
            return np.ascontiguousarray(full[:, : w // 2 + 1])
        raise ValueError(f"unknown filter type {t}")

    def apply(self, imgs, device=None):
        """The filter applied to (B,H,W) or (H,W) images on their device (a
        tensor's own, else `device`, the card by default)."""
        imgs = as_tensor(imgs, device)
        if self.filter_type == "sparsify":
            p = float(self.args[0]) if self.args else 0.975
            return sparsify(imgs, p)
        mask = self.mask_2d(imgs.shape[-2], imgs.shape[-1])
        return apply_fourier_mask_2d(imgs, mask)
