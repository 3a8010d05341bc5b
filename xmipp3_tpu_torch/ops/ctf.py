"""CTF forward model (astigmatic, with envelopes and noise background) in
torch float32.

Counterpart of the reference package's ops/ctf.py (after the reference's
CTFDescription, data/ctf.h:782; produceSideInfo, data/ctf.cpp:645-678;
getValuePureAt, data/ctf.h:452; getValueNoiseAt, data/ctf.h:1140-1175):
elementwise evaluations over frequency grids. No hand kernel stands behind
this module; its users (the gridding CTF table, phase flipping, Wiener
filtering) run it as PyTorch elementwise ops on the card.

Model (frequencies u in 1/Å, angles in rad):
  λ = 12.2643247 / sqrt(V (1 + 0.978466e-6 V)),  V = 1000·kV        [Å]
  Δf(θ) = defocus_average + defocus_deviation·cos 2(θ − azimuth)
      defocus_average  = −(DeltafU + DeltafV)/2
      defocus_deviation= −(DeltafU − DeltafV)/2
  χ(u,θ) = VPP + πλ·Δf·u² + (π/2)·Cs λ³·u⁴
  CTF_pure = −K·(√(1−Q0²)·sin χ − Q0·cos χ)·E(u)
  E = exp(−K3 u⁴)·J0(K5 u²)·sinc(u·ΔR)·exp(−K6 (K7 u³ + Δf u)²)
      + envR0 + envR1·u + envR2·u²   (clipped ≥ 0)
  noise(u,θ) = baseline + gK e^{−σ(θ)(u−c(θ))²} + sqrtK e^{−sq(θ)√u}
               − gK2 e^{−σ2(θ)(u−c2(θ))²} + bgR1 u + bgR2 u² + bgR3 u³

Frequencies given as numpy arrays go to `device` (the card by default);
tensors stay on their own device. Every result is a float32 tensor.

`.ctfparam` files (one row, block "fullMicrograph") are the parameter
interchange: a file written by either package reads back the same in the
other.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass, fields

import numpy as np
import torch

from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.device import as_tensor


@dataclass
class CTFDescription:
    """Parameter set; mirrors the .ctfparam metadata contract."""
    sampling_rate: float = 2.0      # Tm, Å/px
    voltage: float = 100.0          # kV
    defocusU: float = 0.0           # Å (positive = underfocus)
    defocusV: float = 0.0
    azimuthal_angle: float = 0.0    # deg
    Cs: float = 0.0                 # mm
    Ca: float = 0.0                 # mm (chromatic aberration)
    espr: float = 0.0               # energy spread (eV)
    ispr: float = 0.0               # lens stability (ppm)
    alpha: float = 0.0              # convergence cone (rad)
    DeltaF: float = 0.0             # longitudinal displacement (Å)
    DeltaR: float = 0.0             # transversal displacement (Å)
    Q0: float = 0.0                 # amplitude contrast
    K: float = 1.0                  # global gain
    envR0: float = 0.0
    envR1: float = 0.0
    envR2: float = 0.0
    phase_shift: float = 0.0        # VPP phase shift (rad)
    VPP_radius: float = 0.0
    # noise background
    base_line: float = 0.0
    gaussian_K: float = 0.0
    sigmaU: float = 0.0
    sigmaV: float = 0.0
    cU: float = 0.0
    cV: float = 0.0
    gaussian_angle: float = 0.0
    sqrt_K: float = 0.0
    sqU: float = 0.0
    sqV: float = 0.0
    sqrt_angle: float = 0.0
    gaussian_K2: float = 0.0
    sigmaU2: float = 0.0
    sigmaV2: float = 0.0
    cU2: float = 0.0
    cV2: float = 0.0
    gaussian_angle2: float = 0.0
    bgR1: float = 0.0
    bgR2: float = 0.0
    bgR3: float = 0.0

    # ------------------------------------------------------------------
    _MD_MAP = {
        "sampling_rate": "ctfSamplingRate", "voltage": "ctfVoltage",
        "defocusU": "ctfDefocusU", "defocusV": "ctfDefocusV",
        "azimuthal_angle": "ctfDefocusAngle",
        "Cs": "ctfSphericalAberration", "Ca": "ctfChromaticAberration",
        "espr": "ctfEnergyLoss", "ispr": "ctfLensStability",
        "alpha": "ctfConvergenceCone", "DeltaF": "ctfLongitudinalDisplacement",
        "DeltaR": "ctfTransversalDisplacement", "Q0": "ctfQ0", "K": "ctfK",
        "envR0": "ctfEnvR0", "envR1": "ctfEnvR1", "envR2": "ctfEnvR2",
        "phase_shift": "ctfVPPphaseshift", "VPP_radius": "ctfVPPRadius",
        "base_line": "ctfBgBaseline", "gaussian_K": "ctfBgGaussianK",
        "sigmaU": "ctfBgGaussianSigmaU", "sigmaV": "ctfBgGaussianSigmaV",
        "cU": "ctfBgGaussianCU", "cV": "ctfBgGaussianCV",
        "gaussian_angle": "ctfBgGaussianAngle",
        "sqrt_K": "ctfBgSqrtK", "sqU": "ctfBgSqrtU", "sqV": "ctfBgSqrtV",
        "sqrt_angle": "ctfBgSqrtAngle",
        "gaussian_K2": "ctfBgGaussian2K", "sigmaU2": "ctfBgGaussian2SigmaU",
        "sigmaV2": "ctfBgGaussian2SigmaV", "cU2": "ctfBgGaussian2CU",
        "cV2": "ctfBgGaussian2CV", "gaussian_angle2": "ctfBgGaussian2Angle",
    }

    @classmethod
    def from_row(cls, row) -> "CTFDescription":
        """Build from a metadata row's inline ctf* labels (reference
        CTFDescription::readFromMdRow)."""
        return cls(**{attr: float(row[label])
                      for attr, label in cls._MD_MAP.items() if label in row})

    @classmethod
    def from_metadata(cls, md_or_path) -> "CTFDescription":
        """Build from the first row of a metadata (a .ctfparam file)."""
        md = md_or_path if isinstance(md_or_path, MetaData) else \
            MetaData(md_or_path)
        return cls.from_row(md.getRow(md.firstObject()))

    def to_metadata(self) -> MetaData:
        md = MetaData.fromRows(
            [{label: getattr(self, attr)
              for attr, label in self._MD_MAP.items()}])
        md.row_format = True
        return md

    def write(self, path: str) -> None:
        self.to_metadata().write(path, block="fullMicrograph")

    @property
    def Tm(self) -> float:
        """Reference-parity alias for the sampling rate (A/px)."""
        return self.sampling_rate

    # ------------------------------------------------------------------
    def side_info(self) -> dict:
        """K1..K7 etc. in float64 (reference produceSideInfo,
        ctf.cpp:645-678)."""
        local_Cs = self.Cs * 1e7
        local_Ca = self.Ca * 1e7
        local_kV = self.voltage * 1e3
        local_ispr = self.ispr * 1e6
        lam = 12.2643247 / np.sqrt(local_kV * (1 + 0.978466e-6 * local_kV))
        K1 = np.pi * lam
        K2 = np.pi / 2 * local_Cs * lam ** 3
        K3 = (0.25 * np.pi * local_Ca * lam *
              (self.espr / self.voltage + 2 * local_ispr)) ** 2 / np.log(2.0)
        K5 = np.pi * self.DeltaF * lam
        K6 = np.pi ** 2 * self.alpha ** 2
        K7 = local_Cs * lam ** 2
        Ksin = np.sqrt(max(1 - self.Q0 ** 2, 0.0))
        Kcos = self.Q0
        return dict(lam=lam, K1=K1, K2=K2, K3=K3, K5=K5, K6=K6, K7=K7,
                    Ksin=Ksin, Kcos=Kcos,
                    defocus_average=-(self.defocusU + self.defocusV) / 2,
                    defocus_deviation=-(self.defocusU - self.defocusV) / 2,
                    rad_azimuth=np.deg2rad(self.azimuthal_angle))

    # ------------------------------------------------------------------
    def pure_at(self, fx, fy, damped: bool = True, device=None):
        """CTF value on continuous frequencies (1/Å). fx, fy broadcastable."""
        fx, fy = _freqs(fx, fy, device)
        return _pure(fx, fy, _side([self], fx.device, 0), damped)

    def argument_at(self, fx, fy, device=None):
        """The CTF phase argument chi(f) (reference getValueArgument)."""
        fx, fy = _freqs(fx, fy, device)
        si = _side([self], fx.device, 0)
        u2 = fx * fx + fy * fy
        deltaf = torch.where(u2 > 0, _deltaf(fx, fy, si), 0.0)
        return si["K1"] * deltaf * u2 + si["K2"] * u2 * u2

    def noise_at(self, fx, fy, device=None):
        """Background noise power model (reference getValueNoiseAt)."""
        fx, fy = _freqs(fx, fy, device)
        u2 = fx * fx + fy * fy
        u = torch.sqrt(u2)
        c2t, s2t = _cos_sin_2theta(fx, fy)

        def ellip(valU, valV, angle_deg):
            a = np.deg2rad(angle_deg)
            cos2d = c2t * np.cos(2 * a) + s2t * np.sin(2 * a)
            c2 = (1 + cos2d) / 2
            s2 = (1 - cos2d) / 2
            return torch.sqrt(valU * valU * c2 + valV * valV * s2)

        sq = ellip(self.sqU, self.sqV, self.sqrt_angle)
        c = ellip(self.cU, self.cV, self.gaussian_angle)
        sigma = ellip(self.sigmaU, self.sigmaV, self.gaussian_angle)
        c2_ = ellip(self.cU2, self.cV2, self.gaussian_angle2)
        sigma2 = ellip(self.sigmaU2, self.sigmaV2, self.gaussian_angle2)
        return (self.base_line
                + self.gaussian_K * torch.exp(-sigma * (u - c) ** 2)
                + self.sqrt_K * torch.exp(-sq * torch.sqrt(u))
                - self.gaussian_K2 * torch.exp(-sigma2 * (u - c2_) ** 2)
                + self.bgR1 * u + self.bgR2 * u2 + self.bgR3 * u2 * u)

    # ------------------------------------------------------------------
    def generate_2d(self, h: int, w: int, rfft_layout: bool = True,
                    damped: bool = True, device=None):
        """Sampled CTF image (reference generateCTF, data/ctf.h:650-716).

        In rfft layout the fx=0.5 (Nyquist) column aliases ±0.5; the mask is
        symmetrized there so real-filter application preserves realness."""
        return generate_2d_rows([self], h, w, rfft_layout, damped,
                                device)[0]

    def damping_2d(self, h: int, w: int, rfft_layout: bool = True,
                   device=None):
        """The envelope E alone, times K (reference getValueDampingAt)."""
        fy, fx = _grid(h, w, np.float32(self.sampling_rate), rfft_layout)
        fx, fy = _freqs(fx, fy, device)
        si = _side([self], fx.device, 0)
        u2 = fx * fx + fy * fy
        u = torch.sqrt(u2)
        deltaf = torch.where(u2 > 0, _deltaf(fx, fy, si), 0.0)
        return si["K"] * _envelope(u, u2, deltaf, si)

    def first_zero_freq(self, n_samples: int = 4096,
                        device=None) -> float:
        """Radial frequency (1/Å) of the first CTF zero along azimuth=0."""
        f = np.linspace(1e-6, 0.5 / self.sampling_rate, n_samples)
        vals = self.pure_at(f, np.zeros_like(f), damped=False,
                            device=device).cpu().numpy()
        sign = np.sign(vals)
        idx = np.where(sign[:-1] * sign[1:] < 0)[0]
        return float(f[idx[0]]) if len(idx) else float(f[-1])


# ---------------------------------------------------------------------------
# elementwise evaluation, shared by the single and the per-row forms
# ---------------------------------------------------------------------------

def _freqs(fx, fy, device):
    """fx, fy as float32 tensors on one device: a tensor keeps its own, and
    numpy goes to `device` (the card by default)."""
    if isinstance(fx, torch.Tensor) and device is None:
        device = fx.device
    elif isinstance(fy, torch.Tensor) and device is None:
        device = fy.device
    return as_tensor(fx, device), as_tensor(fy, device)


def _cos_sin_2theta(fx, fy):
    """cos(2θ), sin(2θ) computed algebraically — exactly Hermitian-symmetric
    in floating point (atan2-based forms are not, which would break
    phase-flip involution at CTF zero crossings)."""
    u2 = fx * fx + fy * fy
    safe = torch.clamp(u2, min=1e-30)
    return (fx * fx - fy * fy) / safe, 2 * fx * fy / safe


def _deltaf(fx, fy, si):
    """Defocus at each frequency's azimuth, from the tensors of _side()."""
    c2t, s2t = _cos_sin_2theta(fx, fy)
    cos2 = c2t * si["cos2az"] + s2t * si["sin2az"]
    return si["defocus_average"] + si["defocus_deviation"] * cos2


_SIDE = ("K1", "K2", "K3", "K5", "K6", "K7", "Ksin", "Kcos",
         "defocus_average", "defocus_deviation")
_DIRECT = ("K", "DeltaR", "envR0", "envR1", "envR2", "phase_shift")


def _side(ctfs, device, grid_ndim: int) -> dict:
    """The side information of each description, computed in float64 on the
    host (side_info) and rounded to float32 once: (C,) + (1,) * grid_ndim
    tensors, so that one evaluation serves C descriptions over a grid, and
    C = 1 is bit for bit the evaluation of one description."""
    rows = []
    for c in ctfs:
        si = c.side_info()
        az = si["rad_azimuth"]
        vpp_on = c.VPP_radius != 0.0
        rows.append([si[k] for k in _SIDE]
                    + [getattr(c, k) for k in _DIRECT]
                    + [np.cos(2 * az), np.sin(2 * az), float(vpp_on),
                       2 * c.VPP_radius ** 2 if vpp_on else 1.0])
    names = _SIDE + _DIRECT + ("cos2az", "sin2az", "vpp_on", "vpp_den")
    a = torch.tensor(np.asarray(rows, np.float32), device=device)
    shape = (len(ctfs),) + (1,) * grid_ndim
    out = {k: a[:, i].reshape(shape) for i, k in enumerate(names)}
    if grid_ndim == 0:
        out = {k: v[0] for k, v in out.items()}
    return out


def _envelope(u, u2, deltaf, si):
    """E(u) of the module docstring, clipped at 0 (reference damping)."""
    Eespr = torch.exp(-si["K3"] * (u2 * u2))
    EdeltaF = _bessel_j0(si["K5"] * u2)
    EdeltaR = torch.sinc(u * si["DeltaR"])
    aux = si["K7"] * u2 * u + deltaf * u
    Ealpha = torch.exp(-si["K6"] * aux * aux)
    E = Eespr * EdeltaF * EdeltaR * Ealpha + \
        si["envR0"] + si["envR1"] * u + si["envR2"] * u2
    return torch.clamp(E, min=0.0)


def _pure(fx, fy, si, damped: bool):
    """The pure CTF of each description in `si` (from _side) at fx, fy."""
    u2 = fx * fx + fy * fy
    u = torch.sqrt(u2)
    u4 = u2 * u2
    deltaf = torch.where(u2 > 0, _deltaf(fx, fy, si), 0.0)
    VPP = torch.where(si["vpp_on"] > 0, -si["phase_shift"] * (
        1 - torch.exp(-u2 / si["vpp_den"])), 0.0)
    arg = VPP + si["K1"] * deltaf * u2 + si["K2"] * u4
    ctf = -(si["Ksin"] * torch.sin(arg) - si["Kcos"] * torch.cos(arg))
    if damped:
        ctf = ctf * _envelope(u, u2, deltaf, si)
    return si["K"] * ctf


def _grid(h: int, w: int, Ts, rfft_layout: bool):
    """numpy float32 (fy, fx) in 1/Å of an h x w image sampled at Ts (a
    float32 scalar, or a (C, 1, 1) float32 array for per-row rates): the
    rfft2 layout, or the centred full grid."""
    if rfft_layout:
        fy = np.fft.fftfreq(h).astype(np.float32)[:, None]
        fx = np.fft.rfftfreq(w).astype(np.float32)[None, :]
    else:
        fy = np.fft.fftshift(np.fft.fftfreq(h)).astype(np.float32)[:, None]
        fx = np.fft.fftshift(np.fft.fftfreq(w)).astype(np.float32)[None, :]
    return fy / Ts, fx / Ts


def generate_2d_rows(ctfs, h: int, w: int, rfft_layout: bool = True,
                     damped: bool = True, device=None):
    """generate_2d of each description in `ctfs`, in one pass: (C, h, w')
    float32, each slice equal to that description's generate_2d (the
    per-row CTFs of a batch of images)."""
    Ts = np.array([c.sampling_rate for c in ctfs], np.float32)[:, None, None]
    fy, fx = _grid(h, w, Ts, rfft_layout)
    fx, fy = _freqs(fx, fy, device)
    out = _pure(fx, fy, _side(ctfs, fx.device, 2), damped)
    return _hermitianize_rfft_mask(out, w) if rfft_layout else out


def _hermitianize_rfft_mask(mask, w: int):
    """Force the self-conjugate columns (fx=0 and, for even w, fx=Nyquist) of
    rfft-layout real masks (..., h, w//2+1) to satisfy m[ky] == m[-ky] by
    averaging."""
    def sym_col(col):
        flipped = torch.cat([col[..., :1], col[..., 1:].flip(-1)], dim=-1)
        return 0.5 * (col + flipped)

    mask = mask.clone()
    mask[..., :, 0] = sym_col(mask[..., :, 0])
    if w % 2 == 0:
        mask[..., :, -1] = sym_col(mask[..., :, -1])
    return mask


def _bessel_j0(x):
    """J0 via polynomial approximation (Abramowitz & Stegun 9.4.1/9.4.3),
    accurate to ~1e-7; the reference package's polynomial, for parity."""
    x = torch.as_tensor(x, dtype=torch.float32)
    ax = torch.abs(x)
    # |x| < 8 (rational approximation, Abramowitz & Stegun / standard tables)
    y = ax * ax
    p1 = (57568490574.0 + y * (-13362590354.0 + y * (651619640.7 + y * (
        -11214424.18 + y * (77392.33017 + y * (-184.9052456))))))
    q1 = (57568490411.0 + y * (1029532985.0 + y * (9494680.718 + y * (
        59272.64853 + y * (267.8532712 + y)))))
    small = p1 / q1
    # |x| >= 8
    z = 8.0 / torch.clamp(ax, min=1e-8)
    y2 = z * z
    xx = ax - 0.785398164
    p2 = (1.0 + y2 * (-0.1098628627e-2 + y2 * (0.2734510407e-4 + y2 * (
        -0.2073370639e-5 + y2 * 0.2093887211e-6))))
    q2 = (-0.1562499995e-1 + y2 * (0.1430488765e-3 + y2 * (
        -0.6911147651e-5 + y2 * (0.7621095161e-6 + y2 * -0.934935152e-7))))
    big = torch.sqrt(0.636619772 / torch.clamp(ax, min=1e-8)) * (
        torch.cos(xx) * p2 - z * torch.sin(xx) * q2)
    return torch.where(ax < 8.0, small, big)


# ---------------------------------------------------------------------------
# batched application (ops for programs)
# ---------------------------------------------------------------------------

def _filter(imgs, mask, shape):
    """irfft2(rfft2(imgs) * mask) at `shape`; mask (h, w') or (B, h, w')."""
    return torch.fft.irfft2(torch.fft.rfft2(imgs) * mask, s=shape)


def _masks(ctf, n: int, h: int, w: int, device, **kw):
    """One CTF image (h, w') for a description, or (n, h, w') for a list
    of n descriptions (one per image)."""
    if isinstance(ctf, CTFDescription):
        return ctf.generate_2d(h, w, rfft_layout=True, device=device, **kw)
    if len(ctf) != n:
        raise ValueError(f"{len(ctf)} CTF descriptions for {n} images")
    return generate_2d_rows(ctf, h, w, True, device=device, **kw)


def _batch(imgs, device):
    imgs = as_tensor(imgs, device)
    single = imgs.ndim == 2
    return (imgs[None] if single else imgs), single


def apply_ctf(imgs, ctf, absPhase: bool = False, device=None):
    """Multiply images by the (damped) CTF in Fourier space
    (reference applyCTF, data/ctf.h:636-639). `ctf`: one CTFDescription,
    or a list with one per image."""
    imgs, single = _batch(imgs, device)
    B, H, W = imgs.shape
    ctf_img = _masks(ctf, B, H, W, imgs.device)
    if absPhase:
        ctf_img = torch.abs(ctf_img)
    out = _filter(imgs, ctf_img, (H, W))
    return out[0] if single else out


def phase_flip(imgs, ctf, device=None):
    """Correct CTF phase by sign flip (reference correctPhase /
    ctf_phase_flip). `ctf`: one CTFDescription, or a list with one per
    image (their CTFs evaluated in one pass)."""
    imgs, single = _batch(imgs, device)
    B, H, W = imgs.shape
    sign = torch.sign(_masks(ctf, B, H, W, imgs.device, damped=False))
    sign = torch.where(sign == 0, 1.0, sign)
    out = _filter(imgs, sign, (H, W))
    return out[0] if single else out


def wiener_filter_2d(imgs, ctf, wiener_constant: float = 0.1,
                     isIsotropic: bool = False, phase_flipped: bool = False,
                     pad: float = 1.0, correct_envelope: bool = False,
                     device=None):
    """2-D Wiener CTF correction (reference Wiener2D, data/wiener2d.h:36).

    wiener_constant < 0 uses the FREALIGN default (10% of the mean CTF
    power, per image); isIsotropic replaces the astigmatic defocus by its
    mean; pad Fourier-pads by the factor before filtering
    (ctf_correct_wiener2d.cpp:48-53); correct_envelope includes the damping
    envelope in the inverted CTF. `ctf`: one CTFDescription, or a list with
    one per image."""
    imgs, single = _batch(imgs, device)
    B, H, W = imgs.shape
    if isIsotropic:
        def iso(c):
            c = copy.copy(c)
            c.defocusU = c.defocusV = 0.5 * (float(c.defocusU)
                                             + float(c.defocusV))
            c.azimuthal_angle = 0.0
            return c
        ctf = iso(ctf) if isinstance(ctf, CTFDescription) else \
            [iso(c) for c in ctf]
    Hp = int(round(H * max(pad, 1.0)))
    Wp = int(round(W * max(pad, 1.0)))
    c = _masks(ctf, B, Hp, Wp, imgs.device, damped=bool(correct_envelope))
    if phase_flipped:
        c = torch.abs(c)
    wc = wiener_constant
    if wc < 0:
        wc = 0.1 * torch.mean(c * c, dim=(-2, -1), keepdim=True)
    wien = c / (c * c + wc)
    if (Hp, Wp) != (H, W):
        py, px = (Hp - H) // 2, (Wp - W) // 2
        padded = torch.nn.functional.pad(
            imgs, (px, Wp - W - px, py, Hp - H - py))
        out = _filter(padded, wien, (Hp, Wp))[:, py:py + H, px:px + W]
    else:
        out = _filter(imgs, wien, (H, W))
    return out[0] if single else out.contiguous()


# ---------------------------------------------------------------------------
# CTF comparison metrics (reference data/ctf.cpp:107-330:
# errorBetween2CTFs, errorMaxFreqCTFs, errorMaxFreqCTFs2D)
# ---------------------------------------------------------------------------

def _full_freq_grid(xdim: int, Tm: float):
    f = np.fft.fftfreq(xdim) / Tm
    return f[:, None], f[None, :]


def error_between_2ctfs(ctf1: CTFDescription, ctf2: CTFDescription,
                        xdim: int, min_freq: float, max_freq: float,
                        device=None) -> float:
    """Sum over the full FFT grid of |CTF2_pure - CTF1_pure| (undamped pure
    values) restricted to digital |f| in [min_freq, max_freq] (converted to
    1/A with ctf1's sampling)."""
    fy, fx = _full_freq_grid(xdim, ctf1.Tm)
    mod = np.sqrt(fx * fx + fy * fy)
    lo, hi = min_freq / ctf1.Tm, max_freq / ctf1.Tm
    sel = (mod >= lo) & (mod <= hi)
    a, b = (c.pure_at(fx, fy, damped=False, device=device).cpu().numpy()
            .astype(np.float64) for c in (ctf1, ctf2))
    return float(np.abs(b - a)[sel].sum())


def error_max_freq_ctfs(ctf1: CTFDescription, phase_rad: float) -> float:
    """Resolution (A) at which the astigmatic phase difference reaches
    phase_rad: 1/sqrt(phase/(K1·|dfU - dfV|))."""
    si = ctf1.side_info()
    return float(1.0 / np.sqrt(
        phase_rad / (si["K1"] * abs(ctf1.defocusU - ctf1.defocusV))))


def error_max_freq_ctfs_2d(ctf1: CTFDescription, ctf2: CTFDescription,
                           xdim: int, phase_rad: float,
                           device=None) -> float:
    """Resolution (A) from the area of the Fourier plane where the two CTFs'
    phase arguments differ by less than phase_rad."""
    fy, fx = _full_freq_grid(xdim, ctf1.Tm)
    a, b = (c.argument_at(fx, fy, device=device).cpu().numpy()
            .astype(np.float64) for c in (ctf1, ctf2))
    counter = int((np.abs(b - a) < phase_rad).sum())
    total = np.pi * xdim * xdim / 4.0
    max_freq_a = 1.0 / (2.0 * ctf1.Tm)
    res_inv = max_freq_a if counter > total else counter * max_freq_a / total
    return float(1.0 / res_inv)


def generate_image_with_2ctfs(ctf1: CTFDescription, ctf2: CTFDescription,
                              xdim: int, device=None) -> np.ndarray:
    """Centered CTF display image: right half (fx in [0, 0.5)) from ctf1,
    left half from ctf2 (reference generateCTFImageWith2CTFs)."""
    fy, fx = _full_freq_grid(xdim, ctf1.Tm)
    fx, fy = np.broadcast_arrays(fx, fy)
    v1, v2 = (c.pure_at(fx, fy, damped=True, device=device).cpu().numpy()
              for c in (ctf1, ctf2))
    right = np.fft.fftfreq(xdim) >= 0
    return np.fft.fftshift(np.where(right[None, :], v1, v2))


# ---------------------------------------------------------------------------
# Batched per-image CTF evaluation + gridding inversion factors
# (reference reconstruct_fourier.cpp:576-625: per-Fourier-sample
#  wCTF/wModulator computed from each row's CTF inside the gridding loop)
# ---------------------------------------------------------------------------

# CTFDescription fields consumed by the pure (signal) model, in the order
# expected by ctf_pure_batched's parameter dict.
CTF_PURE_FIELDS = ("defocusU", "defocusV", "azimuthal_angle", "voltage",
                   "Cs", "Ca", "espr", "ispr", "alpha", "DeltaF", "DeltaR",
                   "Q0", "K", "envR0", "envR1", "envR2", "phase_shift",
                   "VPP_radius")


def ctf_params_arrays(ctfs) -> dict:
    """Stack a sequence of CTFDescription (or row dicts) into a dict of
    (C,) float32 numpy arrays keyed by CTF_PURE_FIELDS: the form in which
    both packages carry per-image CTF parameters."""
    defaults = {f.name: f.default for f in fields(CTFDescription)}
    out = {}
    for f in CTF_PURE_FIELDS:
        if isinstance(ctfs[0], CTFDescription):
            out[f] = np.array([getattr(c, f) for c in ctfs], np.float32)
        else:
            label = CTFDescription._MD_MAP[f]
            out[f] = np.array([float(c.get(label, defaults[f])) for c in ctfs],
                              np.float32)
    return out


def ctf_pure_batched(fx, fy, p: dict, damped: bool = True, device=None):
    """Damped pure CTF for a batch of images at shared frequencies.

    fx, fy: (S,) continuous frequencies (1/A); p: dict of (C,) arrays or
    tensors (CTF_PURE_FIELDS). Returns (C, S) float32 on the frequencies'
    device — the batched equivalent of CTFDescription.pure_at (reference
    getValuePureNoKAt, data/ctf.h:499), computed from the float32
    parameters as the reference package's ctf_pure_batched computes it."""
    fx, fy = _freqs(fx, fy, device)
    fx, fy = fx[None, :], fy[None, :]
    g = lambda k: as_tensor(p[k], fx.device)[:, None]
    local_Cs = g("Cs") * 1e7
    local_Ca = g("Ca") * 1e7
    local_kV = g("voltage") * 1e3
    local_ispr = g("ispr") * 1e6
    lam = 12.2643247 / torch.sqrt(local_kV * (1 + 0.978466e-6 * local_kV))
    K1 = math.pi * lam
    K2 = math.pi / 2 * local_Cs * lam ** 3
    K3 = (0.25 * math.pi * local_Ca * lam *
          (g("espr") / g("voltage") + 2 * local_ispr)) ** 2 / math.log(2.0)
    K5 = math.pi * g("DeltaF") * lam
    K6 = math.pi ** 2 * g("alpha") ** 2
    K7 = local_Cs * lam ** 2
    Q0 = g("Q0")
    Ksin = torch.sqrt(torch.clamp(1 - Q0 * Q0, min=0.0))
    defocus_average = -(g("defocusU") + g("defocusV")) / 2
    defocus_deviation = -(g("defocusU") - g("defocusV")) / 2
    az = torch.deg2rad(g("azimuthal_angle"))

    u2 = fx * fx + fy * fy
    u = torch.sqrt(u2)
    u4 = u2 * u2
    safe = torch.clamp(u2, min=1e-30)
    c2t = (fx * fx - fy * fy) / safe
    s2t = 2 * fx * fy / safe
    cos2 = c2t * torch.cos(2 * az) + s2t * torch.sin(2 * az)
    deltaf = torch.where(u2 > 0,
                         defocus_average + defocus_deviation * cos2, 0.0)
    vppr = g("VPP_radius")
    vpp_on = torch.round(vppr * 1000) != 0
    VPP = torch.where(
        vpp_on,
        -g("phase_shift") * (1 - torch.exp(
            -u2 / (2 * torch.clamp(vppr, min=1e-6) ** 2))),
        0.0)
    arg = VPP + K1 * deltaf * u2 + K2 * u4
    ctf = -(Ksin * torch.sin(arg) - Q0 * torch.cos(arg))
    if damped:
        Eespr = torch.exp(-K3 * u4)
        EdeltaF = _bessel_j0(K5 * u2)
        EdeltaR = torch.sinc(u * g("DeltaR"))
        aux = K7 * u2 * u + deltaf * u
        Ealpha = torch.exp(-K6 * aux * aux)
        E = Eespr * EdeltaF * EdeltaR * Ealpha + \
            g("envR0") + g("envR1") * u + g("envR2") * u2
        ctf = ctf * torch.clamp(E, min=0.0)
    return g("K") * ctf


def gridding_ctf_factors(cvals, min_ctf, phase_flipped: bool, device=None):
    """Per-sample data/weight multipliers for CTF-weighted Fourier gridding.

    The reference branch logic (reconstruct_fourier.cpp:600-625): with c
    the CTF value at a sample,
      |c| >= minCTF : data *= 1/c,      weights *= 1
      |c| <  minCTF : data *= sgn(c),   weights *= |c|
    NaN CTF values zero both factors. With --phaseFlipped the data factor
    takes fabs (the sign was already removed from the images). Returns
    (m_data, m_w), both shaped like cvals, as tensors on its device (numpy
    goes to `device`)."""
    cvals = as_tensor(cvals, device)
    a = torch.abs(cvals)
    below = a < min_ctf
    m_w = torch.where(below, a, 1.0)
    m_data = torch.where(below, torch.sign(cvals),
                         1.0 / torch.where(below, 1.0, cvals))
    bad = torch.isnan(cvals)
    m_w = torch.where(bad, 0.0, m_w)
    m_data = torch.where(bad, 0.0, m_data)
    if phase_flipped:
        m_data = torch.abs(m_data)
    return m_data, m_w
