"""Direct Fourier 3-D reconstruction (gridding backprojection) in torch.

Counterpart of the reference package's ops/reconstruct.py: per chunk of
particles, the 2-D FFTs, shift phases and gridding coordinates are computed
batched on the device, and the samples inside the resolution disk are
gridded into the padded Fourier cube (real, imaginary and weight channels)
by one of three hand-written CUDA kernels. Hermitian symmetry is enforced
once at the end, weights are corrected, and the spectrum is normalized,
inverse-FFT'd, cropped and optionally deapodized.

Interpolation windows and the kernel each one runs (reference --blob
<radius=1.9> <order=0> <alpha=15>):

  "kb"     direct Kaiser-Bessel, 4^3 taps   -> ops/scatter_kb.py (K3);
           with a blob radius above 2 the taps are expanded here and go
           to ops/scatter.py (K1)
  "tri"    trilinear, 8 taps                 -> ops/scatter_tri.py (K2)
  "tri+kb" trilinear + one dense 3-D convolution of the accumulated cubes
           with the grid-sampled blob         -> K2
  "nn"     nearest tap                       -> expansion here, then K1

The accumulators are plain (P, P, P) float32 tensors in fftshift layout,
updated in place. Static index sets (the resolution disk, the slice
frequencies) are built on the host once per shape and cached per device.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from scipy import special as ss

from xmipp3_tpu_torch.core.geometry import euler_matrix
from xmipp3_tpu_torch.core.sym import SymList
from xmipp3_tpu_torch.device import resolve_device
from xmipp3_tpu_torch.ops import scatter, scatter_kb, scatter_tri
from xmipp3_tpu_torch.ops.basis import kaiser_fourier_value, kaiser_value
from xmipp3_tpu_torch.ops.fourier import shift_spec_2d

# reference defaults: --blob <radius=1.9> <order=0> <alpha=15>
BLOB_RADIUS = 1.9
BLOB_ALPHA = 15.0
BLOB_ORDER = 0

_LATER_CTF = ("--useCTF gridding is not yet ported to xmipp3_tpu_torch "
              "(ROADMAP.md, port queue: --useCTF, the ops/ctf.py subset and "
              "ctf_gridding_multipliers)")
_LATER_SLAB = ("kz-slab accumulation (slab_p/slab_z0) is not yet ported to "
               "xmipp3_tpu_torch (ROADMAP.md, port queue: the mesh paths "
               "with K3's kz-slab mode)")


def _disk_mask(out_n: int, max_freq: float) -> np.ndarray:
    """Static boolean mask of rfft2 samples inside the resolution cutoff;
    samples outside contribute nothing and are compacted away."""
    fy = np.fft.fftfreq(out_n).astype(np.float32)
    fx = np.fft.rfftfreq(out_n).astype(np.float32)
    r = np.sqrt(fy[:, None] ** 2 + fx[None, :] ** 2)
    return r <= max_freq


@lru_cache(maxsize=32)
def _keep_index(out_n: int, max_freq: float, device: torch.device):
    """Flat indices of the kept rfft2 samples, on `device`."""
    keep = _disk_mask(out_n, max_freq)
    return torch.as_tensor(np.flatnonzero(keep.ravel()), device=device)


@lru_cache(maxsize=32)
def _slice_freqs(out_n: int, P: int, max_freq, device: torch.device):
    """(KX, KY) of the kept samples in cube units, float32 on `device`."""
    fy = np.fft.fftfreq(out_n).astype(np.float32)
    fx = np.fft.rfftfreq(out_n).astype(np.float32)
    KX = np.broadcast_to(fx[None, :], (out_n, fx.shape[0])) * P
    KY = np.broadcast_to(fy[:, None], (out_n, fx.shape[0])) * P
    if max_freq is not None:
        keep = _disk_mask(out_n, max_freq)
        KX, KY = KX[keep], KY[keep]
    return (torch.as_tensor(np.ascontiguousarray(KX.ravel()), device=device),
            torch.as_tensor(np.ascontiguousarray(KY.ravel()), device=device))


def _slice_tap_coords(mats, out_n: int, P: int, max_freq=None):
    """Frequency coords of each kept slice sample in cube index space.

    mats (C,3,3) float32 tensor -> zi, yi, xi each (C, S) float32 on its
    device, S = samples with |f| <= max_freq (all out_n*(out_n//2+1) when
    max_freq is None)."""
    c = P // 2
    KX, KY = _slice_freqs(out_n, P, max_freq, mats.device)
    m = mats[:, :2, :, None]                                # (C, 2, 3, 1)
    gx = KX * m[:, 0, 0] + KY * m[:, 1, 0]
    gy = KX * m[:, 0, 1] + KY * m[:, 1, 1]
    gz = KX * m[:, 0, 2] + KY * m[:, 1, 2]
    return gz + c, gy + c, gx + c


def _kb_window(d2, radius: float, alpha: float, order: int = 0):
    """Kaiser-Bessel radial profile at squared distance d2 (grid units),
    exact Bessel (reference kaiser_value, blobs.cpp:37); zero outside
    r <= radius."""
    t2 = torch.clamp(1.0 - d2 / (radius * radius), min=0.0)
    arg = alpha * torch.sqrt(t2)
    if order == 0:
        w = torch.special.i0(arg) / float(ss.iv(0, alpha))
    elif order == 2:
        # I2(x) = I0(x) - (2/x) I1(x); guard x->0 (I2(0)=0)
        safe = torch.clamp(arg, min=1e-6)
        i2 = torch.special.i0(safe) - 2.0 / safe * torch.special.i1(safe)
        i2 = torch.where(arg < 1e-6, 0.0, i2)
        w = t2 * i2 / float(ss.iv(2, alpha))
    else:
        raise NotImplementedError("blob order must be 0 or 2")
    return torch.where(d2 <= radius * radius, w, 0.0)


def _taps(interp: str, radius: float = BLOB_RADIUS):
    """Static footprint offsets for an interpolation window."""
    if interp == "nn":
        return [(0, 0, 0)]
    if interp in ("tri", "tri+kb"):
        return list(scatter_tri.TRI_TAPS)
    if interp == "kb":
        # offsets around floor() covering the blob radius, corners pruned:
        # taps t with |t - frac| < radius for some frac in [0, 1)
        lo, hi = int(np.floor(-radius)) + 1, int(np.ceil(radius + 1)) - 1

        def mind(o):
            return 0.0 if 0 <= o <= 1 else (o - 1 if o > 1 else -o)
        return [(dz, dy, dx)
                for dz in range(lo, hi + 1) for dy in range(lo, hi + 1)
                for dx in range(lo, hi + 1)
                if mind(dz) ** 2 + mind(dy) ** 2 + mind(dx) ** 2
                < radius * radius]
    raise ValueError(f"unknown interp {interp!r}")


def _footprint(zi, yi, xi, interp: str, blob):
    """What the tap expansion needs of a window without a gridding kernel
    of its own (nn, or a blob wider than kb_scatter_3ch takes): the base
    voxel (z0, y0, x0) int32 of every sample, the window's tap offsets and
    tap_weight(dz, dy, dx), the window's value at each sample's tap."""
    radius, order, alpha = float(blob[0]), int(blob[1]), float(blob[2])
    rnd = torch.round if interp == "nn" else torch.floor
    z0, y0, x0 = (rnd(a).to(torch.int32) for a in (zi, yi, xi))
    fz, fyw, fxw = zi - z0, yi - y0, xi - x0

    def tap_weight(dz, dy, dx):
        if interp == "nn":
            return torch.ones_like(fz)
        d2 = (fz - dz) ** 2 + (fyw - dy) ** 2 + (fxw - dx) ** 2
        return _kb_window(d2, radius, alpha, order)

    return z0, y0, x0, _taps(interp, radius), tap_weight


def backproject_chunk(data_r, data_i, weights, imgs, mats, sx, sy, img_w,
                      P: int, max_freq: float = 0.5, slab_p: int | None = None,
                      slab_z0=0, interp: str = "tri",
                      blob=(BLOB_RADIUS, BLOB_ORDER, BLOB_ALPHA),
                      ctf_data=None, ctf_w=None):
    """Accumulate a chunk of particles into the Fourier cube, in place.

    data_r/data_i/weights: (P,P,P) float32 accumulators (fftshift layout),
    all on one device; the other tensors are moved there. imgs: (C,N,N)
    float32 particles; mats: (C,3,3); sx/sy: (C,) alignment shifts
    (metadata shiftX/shiftY convention); img_w: (C,) weights.
    ctf_data/ctf_w: optional (C, S) per-kept-sample factors for the data
    and weight streams. Returns the accumulators."""
    if slab_p is not None:
        raise NotImplementedError(_LATER_SLAB)
    dev = data_r.device
    f32 = dict(dtype=torch.float32, device=dev)
    imgs, mats, sx, sy, img_w = (torch.as_tensor(a, **f32)
                                 for a in (imgs, mats, sx, sy, img_w))
    C, N, _ = imgs.shape
    # 2-D FFT with centered-origin phase convention + shift correction
    spec = torch.fft.rfft2(torch.fft.ifftshift(imgs, dim=(-2, -1)))
    spec = shift_spec_2d(spec, sx, sy, N, N)

    # resolution cutoff: samples outside the disk are dropped by a static
    # index set, since gridding updates dominate the cost
    spec = spec.reshape(C, -1)[:, _keep_index(N, max_freq, dev)]  # (C, S)
    wimg = img_w[:, None].expand(spec.shape)
    zi, yi, xi = _slice_tap_coords(mats, N, P, max_freq)

    sr = spec.real * wimg
    si = spec.imag * wimg
    wstream = wimg
    if ctf_data is not None:
        sr = sr * ctf_data
        si = si * ctf_data
        wstream = wimg * ctf_w
    samples = [a.contiguous().reshape(-1)
               for a in (zi, yi, xi, sr, si, wstream)]
    cubes = (data_r, data_i, weights)
    radius, order, alpha = float(blob[0]), int(blob[1]), float(blob[2])

    if interp == "kb" and radius <= 2.0:
        return scatter_kb.kb_scatter_3ch(*cubes, *samples, P=P, radius=radius,
                                         alpha=alpha, order=order)
    if interp in ("tri", "tri+kb"):
        return scatter_tri.tri_scatter(*cubes, *samples, P=P)

    expand = (*_footprint(zi, yi, xi, interp, blob), sr, si, wstream, P)
    if interp == "nn":
        return scatter.scatter_add_3ch(*cubes, *scatter.expand_taps(*expand))
    # a footprint of several taps: one stream per tap, so that a sample's
    # taps go out together (on an H100, K5 takes 0.4 of K1's time on the 160
    # tap streams of a radius-2.5 blob and 0.6 on 8 trilinear ones)
    return scatter.scatter_add_3ch_streams(
        *cubes, *scatter.expand_tap_streams(*expand))


def _conj_mirror(a):
    """x(k) -> x(-k) in fftshift layout (even sizes)."""
    return torch.roll(torch.flip(a, dims=(0, 1, 2)), (1, 1, 1), (0, 1, 2))


@lru_cache(maxsize=8)
def _blob_grid_kernel(blob=(BLOB_RADIUS, BLOB_ORDER, BLOB_ALPHA)):
    """KB blob sampled at integer grid lags -> small odd numpy kernel,
    normalized to sum 1 so that convolving density-compensated cubes
    preserves local scale."""
    radius, order, alpha = blob
    r = int(np.ceil(radius - 1e-6)) - 1 if radius <= 2.0 else \
        int(np.floor(radius))
    g = np.arange(-r, r + 1)
    d = np.sqrt(g[:, None, None] ** 2 + g[None, :, None] ** 2
                + g[None, None, :] ** 2)
    k = kaiser_value(d, radius, alpha, order)
    return (k / k.sum()).astype(np.float32)


def _conv3(cube, kern3: np.ndarray):
    """Dense 3-D convolution with a small odd kernel via shifted adds (the
    counterpart of the reference's 27 rolls). Kept in plain float32: a
    library convolution may run in TF32 on the card."""
    r = kern3.shape[0] // 2
    out = torch.zeros_like(cube)
    for dz in range(-r, r + 1):
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                kv = float(kern3[dz + r, dy + r, dx + r])
                if kv == 0.0:
                    continue
                out = out + kv * torch.roll(cube, (dz, dy, dx), (0, 1, 2))
    return out


def _deapodization(N: int, P: int, interp: str,
                   blob=(BLOB_RADIUS, BLOB_ORDER, BLOB_ALPHA)):
    """Real-space correction = IFT of the gridding window, sampled at the
    output voxel grid (reference Fourier_blob_table / sinc^2 factors),
    normalized to 1 at the center."""
    x = (np.arange(N, dtype=np.float64) - N // 2) / P
    comp = np.ones((N, N, N))
    if interp in ("tri", "tri+kb"):
        s = np.sinc(x) ** 2
        comp = comp * (s[:, None, None] * s[None, :, None]
                       * s[None, None, :])
    elif interp == "nn":
        s = np.sinc(x)
        comp = comp * (s[:, None, None] * s[None, :, None]
                       * s[None, None, :])
    if interp in ("kb", "tri+kb"):
        radius, order, alpha = blob
        r = np.sqrt(x[:, None, None] ** 2 + x[None, :, None] ** 2
                    + x[None, None, :] ** 2)
        kb = kaiser_fourier_value(r, radius, alpha, order)
        kb0 = kaiser_fourier_value(0.0, radius, alpha, order)
        comp = comp * (kb / kb0)
    return comp.astype(np.float32)


def finalize_volume(data_r, data_i, weights, N: int, P: int,
                    min_weight: float = 1e-3, interp: str = "tri",
                    niter_weight: int = 1, deapodize: bool = False,
                    blob=(BLOB_RADIUS, BLOB_ORDER, BLOB_ALPHA)):
    """Hermitian-symmetrize, correct weights, normalize, inverse FFT, crop,
    deapodize. Returns the (N, N, N) float32 volume on the accumulators'
    device.

    Weight correction: niter_weight=0 leaves the raw gridded spectrum;
    1 = plain density compensation V = D/W (the reference default --iter 1);
    >1 runs re-gridding refinements c <- c / (B * (c.W)) with B the
    grid-sampled blob (a no-op for the pure trilinear window).

    deapodize defaults to False: in the ratio formulation V = D/W the
    gridding window cancels, so dividing by the window's IFT over-corrects;
    deapodize=True reproduces the windowed correction for parity studies."""
    blob = tuple(blob)
    if interp == "tri+kb":
        kern = _blob_grid_kernel(blob)
        data_r = _conv3(data_r, kern)
        data_i = _conv3(data_i, kern)
        weights = _conv3(weights, kern)
    dr = data_r + _conj_mirror(data_r)
    di = data_i - _conj_mirror(data_i)
    w = weights + _conj_mirror(weights)
    if niter_weight == 0:
        V = torch.complex(dr, di)
    else:
        c = torch.where(w > min_weight,
                        1.0 / torch.clamp(w, min=min_weight), 0.0)
        if niter_weight > 1 and interp in ("kb", "tri+kb"):
            kern = _blob_grid_kernel(blob)
            for _ in range(niter_weight - 1):
                denom = _conv3(c * w, kern)
                c = torch.where(denom > min_weight,
                                c / torch.clamp(denom, min=min_weight), c)
        V = torch.complex(dr * c, di * c)
    vol = torch.fft.fftshift(torch.fft.ifftn(torch.fft.ifftshift(V))).real
    # crop padding (centered)
    lo = (P - N) // 2 + (P - N) % 2
    vol = vol[lo:lo + N, lo:lo + N, lo:lo + N]
    if deapodize:
        comp = torch.as_tensor(_deapodization(N, P, interp, blob),
                               device=vol.device)
        vol = vol / torch.clamp(comp, min=1e-3)
    return vol.contiguous()


class FourierReconstructor:
    """Streaming direct-Fourier reconstructor.

    Usage: r = FourierReconstructor(N, pad_factor=2); r.add_batch(imgs, rot,
    tilt, psi, sx, sy, w); vol = r.finish(). Symmetry is applied by adding
    each batch once per symmetry rotation (reference R_repository loop).
    The accumulators live on `device` (default: the card)."""

    def __init__(self, N: int, pad_factor: float = 2.0, sym: str = "c1",
                 max_freq: float = 0.5, interp: str = "kb",
                 niter_weight: int = 1,
                 blob=(BLOB_RADIUS, BLOB_ORDER, BLOB_ALPHA), device=None):
        self.device = resolve_device(device)
        self.N = N
        P = int(round(N * pad_factor))
        P += P % 2
        self.P = P
        self.max_freq = max_freq
        self.interp = interp
        self.niter_weight = niter_weight
        self.blob = tuple(blob)
        zeros = dict(dtype=torch.float32, device=self.device)
        self.data_r = torch.zeros((P, P, P), **zeros)
        self.data_i = torch.zeros((P, P, P), **zeros)
        self.weights = torch.zeros((P, P, P), **zeros)
        self.sym = SymList(sym)

    @classmethod
    def from_jax_state(cls, data_r, data_i, weights, N: int, device=None,
                       **kwargs):
        """Continue an accumulation begun by the reference package: data_r,
        data_i, weights are the numpy (P,P,P) accumulators of its
        FourierReconstructor (for the TPU's packed layout, unpack them first
        with ops.scatter_tri.unpack_packed_cube). kwargs as __init__."""
        rec = cls(N, device=device, **kwargs)
        for name, a in (("data_r", data_r), ("data_i", data_i),
                        ("weights", weights)):
            a = np.asarray(a, np.float32)
            if a.shape != (rec.P,) * 3:
                raise ValueError(f"from_jax_state: {name} has shape "
                                 f"{a.shape}, expected {(rec.P,) * 3}")
            getattr(rec, name).copy_(torch.tensor(a))
        return rec

    def add_batch(self, imgs, rot, tilt, psi, sx=None, sy=None, weights=None,
                  flip=None, ctfp=None):
        """Grid one batch of particles, once per symmetry operator."""
        if ctfp is not None:
            raise NotImplementedError(_LATER_CTF)
        imgs = torch.as_tensor(imgs, dtype=torch.float32, device=self.device)
        if imgs.ndim == 2:
            imgs = imgs[None]
        C = imgs.shape[0]
        z = np.zeros(C, np.float32)
        sx = z if sx is None else np.asarray(sx, np.float32)
        sy = z if sy is None else np.asarray(sy, np.float32)
        if flip is not None and np.any(flip):
            # stored flip: shift(img, s) = M_x proj(pose). Backproject the
            # x-mirrored image with negated shiftX instead.
            f = np.asarray(flip).astype(bool)
            fj = torch.as_tensor(f, device=self.device)
            imgs = torch.where(fj[:, None, None], imgs.flip(-1), imgs)
            sx = np.where(f, -sx, sx)
        w = np.ones(C, np.float32) if weights is None else \
            np.asarray(weights, np.float32)
        A = np.asarray(euler_matrix(np.asarray(rot, np.float32),
                                    np.asarray(tilt, np.float32),
                                    np.asarray(psi, np.float32)), np.float32)
        if A.ndim == 2:
            A = np.broadcast_to(A[None], (C, 3, 3))
        for S in self.sym.sym_matrices():
            # symmetry-equivalent pose: volume rotated by S ~ slice at A·S
            Asym = np.einsum("cij,jk->cik", A, S.astype(np.float32))
            backproject_chunk(self.data_r, self.data_i, self.weights, imgs,
                              Asym, sx, sy, w, self.P, self.max_freq,
                              interp=self.interp, blob=self.blob)

    def finish(self):
        return finalize_volume(self.data_r, self.data_i, self.weights,
                               self.N, self.P, interp=self.interp,
                               niter_weight=self.niter_weight,
                               blob=self.blob)


def reconstruct_fourier(imgs, rot, tilt, psi, sx=None, sy=None, weights=None,
                        pad_factor: float = 2.0, sym: str = "c1",
                        batch: int = 256, max_freq: float = 0.5, flip=None,
                        interp: str = "kb", niter_weight: int = 1,
                        blob=(BLOB_RADIUS, BLOB_ORDER, BLOB_ALPHA),
                        ctfp=None, device=None):
    """One-call reconstruction of a full stack; returns the volume as a
    tensor on `device` (default: the card)."""
    if ctfp is not None:
        raise NotImplementedError(_LATER_CTF)
    imgs = np.asarray(imgs, np.float32)
    N = imgs.shape[-1]
    rec = FourierReconstructor(N, pad_factor, sym, max_freq, interp,
                               niter_weight, blob, device=device)
    B = imgs.shape[0]
    for s in range(0, B, batch):
        sl = slice(s, min(s + batch, B))
        rec.add_batch(imgs[sl], np.asarray(rot)[sl], np.asarray(tilt)[sl],
                      np.asarray(psi)[sl],
                      None if sx is None else np.asarray(sx)[sl],
                      None if sy is None else np.asarray(sy)[sl],
                      None if weights is None else np.asarray(weights)[sl],
                      None if flip is None else np.asarray(flip)[sl])
    return rec.finish()
