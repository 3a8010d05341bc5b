"""Image feature extractors for classification screening, translational
centering and SPG total-variation denoising.

Counterpart of the reference package's ops/features.py (the reference's
classify_extract_features engine, classify_extract_features.{h,cpp}). Every
extractor takes a (B, H, W) stack and returns (B, F) float32 on the stack's
device (numpy input goes to `device`, the card by default). The TPU's
one-hot histogram matmuls become one `torch.bincount` over the whole batch,
each image's bins offset by its index; the pairwise histogram distances
stay quadratic forms m^T D m against a cached distance matrix, in full
float32. The reference's quantisation (`_hist_entropy`) and coordinate
quirks (extract_zernike's Sy for x, classify_extract_features.cpp:520-527)
are kept exactly, so feature vectors are comparable.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from xmipp3_tpu_torch.device import as_tensor, fp32_products
from xmipp3_tpu_torch.ops.geo import shift_2d_real
from xmipp3_tpu_torch.ops.mask import circular_mask
from xmipp3_tpu_torch.ops.shift import best_shift

__all__ = [
    "extract_entropy", "extract_granulo", "extract_histdist",
    "extract_lbp", "extract_ramp", "extract_variance", "extract_zernike",
    "center_translationally", "tv_denoise_spg",
]


def _batched_hist(idx, nbins: int):
    """Histograms of the rows of an integer (R, P) tensor of bin indices in
    [0, nbins): (R, nbins) float32, one bincount for all rows."""
    R = idx.shape[0]
    off = torch.arange(R, device=idx.device)[:, None] * nbins
    return torch.bincount((idx + off).reshape(-1),
                          minlength=R * nbins).reshape(R, nbins).float()


# ---------------------------------------------------------------- entropy

def _hist_entropy(x):
    """-sum_i max(h_i,1)*log2(max(h_i,1)) over a 256-bin histogram of each
    row of x (R, P), reference classify_extract_features.cpp:105-121."""
    m = x.amin(dim=1, keepdim=True)
    M = x.amax(dim=1, keepdim=True)
    idx = torch.clamp(torch.floor((x - m) * 255.0 / (M - m)), 0, 255)
    h = torch.clamp(_batched_hist(idx.long(), 256), min=1.0)
    return -(h * torch.log2(h)).sum(dim=1)


@lru_cache(maxsize=8)
def _entropy_masks(h, w):
    """Ring masks 2..6 (cpp:149-167): 2*circ(w-s) - circ(w) - circ(w-2s),
    w starting at X/2 with step X/32."""
    masks = []
    wave = w // 2
    step = w // 32
    for _ in range(5):
        m = (2 * circular_mask((h, w), wave - step)
             - circular_mask((h, w), wave)
             - circular_mask((h, w), wave - 2 * step))
        masks.append(m != 0)          # apply_binary_mask keeps mask != 0
        wave -= step
    return np.stack(masks)


def extract_entropy(imgs, device=None):
    """(B,H,W) -> (B,6): whole-image + 5 ring entropies."""
    imgs = as_tensor(imgs, device)
    B, H, W = imgs.shape
    masks = torch.as_tensor(_entropy_masks(H, W), device=imgs.device)
    rings = torch.where(masks[None], imgs[:, None], 0.0)      # (B,5,H,W)
    x = torch.cat([imgs[:, None], rings], dim=1).reshape(B * 6, H * W)
    return _hist_entropy(x).reshape(B, 6)


# --------------------------------------------------------------- granulo

def _se_offsets(N):
    return [(dy, dx) for dy in range(-N, N + 1) for dx in range(-N, N + 1)
            if dx * dx + dy * dy <= N * N]


def extract_granulo(imgs, device=None):
    """(B,H,W) -> (B,6): sums of morphological openings with circular
    structuring elements of radius 1..6 (cpp:196-265); the window reads
    +/-3.4e38 outside the image (the reference clips it at the borders)."""
    imgs = as_tensor(imgs, device)
    B, H, W = imgs.shape
    if W < 15 or H < 15:
        raise ValueError("granulo features need images >= 15x15")
    big = 3.4e38
    pad = 6
    hi = F.pad(imgs, (pad,) * 4, value=big)
    out = []
    for N in range(1, 7):
        offs = [o for o in _se_offsets(N) if o != (0, 0)]
        ero = imgs
        for dy, dx in offs:
            ero = torch.minimum(ero, hi[:, pad + dy:pad + dy + H,
                                        pad + dx:pad + dx + W])
        lo = F.pad(ero, (pad,) * 4, value=-big)
        dil = ero
        for dy, dx in offs:
            dil = torch.maximum(dil, lo[:, pad + dy:pad + dy + H,
                                        pad + dx:pad + dx + W])
        out.append(dil.sum(dim=(-2, -1)))
    return torch.stack(out, dim=-1)


# -------------------------------------------------------------- histdist

@lru_cache(maxsize=8)
def _pair_dist_matrix(ph, pw):
    yy, xx = np.mgrid[0:ph, 0:pw].astype(np.float32)
    pts = np.stack([yy.ravel(), xx.ravel()], axis=1)
    d = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))
    return d.astype(np.float32)


def extract_histdist(imgs, device=None):
    """(B,H,W) -> (B,18): mean pairwise distances of the high- and
    low-intensity points of each 3x3-grid subimage (scan order yy, xx;
    high then low; cpp:269-362). A subimage with fewer than two such
    points gives nan/inf, as the reference does."""
    imgs = as_tensor(imgs, device)
    B, H, W = imgs.shape
    ph, pw = H // 3, W // 3
    parts = imgs[:, :3 * ph, :3 * pw].reshape(B, 3, ph, 3, pw) \
        .permute(0, 1, 3, 2, 4).reshape(B * 9, ph * pw)
    D = torch.as_tensor(_pair_dist_matrix(ph, pw), device=imgs.device)
    count = ph + pw
    m = parts.amin(dim=1, keepdim=True)
    M = parts.amax(dim=1, keepdim=True)
    q = torch.floor((parts - m) * 255.0 / (M - m))
    hist = _batched_hist(torch.clamp(q, 0, 255).long(), 256)
    # low_thresh: one past the bin where the cumulative count reaches
    # `count`; points strictly below it
    low = torch.argmax((hist.cumsum(1) >= count).int(), dim=1) + 1
    high = 254 - torch.argmax((hist.flip(1).cumsum(1) >= count).int(), dim=1)
    masks = torch.stack([(q > high[:, None]), (q < low[:, None])],
                        dim=1).float()                     # (B*9, 2, P)
    n = masks.sum(dim=2)
    with fp32_products():
        s = 0.5 * (masks * (masks @ D)).sum(dim=2)
    return (s / (n * (n - 1.0) / 2.0)).reshape(B, 18)


# ------------------------------------------------------------------- LBP

@lru_cache(maxsize=1)
def _lbp_remap():
    min_idxs = []
    for i in range(256):
        code = i
        best = code
        for _ in range(7):
            code = ((code >> 1) | ((code & 1) << 7)) & 0xFF
            best = min(best, code)
        min_idxs.append(best)
    uniq = sorted(set(min_idxs))
    assert len(uniq) == 36
    return np.asarray([uniq.index(mi) for mi in min_idxs], np.int64)


def extract_lbp(imgs, device=None):
    """(B,H,W) -> (B,36): rotation-minimal LBP histogram (cpp:366-421)."""
    imgs = as_tensor(imgs, device)
    c = imgs[:, 1:-1, 1:-1]
    nb = [imgs[:, :-2, :-2], imgs[:, :-2, 1:-1], imgs[:, :-2, 2:],
          imgs[:, 1:-1, 2:], imgs[:, 2:, 2:], imgs[:, 2:, 1:-1],
          imgs[:, 2:, :-2], imgs[:, 1:-1, :-2]]
    code = torch.zeros(c.shape, dtype=torch.int64, device=imgs.device)
    for bit, n in enumerate(nb):
        code |= (n > c).long() << (7 - bit)
    slot = torch.as_tensor(_lbp_remap(), device=imgs.device)[code]
    return _batched_hist(slot.reshape(len(slot), -1), 36)


# ------------------------------------------------------------------ ramp

@lru_cache(maxsize=8)
def _ramp_basis(h, w):
    """Pseudo-inverse of the LS plane fit over the OUTSIDE of the
    X/2-radius circle, logical (centered) coordinates (cpp:424-453)."""
    mask = circular_mask((h, w), w // 2) == 0
    j = (np.arange(w) - w // 2)[None, :] * np.ones((h, 1))
    i = (np.arange(h) - h // 2)[:, None] * np.ones((1, w))
    A = np.stack([j[mask], i[mask], np.ones(mask.sum())], axis=1)
    return mask, np.linalg.pinv(A).astype(np.float32)       # (3, Npts)


def extract_ramp(imgs, device=None):
    """(B,H,W) -> (B,3): LS plane coefficients (pA, pB, pC) outside the
    central circle."""
    imgs = as_tensor(imgs, device)
    mask, pinv = _ramp_basis(imgs.shape[-2], imgs.shape[-1])
    pts = imgs[:, torch.as_tensor(mask, device=imgs.device)]
    with fp32_products():
        return pts @ torch.as_tensor(pinv, device=imgs.device).T


# -------------------------------------------------------------- variance

def extract_variance(imgs, device=None):
    """(B,H,W) -> (B,17): 4x4 block variances (scan order) + the
    inner/outer variance ratio (cpp:450-506)."""
    imgs = as_tensor(imgs, device)
    B, H, W = imgs.shape
    bh, bw = H // 4, W // 4
    blocks = imgs[:, :4 * bh, :4 * bw].reshape(B, 4, bh, 4, bw)
    mean = blocks.mean(dim=(2, 4), keepdim=True)
    var = ((blocks - mean) ** 2).sum(dim=(2, 4)) / (bh * bw)   # (B,4,4)
    inner = torch.zeros((4, 4), dtype=torch.bool, device=imgs.device)
    inner[1:3, 1:3] = True
    var_i = (var * inner).sum(dim=(1, 2))
    var_o = (var * ~inner).sum(dim=(1, 2))
    ratio = (var_i / 4.0) / (var_o / 12.0)
    return torch.cat([var.reshape(B, 16), ratio[:, None]], dim=1)


# --------------------------------------------------------------- zernike

def _facs(n):
    return (1, 1, 2, 6, 24)[n]


@lru_cache(maxsize=8)
def _zernike_basis(sy, sx):
    """Real/imag basis images for the 6 reference moments
    (n,m) in {(1,-1),(2,-2),(3,-3),(3,-1),(4,-4),(4,-2)}, with the
    reference's Sy in the x coordinate (cpp:520-527)."""
    y, x = np.mgrid[0:sy, 0:sx]
    r2 = 2 * (y + 1) - sy - 1
    r1 = 2 * (x + 1) - sy - 1          # sic: Sy, as in the reference
    R = np.sqrt(r1 * r1 + r2 * r2) / sy
    R = np.where(R > 1, 0.0, R)
    Theta = np.arctan2(sy + 1 - 2 * (y + 1), 2 * (x + 1) - sy - 1)
    cos_b, sin_b = [], []
    for n in range(1, 5):
        for m in range(-n, 0, 2):
            mn = (n - abs(m)) // 2
            nm = (n + abs(m)) // 2
            rad = np.zeros_like(R)
            for s in range(mn + 1):
                c = ((1 if s % 2 == 0 else -1) * _facs(n - s)
                     / (_facs(s) * _facs(nm - s) * _facs(mn - s)))
                rad = rad + c * R ** (n - 2 * s)
            # exp(-i*m*Theta) = cos(mT) - i sin(mT)
            cos_b.append(rad * np.cos(m * Theta))
            sin_b.append(-rad * np.sin(m * Theta))
    return np.concatenate([np.stack(cos_b), np.stack(sin_b)]) \
        .astype(np.float32).reshape(12, -1)


def extract_zernike(imgs, device=None):
    """(B,H,W) -> (B,6): |Zernike moments| for n=1..4, m<0."""
    imgs = as_tensor(imgs, device)
    B = imgs.shape[0]
    basis = torch.as_tensor(_zernike_basis(imgs.shape[-2], imgs.shape[-1]),
                            device=imgs.device)
    with fp32_products():
        reim = imgs.reshape(B, -1) @ basis.T
    re, im = reim[:, :6], reim[:, 6:]
    return torch.sqrt(re * re + im * im)


# ----------------------------------------------- centering + TV denoise

def center_translationally(imgs, order: int = 3, device=None):
    """Center each image of a (B,H,W) stack at the average best shift
    against its X/Y/XY mirrors (reference centerImageTranslationally,
    filters.cpp:3212; the mirrors are plain reversals)."""
    imgs = as_tensor(imgs, device)
    sx = torch.zeros(imgs.shape[0], device=imgs.device)
    sy = torch.zeros(imgs.shape[0], device=imgs.device)
    for mirrored in (imgs.flip(2), imgs.flip(1), imgs.flip((1, 2))):
        mx, my, _ = best_shift(imgs, mirrored)
        sx = sx + mx
        sy = sy + my
    # the reference translates by MINUS the mean mirror-registration shift
    return shift_2d_real(imgs, -sx / 3.0, -sy / 3.0, order=order)


# line-search rounds run between two reads of the "still searching" flag
LS_ROUNDS = 4


def tv_denoise_spg(imgs, max_iter: int = 200, return_rounds: bool = False,
                   device=None):
    """Reference denoiseTVFilter (filters.cpp:4129-4259) on a (B,H,W)
    stack: generalized Anscombe VST + spectral projected gradient TV
    minimisation; returns the images in the VST domain scaled to [0,1], as
    the reference leaves them.

    The batch runs together. Each image keeps its own step ksi and leaves
    the line search when its own Armijo condition holds (a mask), as the
    reference package's vmapped while_loop does. The host reads one flag a
    step (is any image searching?), and one more after each LS_ROUNDS
    masked rounds while some image still searches. With return_rounds,
    also the (max_iter, B) int tensor of each image's line-search rounds."""
    spg = TVSPG(imgs, device)
    state = spg.start()
    rounds = torch.zeros((max_iter, len(spg.y)), dtype=torch.int32,
                         device=spg.y.device)
    for it in range(max_iter):
        state, rounds[it] = spg.step(state)
    return (state[0], rounds) if return_rounds else state[0]


class TVSPG:
    """The SPG TV problem of a (B,H,W) stack: its VST-domain data, energy
    and gradient, and one iteration of the reference's scan. A state is
    the scan's carry (x, gradient, direction, energy) of the reference's
    _tv_spg_one, batched."""

    lam, sigmag, g, q = 1.0, 5.8, 0.0, 255.0
    mu, gamma, s1, s2 = 0.03, 1e-4, 0.1, 0.9
    thetamin, thetamax = 1e-3, 1e3
    beta2 = 1e-5 ** 2

    def __init__(self, imgs, device=None):
        imgs = as_tensor(imgs, device)
        lam, q = self.lam, self.q
        col = lambda v: v[:, None, None]
        K1a = (3.0 / 8.0) * lam * lam + self.sigmag * self.sigmag \
            - lam * self.g
        xm = col(imgs.amin(dim=(1, 2)))
        xs = 255.0 / (col(imgs.amax(dim=(1, 2))) - xm)
        x = (imgs - xm) * xs
        x = 2.0 / lam * torch.sqrt(torch.clamp(lam * x + K1a, min=0.0))
        s = self.s = col(x.amax(dim=(1, 2)))
        self.y = x / s                           # degraded input
        self.K1 = K1a / (s * s)
        self.K2e = lam * (q / (s * s))           # energy K2
        self.K2g = lam * (q / s * s)             # gradient K2 (sic, cpp:4034)
        self.K3e = 2.0 / lam
        self.K3g = (2.0 / (lam * lam)) * (q / (s * s)) * lam

    def energy(self, X):
        dXx = torch.roll(X, -1, dims=2) - X
        dXy = torch.roll(X, -1, dims=1) - X
        tv = torch.sqrt(dXx * dXx + dXy * dXy + self.beta2).sum(dim=(1, 2))
        msq = self.K3e * torch.sqrt(torch.clamp(self.K2e * X + self.K1,
                                                min=0.0)) - self.y
        return 0.5 * (msq * msq).sum(dim=(1, 2)) + self.mu * tv

    def gradient(self, X):
        s, q, K1 = self.s, self.q, self.K1
        dXx = torch.roll(X, -1, dims=2) - X
        dXy = torch.roll(X, -1, dims=1) - X
        d = 1.0 / torch.sqrt(dXx * dXx + dXy * dXy + self.beta2)
        d_left = torch.roll(d, 1, dims=2)
        d_up = torch.roll(d, 1, dims=1)
        dTV = (X * (2.0 * d + d_left + d_up)
               - torch.roll(X, 1, dims=2) * d_left
               - torch.roll(X, 1, dims=1) * d_up
               - d * (torch.roll(X, -1, dims=2) + torch.roll(X, -1, dims=1)))
        dE = torch.where(
            self.K2g * X + K1 > 0,
            self.K3g - (q / (s * s)) * self.y
            / torch.sqrt(torch.clamp(X * (q / (s * s)) * self.lam + K1,
                                     min=1e-30)),
            0.0)
        return dE + self.mu * dTV

    @staticmethod
    def proj(X, G, theta):
        return torch.clamp(X - G * theta, 0.0, 1.0) - X

    def start(self):
        """The state before the first iteration."""
        x = self.y
        g = self.gradient(x)
        return x, g, self.proj(x, g, 1.0), self.energy(x)

    def step(self, state):
        """One iteration from `state`; returns (state, (B,) line-search
        rounds)."""
        xold, grold, dold, fold = state
        col = lambda v: v[:, None, None]
        xnew = xold + dold
        delta = (grold * dold).sum(dim=(1, 2))
        fnew = self.energy(xnew)
        ksi = torch.ones_like(fnew)
        rounds = torch.zeros(len(fnew), dtype=torch.int32, device=fnew.device)
        searching = fnew > fold + self.gamma * ksi * delta
        while bool(searching.any()):
            for _ in range(LS_ROUNDS):
                ksitsl = -0.5 * (ksi * ksi) * delta \
                    / (fnew - fold - ksi * delta)
                k2 = torch.where((ksitsl >= self.s1)
                                 & (ksitsl <= self.s2 * ksi),
                                 ksitsl, ksi / 2.0)
                xn = xold + col(k2) * dold
                fn = self.energy(xn)
                ksi = torch.where(searching, k2, ksi)
                xnew = torch.where(col(searching), xn, xnew)
                fnew = torch.where(searching, fn, fnew)
                rounds += searching.int()
                searching = searching & (fnew > fold
                                         + self.gamma * ksi * delta)
        grnew = self.gradient(xnew)
        xij = xnew - xold
        p = (xij * (grnew - grold)).sum(dim=(1, 2))
        ss2 = (xij * xij).sum(dim=(1, 2))
        theta = torch.where(p <= 0, self.thetamax,
                            torch.clamp(ss2 / p, self.thetamin,
                                        self.thetamax))
        return (xnew, grnew, self.proj(xnew, grnew, col(theta)),
                fnew), rounds
