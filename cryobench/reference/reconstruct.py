"""Plain reference of the reconstruct job: direct Fourier gridding with the
Kaiser-Bessel blob and the per-frequency CTF inversion of
`reconstruct_fourier --useCTF --phaseFlipped`, and the finalize that turns
the gridded cubes into the map. Plain PyTorch; imports nothing of the
program.

Gridding, at a voxel v of the padded cube (P = 2n, centre c = P/2): the
sum over every particle, every symmetry copy and every kept frequency
(kx, ky) of the particle's half spectrum (|f| <= max_freq) of
KB(|v - s|^2) times the sample's value, where s = c + (P/n)(kx m0 + ky m1)
with m0, m1 the rows of Euler(particle) * S, and KB(d^2) =
I0(alpha sqrt(1 - d^2/r^2)) / I0(alpha) within the blob radius r. The
value is the spectrum of the image (origin at its centre) times the phase
of its shift, exp(-2 pi i (fx sx + fy sy)), times 1/|CTF| where |CTF| >=
minCTF and 1 below it, into the data cubes; 1, or |CTF| below minCTF, into
the weight cube. Only the planes within r of a voxel reach it, and of a
plane only the 2 x 2 frequencies nearest the voxel's projection onto it,
so the sums at a sample of voxels cost a few seconds.

The CTF is the configuration's (`data.ctf_values` at frequency f / Ts);
where its magnitude lies within `CTF_TIE` of minCTF, float32 rounding may
put a sample on either side of the threshold, so both choices bound the
sum.

Finalize: the cubes plus their point mirrors (conjugate for the imaginary
part), the data divided by the weights where these exceed 1e-3 (else 0),
the inverse 3-D DFT with the origin at the centre, the central n^3 crop.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from cryobench.reference import dft

CTF_TIE = 1e-4


def kb(d2: torch.Tensor, radius: float, alpha: float) -> torch.Tensor:
    """The Kaiser-Bessel blob of order 0 at squared distance d2 (float64)."""
    t = torch.clamp(1.0 - d2 / (radius * radius), min=0.0)
    i0a = torch.special.i0(torch.tensor(alpha, dtype=torch.float64))
    w = torch.special.i0(alpha * torch.sqrt(t)) / i0a.to(d2.device)
    return torch.where(d2 <= radius * radius, w, torch.zeros_like(w))


def sample_voxels(rng: np.random.Generator, count: int, P: int,
                  margin: int = 4) -> np.ndarray:
    """(count', 3) distinct voxels (z, y, x), uniform in the ball of radius
    P/2 - margin about the centre: every sample that reaches them lies
    inside the cube with no rounding at its faces to decide."""
    R = P // 2 - margin
    d = rng.standard_normal((count, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = d * (R * rng.uniform(0, 1, count) ** (1 / 3))[:, None]
    vox = np.rint(pts).astype(np.int64) + P // 2
    return np.unique(vox, axis=0)


def disk(n: int, max_freq: float) -> np.ndarray:
    """(n, n//2+1) kept samples of the half spectrum, |f| <= max_freq."""
    fy = np.fft.fftfreq(n).astype(np.float32)[:, None]
    fx = np.fft.rfftfreq(n).astype(np.float32)[None, :]
    return np.sqrt(fy ** 2 + fx ** 2) <= max_freq


def voxel_sums(voxels, stack, poses, groups, group_of, sym_mats, cfg, mix,
               prec: str, chunk: int = 1024):
    """The three gridded cubes at `voxels`: (lo, hi), each (3, K) float64
    (data real, data imaginary, weight), between which every rounding of
    the CTF threshold lies; in "bf16" the sums are computed and accumulated
    in bfloat16 and lo == hi."""
    from cryobench.data import ctf_values, euler_matrix
    dev = stack.device
    V, n, _ = stack.shape
    P = int(round(n * mix["pad"]))
    P += P % 2
    step = P / n
    c = P // 2
    r = float(mix["blob"][0])
    alpha = float(mix["blob"][2])
    sz, ctf = cfg["sizes"], cfg["ctf"]
    Ts, min_ctf = sz["apix"], mix["min_ctf"]
    keep = torch.as_tensor(disk(n, mix["max_freq"]), device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    U = torch.as_tensor(voxels[:, ::-1] - c, **f64)          # (K, 3) x, y, z
    K = len(U)
    acc_t = torch.bfloat16 if prec == "bf16" else torch.float64
    lo = torch.zeros((3, K), dtype=acc_t, device=dev)
    hi = torch.zeros((3, K), dtype=acc_t, device=dev)
    gdfu, gdfv, gaz = (torch.as_tensor(groups[k], **f64)
                       for k in ("dfu", "dfv", "az"))
    gof = torch.as_tensor(group_of, device=dev)
    for s0 in range(0, V, chunk):
        s1 = min(s0 + chunk, V)
        imgs = torch.fft.ifftshift(stack[s0:s1], dim=(-2, -1))
        spec_r, spec_i = dft.rfft2(imgs, "bf16" if prec == "bf16" else "fp32")
        A = euler_matrix(poses["rot"][s0:s1], poses["tilt"][s0:s1],
                         poses["psi"][s0:s1])
        sxy = torch.as_tensor(np.stack([poses["sx"][s0:s1],
                                        poses["sy"][s0:s1]], 1), **f64)
        for S in sym_mats:
            M = torch.as_tensor(np.einsum("cij,jk->cik", A, S), **f64)
            h = U @ M[:, 2].T                                 # (K, C)
            k_idx, p_idx = torch.nonzero(h.abs() <= r, as_tuple=True)
            if k_idx.numel() == 0:
                continue
            u = U[k_idx]
            m = M[p_idx]
            a = (u * m[:, 0]).sum(1)
            b = (u * m[:, 1]).sum(1)
            hh = h[k_idx, p_idx]
            kx0 = torch.ceil((a - r) / step)
            ky0 = torch.ceil((b - r) / step)
            for i in (0, 1):
                for j in (0, 1):
                    kx, ky = kx0 + i, ky0 + j
                    d2 = (a - step * kx) ** 2 + (b - step * ky) ** 2 + hh ** 2
                    ok = ((kx >= 0) & (kx <= n // 2) & (ky >= -(n // 2))
                          & (ky <= (n - 1) // 2) & (d2 <= r * r))
                    kxi = kx.clamp(0, n // 2).long()
                    kyi = torch.remainder(ky, n).long()
                    ok &= keep[kyi, kxi]
                    sel = torch.nonzero(ok, as_tuple=True)[0]
                    if sel.numel() == 0:
                        continue
                    pk, kk = p_idx[sel], k_idx[sel]
                    fx, fy = kx[sel] / n, ky[sel] / n
                    xr = spec_r[pk, kyi[sel], kxi[sel]].to(torch.float64)
                    xi = spec_i[pk, kyi[sel], kxi[sel]].to(torch.float64)
                    ang = -2 * math.pi * (fx * sxy[pk, 0] + fy * sxy[pk, 1])
                    cs, sn = torch.cos(ang), torch.sin(ang)
                    vr, vi = xr * cs - xi * sn, xr * sn + xi * cs
                    g = gof[s0 + pk]
                    cv = ctf_values(fx / Ts, fy / Ts, gdfu[g], gdfv[g], gaz[g],
                                    sz["kv"], ctf["cs_mm"], ctf["q0"]).abs()
                    w = kb(d2[sel], r, alpha)
                    if prec == "bf16":
                        bf = lambda t: t.to(torch.bfloat16)
                        cvb = bf(cv)
                        above = cvb >= min_ctf
                        one = torch.ones_like(cvb)
                        dat = torch.where(above, one / cvb, one)
                        wt = torch.where(above, one, cvb)
                        wb = bf(w)
                        vals = torch.stack([wb * bf(vr) * dat,
                                            wb * bf(vi) * dat, wb * wt])
                        lo.index_add_(1, kk, vals)
                        continue
                    above = (cv >= min_ctf)
                    tie = (cv - min_ctf).abs() < CTF_TIE
                    one = torch.ones_like(cv)
                    alts = []
                    for side in (above, ~above):
                        side = torch.where(tie, side, above)
                        dat = torch.where(side, 1.0 / cv, one)
                        wt = torch.where(side, one, cv)
                        alts.append(torch.stack([w * vr * dat, w * vi * dat,
                                                 w * wt]))
                    lo.index_add_(1, kk, torch.minimum(*alts))
                    hi.index_add_(1, kk, torch.maximum(*alts))
    if prec == "bf16":
        lo = lo.to(torch.float64)
        return lo, lo
    return lo, hi


def mirror(a: torch.Tensor) -> torch.Tensor:
    """a at -k in the centred layout of even size: index i -> (P - i) mod P
    on every axis."""
    return torch.roll(torch.flip(a, dims=(0, 1, 2)), (1, 1, 1), (0, 1, 2))


def finalize(data_r, data_i, weights, n: int, prec: str,
             min_weight: float = 1e-3) -> torch.Tensor:
    """The (n, n, n) map of gridded cubes (P, P, P): float64, or in
    "bf16" every step before the inverse DFT in bfloat16."""
    P = data_r.shape[-1]
    t = torch.bfloat16 if prec == "bf16" else torch.float64
    dr = data_r.to(t)
    dr = dr + mirror(dr)
    di = data_i.to(t)
    di = di - mirror(di)
    w = weights.to(t)
    w = w + mirror(w)
    cw = torch.where(w > min_weight, 1.0 / torch.clamp(w, min=min_weight),
                     torch.zeros_like(w))
    del w
    real = torch.float32 if prec == "bf16" else torch.float64
    V = torch.complex((dr * cw).to(real), (di * cw).to(real))
    del dr, di, cw
    vol = torch.fft.fftshift(torch.fft.ifftn(torch.fft.ifftshift(V)).real)
    del V
    lo = (P - n) // 2 + (P - n) % 2
    return vol[lo:lo + n, lo:lo + n, lo:lo + n].to(torch.float64)
