"""Plain reference of the match job: the gallery, the matching scan and the
winner's refinement, as `angular_project_library` and
`angular_projection_matching` define them, in plain PyTorch with every
transform a product of tables (reference/dft.py) in a stated precision.
Imports nothing of the program.

Gallery: the map zero-padded to twice its size (centred), its 3-D DFT with
the origin at the centre; a direction's projection is the central slice
through the rows 0 and 1 of its Euler matrix, trilinear with zeros outside
the cube, inverted in 2-D.

Scan: each image resampled on polar rings 2, 4, ..., box/2-2 (bilinear,
128 angles, periodic) at each trial shift of the grid of step max_shift/2
within max_shift, each gallery image on the same rings (clipped to the
frame); 64 angular harmonics with the ring means removed; for every image,
reference and mirror the ring-weighted, normalised correlation over the
angle (126 samples, parabolic peak); the best over references, mirrors
and trials, the first trial winning ties.

Refinement: the image (mirrored in y about its centre for a mirror) is
rotated and shifted by four Fourier shears, its shift to the chosen
reference measured by the windowed cross-correlation peak within
max_shift, its rotation by the ring correlation at full angular sampling;
two Jacobi updates, then a last shift at the final rotation, the
normalised correlation of the aligned image with the reference, and the
pose in xmipp's metadata convention.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from cryobench.data import euler_matrix
from cryobench.reference import dft

HARMONICS = 64


def pad_spectrum(vol: torch.Tensor) -> torch.Tensor:
    """The centred complex DFT of the map zero-padded to 2n (complex64)."""
    n = vol.shape[-1]
    P = 2 * n
    lo = n // 2 + n % 2
    v = torch.nn.functional.pad(vol, (lo, n - lo) * 3)
    dims = (-3, -2, -1)
    return torch.fft.fftshift(torch.fft.fftn(torch.fft.ifftshift(
        v, dim=dims), dim=dims), dim=dims)


def gallery(vf: torch.Tensor, angles: np.ndarray, n: int, prec: str,
            chunk: int = 256) -> torch.Tensor:
    """(R, n, n) projections at the (rot, tilt) rows of `angles` (psi 0)."""
    P = vf.shape[-1]
    c = P // 2
    dev = vf.device
    kx = torch.as_tensor(np.fft.rfftfreq(n) * P, dtype=torch.float32,
                         device=dev)[None, None, :]
    ky = torch.as_tensor(np.fft.fftfreq(n) * P, dtype=torch.float32,
                         device=dev)[None, :, None]
    flat = vf.reshape(-1)
    out = []
    for s in range(0, len(angles), chunk):
        a = angles[s:s + chunk]
        M = torch.as_tensor(euler_matrix(a[:, 0], a[:, 1], np.zeros(len(a))),
                            dtype=torch.float32, device=dev)[..., None, None]
        pos = [kx * M[:, 0, i] + ky * M[:, 1, i] + c for i in (2, 1, 0)]
        base = [torch.floor(p) for p in pos]
        frac = [p - b for p, b in zip(pos, base)]
        acc = 0
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    idx = [b.to(torch.int64) + d for b, d in
                           zip(base, (dz, dy, dx))]
                    inside = torch.ones_like(idx[0], dtype=torch.bool)
                    for i in idx:
                        inside &= (i >= 0) & (i < P)
                    w = 1
                    for f, d in zip(frac, (dz, dy, dx)):
                        w = w * (f if d else 1 - f)
                    lin = ((idx[0].clamp(0, P - 1) * P
                            + idx[1].clamp(0, P - 1)) * P
                           + idx[2].clamp(0, P - 1))
                    acc = acc + torch.where(inside, w, 0.0) * flat[lin]
        img = dft.irfft2(acc.real.contiguous(), acc.imag.contiguous(),
                         (n, n), prec)
        out.append(torch.fft.fftshift(img, dim=(-2, -1)))
    return torch.cat(out)


# --------------------------------------------------------------- polar rings

def polar_grid(n: int, rmin: int, rmax: int, n_ang: int | None, stride: int):
    """(yy, xx) float32 (rings, angles): rings rmin..rmax every stride-th,
    n_ang angles (default the power of two above 2 pi rmax)."""
    if n_ang is None:
        n_ang = int(2 ** np.ceil(np.log2(2 * np.pi * rmax)))
    radii = np.arange(rmin, rmax + 1, dtype=np.float32)
    theta = (2 * np.pi * np.arange(n_ang) / n_ang).astype(np.float32)
    yy = n // 2 + radii[:, None] * np.sin(theta)[None, :]
    xx = n // 2 + radii[:, None] * np.cos(theta)[None, :]
    return yy[::stride].astype(np.float32), xx[::stride].astype(np.float32)


def sample_bilinear(imgs: torch.Tensor, yy: np.ndarray, xx: np.ndarray,
                    wrap: bool) -> torch.Tensor:
    """imgs (B, H, W) at the points (yy, xx) of any shape S -> (B, *S);
    periodic indices with wrap, else clipped to the frame."""
    B, H, W = imgs.shape
    y0, x0 = np.floor(yy).astype(np.int64), np.floor(xx).astype(np.int64)
    fy, fx = (yy - y0).astype(np.float32), (xx - x0).astype(np.float32)
    flat = imgs.reshape(B, -1)
    out = 0
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        w = (fy if dy else 1 - fy) * (fx if dx else 1 - fx)
        yi, xi = y0 + dy, x0 + dx
        if wrap:
            yi, xi = yi % H, xi % W
        else:
            yi, xi = np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)
        idx = torch.as_tensor((yi * W + xi).reshape(-1), device=imgs.device)
        term = flat[:, idx].reshape(B, *yy.shape)
        out = out + term * torch.as_tensor(w, device=imgs.device)
    return out


def trial_shifts(max_shift: int) -> np.ndarray:
    """(T, 2) trial translations (x, y): the grid of step max_shift/2 (at
    least 1) within a disc of radius max_shift."""
    step = max(max_shift / 2.0, 1.0)
    v = np.arange(-max_shift, max_shift + 1e-6, step, dtype=np.float32)
    tx, ty = np.meshgrid(v, v)
    pts = np.stack([tx.ravel(), ty.ravel()], axis=1)
    return pts[np.linalg.norm(pts, axis=1) <= max_shift + 1e-6]


def ring_weights(nr: int, rmin: int, dev) -> torch.Tensor:
    r = torch.arange(rmin, rmin + nr, dtype=torch.float32, device=dev)
    return r / r.sum()


def parabola(ym1, y0, yp1):
    """Vertex of the parabola through (-1, ym1), (0, y0), (1, yp1), within
    [-1/2, 1/2]."""
    den = ym1 - 2.0 * y0 + yp1
    off = torch.where(den.abs() > 1e-12, 0.5 * (ym1 - yp1) / den, 0.0)
    return off.clamp(-0.5, 0.5)


def curve_peak(curve: torch.Tensor, scale):
    """(angle in degrees within (-180, 180], peak value) of the angular
    curves (..., A), the values multiplied by `scale`."""
    A = curve.shape[-1]
    idx = curve.argmax(dim=-1, keepdim=True)
    g = lambda o: curve.gather(-1, (idx + o) % A)[..., 0] * scale
    y0 = g(0)
    off = parabola(g(-1), y0, g(1))
    ang = (idx[..., 0].to(torch.float32) + off) * (360.0 / A)
    return torch.where(ang > 180.0, ang - 360.0, ang), y0


# ---------------------------------------------------------------------- scan

def scan(refs: torch.Tensor, imgs: torch.Tensor, max_shift: int, prec: str):
    """The matching scan. Returns a dict of per-image winners (peak, psi,
    ref, trial, flip) and, per (image, reference, mirror), the two best
    (score, trial, psi) over the trials: `top` (B, R, 2, 2, 3)."""
    n = imgs.shape[-1]
    rmax = n // 2 - 2
    yy, xx = polar_grid(n, 2, rmax, 2 * HARMONICS, 2)
    trials = trial_shifts(max_shift)
    K = HARMONICS
    A = 2 * (K - 1)
    dev = imgs.device
    B, R = imgs.shape[0], refs.shape[0]

    def spectra(pol):
        re, im = dft.rfft(pol, K, prec)
        re, im = re.clone(), im.clone()
        re[..., 0] = 0
        im[..., 0] = 0
        return re, im

    fr_r, fr_i = spectra(sample_bilinear(refs, yy, xx, False))
    nr = fr_r.shape[1]
    w = ring_weights(nr, 2, dev)
    dup = torch.full((K,), 2.0, device=dev)
    dup[0] = 1.0
    dup[-1] = 1.0
    e_ref = ((fr_r ** 2 + fr_i ** 2) * w[:, None] * dup).sum(dim=(1, 2))
    # per harmonic: (K, nr, R) operands of the ring contraction
    c, d = fr_r.permute(2, 1, 0), fr_i.permute(2, 1, 0)
    top = torch.full((B, R, 2, 2, 3), -torch.inf, device=dev)
    top[..., 1:] = 0
    best = dict(peak=torch.full((B,), -torch.inf, device=dev),
                psi=torch.zeros(B, device=dev),
                ref=torch.zeros(B, dtype=torch.int64, device=dev),
                trial=torch.zeros(B, dtype=torch.int64, device=dev),
                flip=torch.zeros(B, dtype=torch.bool, device=dev))
    for ti, (tx, ty) in enumerate(trials):
        fi_r, fi_i = spectra(sample_bilinear(imgs, yy - ty, xx - tx, True))
        e_img = ((fi_r ** 2 + fi_i ** 2) * w[:, None] * dup).sum(dim=(1, 2))
        norm = torch.sqrt((e_img[:, None] * e_ref[None, :]).clamp(min=1e-20))
        a = (fi_r * w[:, None]).permute(2, 0, 1)         # (K, B, nr)
        b = (fi_i * w[:, None]).permute(2, 0, 1)
        ac, bd = dft.mm(a, c, prec), dft.mm(b, d, prec)  # (K, B, R)
        bc, ad = dft.mm(b, c, prec), dft.mm(a, d, prec)
        specs = ((ac + bd, bc - ad), (ac - bd, -(bc + ad)))
        for f, (sr, si) in enumerate(specs):
            curve = dft.irfft(sr.permute(1, 2, 0), si.permute(1, 2, 0), A,
                              prec) * A                   # (B, R, A)
            psi, peak = curve_peak(curve, 1.0 / norm)
            del curve
            # keep the two best trials of every (image, reference, mirror)
            cur = top[:, :, f]                       # a view
            new = torch.stack([peak, torch.full_like(peak, ti), psi], -1)
            first = peak > cur[..., 0, 0]
            second = ~first & (peak > cur[..., 1, 0])
            cur[..., 1, :] = torch.where(first[..., None], cur[..., 0, :],
                                         torch.where(second[..., None], new,
                                                     cur[..., 1, :]))
            cur[..., 0, :] = torch.where(first[..., None], new,
                                         cur[..., 0, :])
    score = top[..., 0, 0]                          # (B, R, 2)
    flat = score.reshape(B, -1)
    peak, where = flat.max(dim=1)
    ref, flip = where // 2, (where % 2).to(torch.bool)
    win = top[torch.arange(B, device=dev), ref, flip.long(), 0]
    best.update(peak=peak, ref=ref, flip=flip, trial=win[:, 1].long(),
                psi=win[:, 2])
    return best, top, trials


def starts(refs, imgs, ref_idx, flip, max_shift: int, tie: float,
           count: int = 3):
    """The coarse starts of the refinement that tie for the scan's best of
    each image's reference and mirror: every local peak of the angular
    curves, over all trials, within `tie` of the best (at most `count`,
    best first). Returns (valid (B, count), trial (B, count), psi (B,
    count))."""
    n = imgs.shape[-1]
    yy, xx = polar_grid(n, 2, n // 2 - 2, 2 * HARMONICS, 2)
    trials = trial_shifts(max_shift)
    K, A = HARMONICS, 2 * (HARMONICS - 1)
    dev = imgs.device

    def spectra(pol):
        re, im = dft.rfft(pol, K, "fp32")
        re, im = re.clone(), im.clone()
        re[..., 0] = 0
        im[..., 0] = 0
        return re, im

    cr, ci = spectra(sample_bilinear(refs[ref_idx], yy, xx, False))
    w = ring_weights(cr.shape[1], 2, dev)[None, :, None]
    dup = torch.full((K,), 2.0, device=dev)
    dup[0] = dup[-1] = 1.0
    e_ref = ((cr ** 2 + ci ** 2) * w * dup).sum(dim=(1, 2))
    sg = torch.where(flip, -1.0, 1.0)[:, None, None]
    curves = []
    for tx, ty in trials:
        fr, fi = spectra(sample_bilinear(imgs, yy - ty, xx - tx, True))
        fi = fi * sg                      # the mirror: conjugate rings
        e_img = ((fr ** 2 + fi ** 2) * w * dup).sum(dim=(1, 2))
        xr = ((fr * cr + fi * ci) * w).sum(1)
        xi = ((fi * cr - fr * ci) * w).sum(1)
        norm = torch.sqrt((e_img * e_ref).clamp(min=1e-20))
        curves.append(dft.irfft(xr, xi, A, "fp32") * A / norm[:, None])
    c = torch.stack(curves, 1)                               # (B, T, A)
    left, right = c.roll(1, -1), c.roll(-1, -1)
    peak = (c > left) & (c >= right)
    best = c.amax(dim=(1, 2), keepdim=True)
    val = torch.where(peak & (c >= best - tie), c, -torch.inf)
    top, at = val.reshape(len(c), -1).topk(count, dim=1)
    t, j = at // A, at % A
    g = lambda o: c.reshape(len(c), -1).gather(1, t * A + (j + o) % A)
    ang = (j.to(torch.float32) + parabola(g(-1), g(0), g(1))) * (360.0 / A)
    ang = torch.where(ang > 180.0, ang - 360.0, ang)
    return torch.isfinite(top), t, ang


# ---------------------------------------------------------------- transforms

def centered_flip_y(imgs):
    """Mirror in y about the centre n//2 (row i -> (n - i) mod n)."""
    out = imgs.flip(1)
    return torch.roll(out, 1, 1) if imgs.shape[1] % 2 == 0 else out


def shear(imgs, shifts, dim: int, prec: str):
    """Translate every line along `dim` (2: rows along x, 1: columns along
    y) of (B, H, W) by its own amount, periodically, as a Fourier phase;
    the Nyquist bin's imaginary part is dropped."""
    x = imgs if dim == 2 else imgs.transpose(1, 2)
    n = x.shape[-1]
    k = n // 2 + 1
    re, im = dft.rfft(x, k, prec)
    f = torch.arange(k, device=imgs.device, dtype=torch.float32) / n
    ang = (-2 * math.pi) * f[None, None, :] * shifts[:, :, None]
    c, s = torch.cos(ang), torch.sin(ang)
    re, im = re * c - im * s, re * s + im * c
    out = dft.irfft(re, im, n, prec)
    return out if dim == 2 else out.transpose(1, 2)


def rotate_shift(imgs, psi_deg, sx, sy, prec: str):
    """Rotate by psi (the alignment convention) then shift by (sx, sy):
    an exact quarter turn, then three shears for the rest of the angle,
    the x shift folded into the third and the y shift a fourth."""
    B, H, W = imgs.shape
    dev = imgs.device
    psi = torch.deg2rad(torch.remainder(psi_deg + 180.0, 360.0) - 180.0)
    quarter = torch.round(psi / (math.pi / 2))
    k = torch.remainder(quarter.to(torch.int32), 4)
    resid = psi - quarter * (math.pi / 2)
    ry, rx = (1 if H % 2 == 0 else 0), (1 if W % 2 == 0 else 0)
    sw = imgs.transpose(1, 2)
    r1 = torch.roll(sw.flip(1), ry, 1)
    r2 = torch.roll(imgs.flip((1, 2)), (ry, rx), (1, 2))
    r3 = torch.roll(sw.flip(2), rx, 2)
    sel = k[:, None, None]
    base = torch.where(sel == 0, imgs, torch.where(
        sel == 1, r1, torch.where(sel == 2, r2, r3)))
    t = torch.tan(resid / 2)
    m = -torch.sin(resid)
    y = (torch.arange(H, dtype=torch.float32, device=dev) - H // 2)[None]
    x = (torch.arange(W, dtype=torch.float32, device=dev) - W // 2)[None]
    out = shear(base, t[:, None] * y, 2, prec)
    out = shear(out, m[:, None] * x, 1, prec)
    out = shear(out, t[:, None] * y + sx[:, None], 2, prec)
    return shear(out, sy[:, None].expand(B, W), 1, prec)


def translate(imgs, sx, sy, prec: str):
    B, H, W = imgs.shape
    out = shear(imgs, sx[:, None].expand(B, H), 2, prec)
    return shear(out, sy[:, None].expand(B, W), 1, prec)


def _window_tables(H: int, W: int, ms: int, dev):
    offs = np.arange(-(ms + 1), ms + 2, dtype=np.float64)

    def tab(n, k, rfft_axis):
        if rfft_axis:
            fr = np.arange(k) / n
            dup = np.full(k, 2.0)
            dup[0] = 1.0
            if n % 2 == 0:
                dup[-1] = 1.0
        else:
            fr, dup = np.fft.fftfreq(n), np.ones(k)
        ang = 2 * np.pi * fr[:, None] * offs[None, :]
        return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in
                (np.cos(ang) * dup[:, None], np.sin(ang) * dup[:, None])]
    inner = torch.as_tensor((np.abs(offs)[:, None] <= ms)
                            & (np.abs(offs)[None, :] <= ms), device=dev)
    return (*tab(W, W // 2 + 1, True), *tab(H, H, False), inner)


def shift_to(F_ref, F_img, H: int, W: int, ms: int, prec: str):
    """(dx, dy) that register the images onto the references: the peak of
    their cross-correlation within ±ms, evaluated by a windowed inverse
    DFT, parabolic in x and y."""
    (rr, ri), (ir, ii) = F_ref, F_img
    xr = ir * rr + ii * ri          # F_img * conj(F_ref)
    xi = ii * rr - ir * ri
    Cx, Sx, Cy, Sy, inner = _window_tables(H, W, ms, xr.device)
    D = 2 * ms + 3
    tr = dft.mm(xr, Cx, prec) - dft.mm(xi, Sx, prec)        # (B, H, D)
    ti = dft.mm(xr, Sx, prec) + dft.mm(xi, Cx, prec)
    corr = (dft.mm(Cy.T, tr, prec) - dft.mm(Sy.T, ti, prec)) / (H * W)
    masked = torch.where(inner[None], corr, -torch.inf)
    flat = masked.reshape(len(corr), -1).argmax(dim=1)
    py, px = flat // D, flat % D
    at = lambda dy, dx: corr.reshape(len(corr), -1).gather(
        1, ((py + dy) * D + px + dx)[:, None])[:, 0]
    offx = parabola(at(0, -1), at(0, 0), at(0, 1))
    offy = parabola(at(-1, 0), at(0, 0), at(1, 0))
    sx = px.to(torch.float32) + offx - (ms + 1)
    sy = py.to(torch.float32) + offy - (ms + 1)
    return -sx, -sy


def ncc(a, b):
    am = a - a.mean(dim=(-2, -1), keepdim=True)
    bm = b - b.mean(dim=(-2, -1), keepdim=True)
    num = (am * bm).sum(dim=(-2, -1))
    den = torch.sqrt((am * am).sum(dim=(-2, -1)) * (bm * bm).sum(dim=(-2, -1)))
    return num / den.clamp(min=1e-12)


def refine(refs, imgs, ref_idx, psi0, t, flip, max_shift: int, prec: str,
           iters: int = 2):
    """The winner's refinement from (reference, coarse psi, trial shift t
    (B, 2), mirror); returns (psi, sx, sy, corr) in xmipp's metadata pose
    convention."""
    B, H, W = imgs.shape
    rmax = H // 2 - 2
    chosen = refs[ref_idx]
    work = torch.where(flip[:, None, None], centered_flip_y(imgs), imgs)
    tx, ty = t[:, 0], torch.where(flip, -t[:, 1], t[:, 1])
    rad = torch.deg2rad(psi0)
    c, s = torch.cos(rad), torch.sin(rad)
    sx, sy = c * tx + s * ty, -s * tx + c * ty
    psi = psi0
    yy, xx = polar_grid(H, 2, rmax, None, 2)
    n_ang = yy.shape[1]
    k = n_ang // 2 + 1
    fc_r, fc_i = dft.rfft(sample_bilinear(chosen, yy, xx, False), k, prec)
    rw = ring_weights(fc_r.shape[1], 2, imgs.device)[None, :, None]
    F_ref = dft.rfft2(chosen, prec)
    for _ in range(iters):
        al = rotate_shift(work, psi, sx, sy, prec)
        dsx, dsy = shift_to(F_ref, dft.rfft2(al, prec), H, W, max_shift, prec)
        fa_r, fa_i = dft.rfft(sample_bilinear(al, yy, xx, False), k, prec)
        cr = ((fa_r * fc_r + fa_i * fc_i) * rw).sum(dim=1)
        ci = ((fa_i * fc_r - fa_r * fc_i) * rw).sum(dim=1)
        dpsi, _ = curve_peak(dft.irfft(cr, ci, n_ang, prec), 1.0)
        rad = torch.deg2rad(dpsi)
        c, s = torch.cos(rad), torch.sin(rad)
        psi = psi + dpsi
        sx, sy = c * sx + s * sy + dsx, -s * sx + c * sy + dsy
    al = rotate_shift(work, psi, sx, sy, prec)
    dsx, dsy = shift_to(F_ref, dft.rfft2(al, prec), H, W, max_shift, prec)
    sx, sy = sx + dsx, sy + dsy
    corr = ncc(chosen, translate(al, dsx, dsy, prec))
    # to the metadata convention: the mirror candidates are y-flips, the
    # metadata's flip an x-mirror (psi + 180)
    psi_x = torch.where(flip, psi + 180.0, psi)
    psi_md = torch.where(flip, psi_x, -psi_x)
    sxe = torch.where(flip, -sx, sx)
    a = torch.deg2rad(psi_md)
    ca, sa = torch.cos(a), torch.sin(a)
    sx_md, sy_md = ca * sxe + sa * sy, -sa * sxe + ca * sy
    psi_md = torch.remainder(psi_md + 180.0, 360.0) - 180.0
    return psi_md, sx_md, sy_md, corr


def match(refs, imgs, max_shift: int, prec: str) -> dict:
    """Scan and refinement: the reference put in the program's place."""
    best, _, trials = scan(refs, imgs, max_shift, prec)
    t = torch.as_tensor(trials, device=imgs.device)[best["trial"]]
    psi, sx, sy, corr = refine(refs, imgs, best["ref"], best["psi"], t,
                               best["flip"], max_shift, prec)
    return dict(ref_idx=best["ref"], flip=best["flip"], peak=best["peak"],
                psi=psi, sx=sx, sy=sy, corr=corr)
