"""Normalization modes (OldXmipp/NewXmipp/Ramp/Robust/...).

Counterpart of the reference package's ops/normalize.py (reference
ProgNormalize modes, data/normalize.h:201): the batched modes run on the
images' device; Robust, Neighbour, dust removal and Tomography run on the
host in numpy/scipy, where the reference runs them. Background = pixels
outside a circular mask (or an explicit mask).
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor
from xmipp3_tpu_torch.ops.mask import background_mask


def _batch(imgs, device):
    """imgs as a float32 (B,H,W) tensor and whether it was one image."""
    imgs = as_tensor(imgs, device)
    single = imgs.ndim == 2
    return (imgs[None] if single else imgs), single


def _median(x, dim: int):
    """The median along `dim`, the mean of the two middle values for an
    even count (numpy's and jax's convention; torch.median takes the
    lower one)."""
    n = x.shape[dim]
    s = x.sort(dim=dim).values
    lo = s.narrow(dim, (n - 1) // 2, 1)
    hi = s.narrow(dim, n // 2, 1)
    return ((lo + hi) / 2).squeeze(dim)


def _bg_stats(imgs, bg):
    w = bg[None]
    n = bg.sum()
    mean = (imgs * w).sum(dim=(-2, -1)) / n
    var = ((imgs - mean[:, None, None]) ** 2 * w).sum(dim=(-2, -1)) / n
    return mean, torch.sqrt(var.clamp(min=1e-12))


def normalize_old_xmipp(imgs, device=None):
    """(I - mean) / std over the whole image."""
    imgs, single = _batch(imgs, device)
    m = imgs.mean(dim=(-2, -1), keepdim=True)
    s = imgs.std(dim=(-2, -1), keepdim=True, correction=0)
    out = (imgs - m) / s.clamp(min=1e-12)
    return out[0] if single else out


def normalize_new_xmipp(imgs, bg_mask, device=None):
    """(I - bg_mean) / bg_std : signal in units of background noise sigma."""
    imgs, single = _batch(imgs, device)
    mean, std = _bg_stats(imgs, as_tensor(bg_mask, imgs.device))
    out = (imgs - mean[:, None, None]) / std[:, None, None]
    return out[0] if single else out


def _plane_basis(H, W, device, order):
    """(3,H,W) basis of a plane over logical (centered) coordinates, in the
    order given ('1xy' or 'xy1')."""
    y = torch.arange(H, dtype=torch.float32, device=device)[:, None] - H // 2
    x = torch.arange(W, dtype=torch.float32, device=device)[None, :] - W // 2
    ones = torch.ones((H, W), device=device)
    terms = {"1": ones, "x": x * ones, "y": y * ones}
    return torch.stack([terms[c] for c in order], dim=0)


def _plane_coefs(imgs, w, basis):
    """Least-squares coefficients (B,3) of the basis over weights w."""
    G = torch.einsum("ahw,bhw,hw->ab", basis, basis, w)
    rhs = torch.einsum("ahw,nhw,hw->na", basis, imgs, w)
    return torch.linalg.solve(G[None].expand(imgs.shape[0], 3, 3),
                              rhs[:, :, None])[:, :, 0]


def subtract_background_plane(imgs, bg_mask, device=None):
    """LS-fit a plane a+bx+cy on background pixels, subtract everywhere
    (reference Ramp / NewXmipp preprocessing)."""
    imgs, single = _batch(imgs, device)
    B, H, W = imgs.shape
    basis = _plane_basis(H, W, imgs.device, "1xy")
    coef = _plane_coefs(imgs, as_tensor(bg_mask, imgs.device), basis)
    out = imgs - torch.einsum("na,ahw->nhw", coef, basis)
    return out[0] if single else out


def least_squares_plane_fit(imgs, mask=None, device=None):
    """LS plane coefficients (a, b, c) with plane = a·x + b·y + c over
    logical (centered) coords; fit over `mask` points, or ALL points when
    mask is None (reference least_squares_plane_fit_All_Points). Returns
    (B, 3) [a, b, c]."""
    imgs, _ = _batch(imgs, device)
    B, H, W = imgs.shape
    w = (torch.ones((H, W), device=imgs.device) if mask is None
         else as_tensor(mask, imgs.device))
    return _plane_coefs(imgs, w, _plane_basis(H, W, imgs.device, "xy1"))


def normalize_ramp(imgs, bg_mask=None, device=None):
    """Reference Ramp mode: subtract the LS background plane — no rescaling
    (data/normalize.cpp:333-372; plane over ALL points when no mask)."""
    imgs, single = _batch(imgs, device)
    H, W = imgs.shape[-2:]
    coef = least_squares_plane_fit(imgs, bg_mask)
    y = torch.arange(H, dtype=torch.float32, device=imgs.device)[:, None] \
        - H // 2
    x = torch.arange(W, dtype=torch.float32, device=imgs.device)[None, :] \
        - W // 2
    plane = (coef[:, 0, None, None] * x[None] + coef[:, 1, None, None] * y[None]
             + coef[:, 2, None, None])
    out = imgs - plane
    return out[0] if single else out


def normalize_robust(imgs, device=None):
    """(I - median) / MAD-sigma (reference Robust mode)."""
    imgs, single = _batch(imgs, device)
    flat = imgs.reshape(imgs.shape[0], -1)
    med = _median(flat, 1)
    mad = _median((flat - med[:, None]).abs(), 1)
    sigma = 1.4826 * mad.clamp(min=1e-12)
    out = (imgs - med[:, None, None]) / sigma[:, None, None]
    return out[0] if single else out


def normalize_near_old_xmipp(imgs, bg_mask, device=None):
    """(I - mean(I)) / std(bg) (reference Near_OldXmipp)."""
    imgs, single = _batch(imgs, device)
    _, std = _bg_stats(imgs, as_tensor(bg_mask, imgs.device))
    m = imgs.mean(dim=(-2, -1))
    out = (imgs - m[:, None, None]) / std[:, None, None]
    return out[0] if single else out


def normalize_new_xmipp2(imgs, bg_mask, device=None):
    """(I - m(bg)) / (m(I) - m(bg)) (reference NewXmipp2)."""
    imgs, single = _batch(imgs, device)
    mbg, _ = _bg_stats(imgs, as_tensor(bg_mask, imgs.device))
    m = imgs.mean(dim=(-2, -1))
    den = torch.where((m - mbg).abs() < 1e-12, 1.0, m - mbg)
    out = (imgs - mbg[:, None, None]) / den[:, None, None]
    return out[0] if single else out


def normalize_michael(imgs, bg_mask, device=None):
    """(I - m(bg)) / |m(bg)| (reference Michael)."""
    imgs, single = _batch(imgs, device)
    mean, _ = _bg_stats(imgs, as_tensor(bg_mask, imgs.device))
    out = (imgs - mean[:, None, None]) / mean.abs().clamp(
        min=1e-12)[:, None, None]
    return out[0] if single else out


def normalize_robust_reference(imgs, bg_mask, clip: bool = False):
    """Reference Robust mode (normalize.cpp normalize_Robust), host numpy:
    I = (I - median(background)) / p99(foreground); optional clip to
    +-1.3284. bg_mask nonzero marks BACKGROUND pixels."""
    imgs = np.asarray(imgs, np.float32)
    single = imgs.ndim == 2
    if single:
        imgs = imgs[None]
    bg = np.asarray(bg_mask) > 0.5
    out = np.empty_like(imgs)
    for k, img in enumerate(imgs):
        med_bg = np.median(img[bg]) if bg.any() else np.median(img)
        fg = img[~bg]
        if fg.size == 0:
            fg = img.ravel()
        p99 = np.sort(fg)[int(fg.size * 0.99)]
        out[k] = (img - med_bg) / (p99 if p99 != 0 else 1.0)
    if clip:
        np.clip(out, -1.3284, 1.3284, out=out)
    return out[0] if single else out


def remove_dust(imgs, thr_black=None, thr_white=None, rng=None):
    """Replace z-score outlier pixels with gaussian noise (reference
    ProgNormalize dust removal, normalize.cpp:884-913), host numpy: the
    noise is drawn from `rng` (a numpy Generator) image by image."""
    imgs = np.array(imgs, np.float32, copy=True)
    rng = np.random.default_rng() if rng is None else rng
    single = imgs.ndim == 2
    if single:
        imgs = imgs[None]
    for img in imgs:
        avg, std = float(img.mean()), float(img.std())
        if std == 0:
            continue
        z = (img - avg) / std
        sel = np.zeros(img.shape, bool)
        if thr_black is not None and (img.min() - avg) / std < thr_black:
            sel |= z < thr_black
        if thr_white is not None and (img.max() - avg) / std > thr_white:
            sel |= z > thr_white
        img[sel] = rng.normal(avg, std, int(sel.sum()))
    return imgs[0] if single else imgs


def normalize_remove_neighbours(imgs, bg_mask, threshold=1.2, rng=None):
    """Reference Neighbour mode (normalize_remove_neighbours), host numpy:
    fit + remove the background plane, re-estimate the clean background
    sigma, replace outlier background pixels with gaussian noise drawn from
    `rng`, divide by the sigma."""
    imgs = np.asarray(imgs, np.float32)
    rng = np.random.default_rng() if rng is None else rng
    single = imgs.ndim == 2
    if single:
        imgs = imgs[None]
    bg = np.asarray(bg_mask) > 0.5
    H, W = imgs.shape[-2:]
    yy = (np.arange(H) - H // 2)[:, None] * np.ones((1, W))
    xx = np.ones((H, 1)) * (np.arange(W) - W // 2)[None, :]
    out = np.empty_like(imgs)
    for k, img in enumerate(imgs):
        avgbg = img[bg].mean()
        stdbg = img[bg].std()
        good = bg & (np.abs(img - avgbg) < threshold * stdbg)
        A = np.stack([xx[good], yy[good], np.ones(int(good.sum()))], axis=1)
        coef, *_ = np.linalg.lstsq(A, img[good], rcond=None)
        plane = coef[0] * xx + coef[1] * yy + coef[2]
        im = img - plane
        good2 = bg & (np.abs(im) < threshold * stdbg)
        ns = im[good2].std(ddof=1)
        outlier = bg & (np.abs(im) > threshold * stdbg)
        im = im.copy()
        # reference quirk kept: the noise mean is the (already removed)
        # plane value at the pixel (normalize.cpp:884)
        im[outlier] = rng.normal(plane[outlier], ns)
        out[k] = im / ns
    return out[0] if single else out


def normalize_tomography(img, tilt, tilt_mask: bool = False,
                         tomography0: bool = False,
                         mu0: float = 0.0, sigma0: float = 1.0):
    """Reference Tomography/Tomography0 normalization
    (normalize.cpp normalize_tomography), host numpy/scipy: stats over the
    cos(tilt)-wide x-band, refined by a 5x5 local-variance F-test that
    drops particle-like regions; I=(I-mean)/(std*cos(tilt)) — Tomography0
    uses the 0-degree image's (mu0, sigma0). Returns (out, mu_i, sigma_i)."""
    from scipy.ndimage import uniform_filter
    from scipy.stats import f as fdist
    img = np.asarray(img, np.float64)
    H, W = img.shape
    L = 2
    ct = np.cos(np.deg2rad(tilt))
    xdim_tilt = int(min(np.floor(0.5 * W * ct), 0.5 * (W - (2 * L + 1))))
    xs = np.arange(W) - W // 2
    band = (np.abs(xs) <= xdim_tilt)[None, :] & np.ones((H, 1), bool)
    N = int(band.sum())
    # 5x5 local variance with edge-correct counts
    k = 2 * L + 1
    ones = np.ones_like(img)
    cnt = uniform_filter(ones, size=k, mode="constant") * k * k
    s1 = uniform_filter(img, size=k, mode="constant") * k * k
    s2 = uniform_filter(img * img, size=k, mode="constant") * k * k
    mean = s1 / cnt
    local_var = s2 / (cnt - 1) - cnt / (cnt - 1) * mean * mean
    mean_var = local_var[band].mean()
    iFu = 1.0 / fdist.ppf(0.975, 4 * L * L + 4 * L, N - 1)
    iFl = 1.0 / fdist.ppf(0.025, 4 * L * L + 4 * L, N - 1)
    ratio = local_var / max(mean_var, 1e-30)
    # mask codes: 1 in-band accepted; -1 in-band variance outlier; 0 out
    # of band; -2 degenerate (zero local variance)
    outlier = band & ((ratio * iFu > 1) | (ratio * iFl < 1))
    accepted = band & ~outlier
    degenerate = local_var == 0
    vals = img[accepted & ~degenerate]
    avg = vals.mean() if vals.size else img.mean()
    std = vals.std() if vals.size else img.std()
    if tomography0:
        scale = 1.0 / (sigma0 * ct)
        out = (img / ct - mu0) * scale
    else:
        out = (img - avg) / (std * ct)
    if tilt_mask:
        out = np.where(band, out, 0.0)
    out = np.where(degenerate, 0.0, out)
    return out.astype(np.float32), float(avg), float(std)


def normalize(imgs, method: str = "NewXmipp", bg_radius: float | None = None,
              clip: bool = False, thr_neigh: float = 1.2, rng=None,
              device=None):
    """CLI-facing dispatch (transform_normalize program). The batched
    methods return a tensor on the images' device (a tensor's own, else
    `device`, the card by default); Robust and Neighbour return numpy."""
    shape = tuple(np.shape(imgs)[-2:])
    method_l = method.lower()
    if method_l == "oldxmipp":
        return normalize_old_xmipp(imgs, device)
    if method_l == "none":
        return as_tensor(imgs, device)
    bg = background_mask(shape, bg_radius)
    if method_l == "newxmipp":
        return normalize_new_xmipp(subtract_background_plane(imgs, bg,
                                                             device), bg)
    if method_l == "newxmipp2":
        return normalize_new_xmipp2(imgs, bg, device)
    if method_l == "near_oldxmipp":
        return normalize_near_old_xmipp(imgs, bg, device)
    if method_l == "ramp":
        return normalize_ramp(imgs, bg, device)
    if method_l == "robust":
        return normalize_robust_reference(_host(imgs), bg, clip=clip)
    if method_l == "neighbour":
        return normalize_remove_neighbours(_host(imgs), bg,
                                           threshold=thr_neigh, rng=rng)
    if method_l == "michael":
        return normalize_michael(imgs, bg, device)
    raise ValueError(f"unknown normalize method {method}")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
