"""Helical symmetry: symmetrization and the (rot, z) parameter search.

Counterpart of the reference package's ops/helical.py (the reference's
symmetry_Helical, data/symmetries.cpp:1632-1705, and the helical branch of
volume_find_symmetry, volume_find_symmetry.cpp:359-420). Each helical
replica l is one rotate+shift resampling of the whole volume by the
reference package's own zero-outside trilinear sampler (`_trilinear`, not
grid_sample, whose border and align_corners rules differ), and the
(rot, z) grid is scored in chunks of candidates, each chunk one batched
resampling of about CHUNK_BYTES. As in the reference package, the
out-of-z corner taps that the reference recovers from the adjacent
replica (symmetries.cpp:1577-1596) read zero.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor

__all__ = ["symmetrize_helical", "helical_correlation_grid",
           "helical_correlation"]

# bytes of one chunk's working set in helical_correlation_grid
CHUNK_BYTES = 1 << 30


def _trilinear(vol, xs, ys, zs):
    """Sample vol (D,H,W) at float coordinates (array index space, any
    broadcastable shapes), zero outside."""
    D, H, W = vol.shape
    flat = vol.reshape(-1)
    x0, y0, z0 = (torch.floor(c) for c in (xs, ys, zs))
    fx, fy, fz = xs - x0, ys - y0, zs - z0
    x0, y0, z0 = (c.to(torch.int64) for c in (x0, y0, z0))
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi, zi = x0 + dx, y0 + dy, z0 + dz
                inside = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
                          & (zi >= 0) & (zi < D))
                v = flat[(zi.clamp(0, D - 1) * H + yi.clamp(0, H - 1)) * W
                         + xi.clamp(0, W - 1)]
                wgt = ((fx if dx else 1 - fx) * (fy if dy else 1 - fy)
                       * (fz if dz else 1 - fz))
                out = out + torch.where(inside, v, 0.0) * wgt
    return out


def _symmetrize(vol, z_shift, rot_rad, l_max: int, cn: int, dihedral: bool,
                height_fraction: float):
    """Helically symmetrized copies of vol for K candidates at once:
    z_shift, rot_rad (K,) float32 tensors -> (K, D, H, W)."""
    D, H, W = vol.shape
    dev = vol.device
    cz, cy, cx = D // 2, H // 2, W // 2
    # logical (centered) coordinates, Xmipp origin
    k = (torch.arange(D, dtype=torch.float32, device=dev) - cz)[:, None, None]
    i = (torch.arange(H, dtype=torch.float32, device=dev) - cy)[None, :, None]
    j = (torch.arange(W, dtype=torch.float32, device=dev) - cx)[None, None, :]
    zsh = z_shift[:, None, None, None]
    hz = torch.round(torch.tensor(height_fraction, dtype=torch.float32) * D)
    z_first = -torch.floor(hz / 2)                  # FIRST_XMIPP_INDEX
    z_last = z_first + hz - 1                       # LAST_XMIPP_INDEX
    z_half = torch.floor(0.5 * zsh)
    acc = torch.zeros((len(z_shift), D, H, W), device=dev)
    norm = torch.zeros_like(acc)
    for l in range(-l_max, l_max + 1):
        kp = k + l * zsh                                       # (K,D,1,1)
        in_h = (kp >= z_first) & (kp <= z_last)
        w = torch.where(kp - z_first <= z_half,
                        (kp - z_first + 1) / (z_half + 1),
                        torch.where(z_last - kp <= z_half,
                                    (z_last + 1 - kp) / (z_half + 1), 1.0))
        w = torch.where(in_h, w, 0.0)
        zz = kp.expand(-1, D, H, W) + cz
        for n in range(cn):
            ang = (l * rot_rad + n * (2 * np.pi / cn))[:, None, None, None]
            ca, sa = torch.cos(ang), torch.sin(ang)
            jp = ca * j - sa * i
            ip = sa * j + ca * i
            acc = acc + w * _trilinear(vol, jp + cx, ip + cy, zz)
            norm = norm + w
            if dihedral:
                acc = acc + w * _trilinear(vol, jp + cx, -ip + cy,
                                           (-kp).expand(-1, D, H, W) + cz)
                norm = norm + w
    return torch.where(norm > 0, acc / torch.clamp(norm, min=1e-12), 0.0)


def _l_max(D: int, z_shift: float) -> int:
    return int(np.ceil(D / max(float(z_shift), 0.5))) + 1


def symmetrize_helical(vol, z_shift, rot_deg, cn: int = 1,
                       dihedral: bool = False,
                       height_fraction: float = 1.0,
                       l_max: int | None = None, device=None):
    """Helically symmetrized volume; z_shift in voxels, rot in degrees."""
    vol = as_tensor(vol, device)
    if l_max is None:
        l_max = _l_max(vol.shape[0], z_shift)
    t = lambda v: torch.tensor([v], dtype=torch.float32, device=vol.device)
    return _symmetrize(vol, t(z_shift), t(np.deg2rad(rot_deg)), int(l_max),
                       int(cn), bool(dihedral), float(height_fraction))[0]


def _masked_corr(a, b, mask):
    """Correlation of a (D,H,W) with each of b (K,D,H,W) inside mask."""
    n = torch.clamp(mask.sum(), min=1.0)
    ac = (a - (a * mask).sum() / n) * mask
    bm = (b * mask).sum(dim=(1, 2, 3), keepdim=True) / n
    bc = (b - bm) * mask
    return (ac * bc).sum(dim=(1, 2, 3)) / torch.clamp(
        torch.sqrt((ac * ac).sum() * (bc * bc).sum(dim=(1, 2, 3))),
        min=1e-12)


def _mask(vol, mask):
    return torch.ones_like(vol) if mask is None else as_tensor(mask,
                                                               vol.device)


def helical_correlation(vol, z_shift, rot_deg, cn=1, dihedral=False,
                        height_fraction=1.0, mask=None,
                        l_max: int | None = None, device=None):
    """Correlation (a 0-d tensor) of vol with its helically symmetrized
    copy inside mask."""
    vol = as_tensor(vol, device)
    if l_max is None:
        l_max = _l_max(vol.shape[0], z_shift)
    t = lambda v: torch.tensor([v], dtype=torch.float32, device=vol.device)
    vs = _symmetrize(vol, t(z_shift), t(np.deg2rad(rot_deg)), int(l_max),
                     int(cn), bool(dihedral), float(height_fraction))
    return _masked_corr(vol, vs, _mask(vol, mask))[0]


def helical_correlation_grid(vol, z_values, rot_values_deg, cn=1,
                             dihedral=False, height_fraction=1.0,
                             mask=None, chunk: int | None = None,
                             device=None):
    """Correlation map over the (rot, z) grid — rows are rotations,
    columns z shifts (the reference's output.xmp layout,
    volume_find_symmetry.cpp:294-307) — as a float32 tensor. The
    candidates go in chunks of `chunk` (default: about CHUNK_BYTES of
    working set each)."""
    vol = as_tensor(vol, device)
    mask = _mask(vol, mask)
    z_values = np.asarray(z_values, np.float32)
    rot_values = np.asarray(rot_values_deg, np.float32)
    l_max = _l_max(vol.shape[0], z_values.min())
    zz, rr = np.meshgrid(z_values, rot_values)       # (R, Z)
    zs = torch.as_tensor(zz.ravel(), device=vol.device)
    rs = torch.as_tensor(np.deg2rad(rr.ravel()), dtype=torch.float32,
                         device=vol.device)
    if chunk is None:
        # about 12 float32 volumes live per candidate in _symmetrize
        chunk = max(1, CHUNK_BYTES // (12 * 4 * vol.numel()))
    out = [_masked_corr(vol, _symmetrize(
        vol, zs[c:c + chunk], rs[c:c + chunk], l_max, int(cn),
        bool(dihedral), float(height_fraction)), mask)
        for c in range(0, len(zs), chunk)]
    return torch.cat(out).reshape(len(rot_values), len(z_values))
