"""Normal Mode Analysis: elastic-network modes + mode-based deformation.

Counterpart of the reference package's models/nma.py (the reference
suite's nma_alignment.{h,cpp}, nma_alignment_vol and pdb_nma_deform,
which consume externally computed mode files and fit amplitudes with the
CONDOR optimizer). The modes (a Tirion anisotropic elastic network:
cKDTree and eigh), the mode files and the per-atom interpolation of the
displacement fields stay on the host, as in the reference. On the card:
the backward warp by a dense field and the amplitude fit, by Adam
(ops.optim.adam_scan) or by COBYQA driving an objective on the card
(ops.optim.trust_region_dfo, the CONDOR role).

Mode file format: text, one row per atom with 3 columns (x y z
displacement), one file per mode, listed by a metadata's nmaModefile
column, as the reference's `.mod` usage.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor, fp32_products


def elastic_network_modes(coords: np.ndarray, n_modes: int = 6,
                          cutoff: float | None = None):
    """Tirion ENM normal modes of a point model (host numpy).

    coords (N,3); returns (n_modes, N, 3) modes normalised to unit max
    displacement (lowest nonrigid frequencies first) and their
    eigenvalues."""
    coords = np.asarray(coords, np.float64)
    N = len(coords)
    if cutoff is None:
        # typical: ~1.5x the mean nearest-neighbor distance x 2
        from scipy.spatial import cKDTree
        d, _ = cKDTree(coords).query(coords, k=2)
        cutoff = 3.0 * np.median(d[:, 1])
    H = np.zeros((3 * N, 3 * N))
    for i in range(N):
        for j in range(i + 1, N):
            dv = coords[j] - coords[i]
            r2 = float(dv @ dv)
            if r2 > cutoff * cutoff or r2 == 0:
                continue
            k = np.outer(dv, dv) / r2
            H[3 * i:3 * i + 3, 3 * j:3 * j + 3] -= k
            H[3 * j:3 * j + 3, 3 * i:3 * i + 3] -= k
            H[3 * i:3 * i + 3, 3 * i:3 * i + 3] += k
            H[3 * j:3 * j + 3, 3 * j:3 * j + 3] += k
    w, v = np.linalg.eigh(H)
    # skip the 6 rigid-body zero modes
    idx = np.argsort(w)[6:6 + n_modes]
    modes = v[:, idx].T.reshape(n_modes, N, 3)
    # normalize to unit max displacement
    norms = np.linalg.norm(modes, axis=2).max(axis=1, keepdims=True)
    modes = modes / np.maximum(norms[:, :, None], 1e-12)
    return modes.astype(np.float32), w[idx].astype(np.float32)


def write_modes(path_root: str, modes: np.ndarray) -> list[str]:
    files = []
    for m in range(len(modes)):
        fn = f"{path_root}_mode{m + 1:03d}.mod"
        np.savetxt(fn, modes[m], fmt="%.6f")
        files.append(fn)
    return files


def read_mode(path: str) -> np.ndarray:
    return np.loadtxt(path).astype(np.float32)


def displacement_field(coords, modes, amplitudes, size: int,
                       sampling: float = 1.0, sigma: float = 3.0):
    """Dense (3, D, D, D) displacement field from per-atom mode
    displacements (gaussian-kernel scattered-data interpolation,
    normalized; host numpy, as in the reference)."""
    coords = np.asarray(coords, np.float64) / sampling + size // 2
    disp = np.einsum("m,mnk->nk", np.asarray(amplitudes, np.float64),
                     np.asarray(modes, np.float64)) / sampling
    field = np.zeros((3, size, size, size), np.float32)
    weight = np.zeros((size, size, size), np.float32)
    r = max(int(2 * sigma), 1)
    offs = np.arange(-r, r + 1)
    dz, dy, dx = np.meshgrid(offs, offs, offs, indexing="ij")
    kern0 = np.exp(-(dz ** 2 + dy ** 2 + dx ** 2) / (2 * sigma ** 2))
    for n in range(len(coords)):
        x, y, z = coords[n]
        iz, iy, ix = int(round(z)), int(round(y)), int(round(x))
        if not (r <= ix < size - r and r <= iy < size - r and
                r <= iz < size - r):
            continue
        for c in range(3):
            field[c, iz - r:iz + r + 1, iy - r:iy + r + 1,
                  ix - r:ix + r + 1] += disp[n, c] * kern0
        weight[iz - r:iz + r + 1, iy - r:iy + r + 1,
               ix - r:ix + r + 1] += kern0
    w = np.maximum(weight, 1e-6)
    return field / w[None]


def unit_fields(coords, modes, size: int, sampling: float = 1.0):
    """The (M, 3, D, D, D) field of each mode at unit amplitude (host
    numpy): the field is linear in the amplitudes."""
    return np.stack([displacement_field(coords, modes[m:m + 1], [1.0], size,
                                        sampling) for m in range(len(modes))])


def warp_volume_field(vol, field, device=None):
    """Backward warp of a volume by a dense (..., 3, D, D, D)
    displacement field (x, y, z components), trilinear with clamped
    indices and weights from floor; differentiable in the field. Returns
    (..., D, D, D) on vol's device (or `device`)."""
    from xmipp3_tpu_torch.ops.zernike import warp_trilinear
    vol = as_tensor(vol, device)
    return warp_trilinear(vol, as_tensor(field, vol.device))


def mode_field(amp, uf):
    """sum_m amp[..., m] uf[m]: the (..., 3, D, D, D) field, in full
    float32."""
    M = uf.shape[0]
    with fp32_products():
        f = amp @ uf.reshape(M, -1)
    return f.reshape(amp.shape[:-1] + uf.shape[1:])


def fit_mode_amplitudes(vol_ref, vol_target, coords, modes, sampling=1.0,
                        n_steps: int = 60, lr: float = 0.5, verbose: int = 0,
                        optimizer: str = "adam", device=None):
    """Fit NMA amplitudes deforming vol_ref onto vol_target.

    Differentiable chain: amplitudes -> per-mode dense fields (precomputed
    per unit amplitude, linear) -> warp -> NCC. Returns (amplitudes
    (numpy), ncc).

    optimizer: 'adam' (n_steps of Adam on the card, ops.optim.adam_scan)
    or 'trust' (COBYQA on the host driving the objective on the card,
    ops.optim.trust_region_dfo: the CONDOR role of the reference suite's
    nma_alignment.h:40; derivative-free)."""
    from xmipp3_tpu_torch.ops.optim import adam_scan, trust_region_dfo
    vr = as_tensor(vol_ref, device)
    dev = vr.device
    D = vr.shape[0]
    M = len(modes)
    uf = torch.as_tensor(unit_fields(coords, modes, D, sampling), device=dev)
    vt = as_tensor(vol_target, dev)
    bm = vt - vt.mean()

    def loss(amp):
        warped = warp_volume_field(vr, mode_field(amp, uf))
        am = warped - warped.mean()
        return -(am * bm).sum() / torch.sqrt(
            (am ** 2).sum() * (bm ** 2).sum()).clamp(min=1e-12)

    if optimizer == "trust":
        amp, best = trust_region_dfo(
            lambda a: loss(torch.as_tensor(a, device=dev)),
            np.zeros(M, np.float32), max_nfev=max(8 * n_steps, 120),
            rhobeg=2.0 * lr)
        if verbose:
            print(f"  nma refine (trust-region DFO): NCC {-best:.4f}")
        return np.asarray(amp), -best
    amp, last = adam_scan(loss, torch.zeros(M, device=dev), n_steps, lr)
    if verbose:
        print(f"  nma refine ({n_steps} steps): NCC {-float(last):.4f}")
    return amp.cpu().numpy(), -float(loss(amp))
