"""Zernike3D deformation fields (flexible alignment / heterogeneity).

Counterpart of the reference package's ops/zernike.py (the reference
suite's volume_deform_sph.h:38, angular_sph_alignment.h:42 and
cuda_volume_deform_sph.cu:153 computeDeform).

The basis stays host numpy/scipy, evaluated once on the voxel grid as a
dense (K, D, H, W) array: Z_{l,n,m}(r, theta, phi) = R_{n,l}(r) Y_{l,m}
for r <= 1 (Zernike radial polynomials times real spherical harmonics),
each basis function carrying an (x, y, z) displacement component, so the
coefficients come in triples (3, K) as the reference's sphCoefficients
store 3K values. On the card: the warp (a trilinear backward gather,
differentiable in the coefficients through torch.autograd, batched over
(B, 3, K) coefficient sets for the per-particle fits) and the coefficient
fit (Adam on the sigma-filtered NCC through ops.optim.adam_scan). The 2-D
PolyZernikes functions are host numpy, as in the reference.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor, fp32_products


def zernike_radial(n: int, l: int, r: np.ndarray) -> np.ndarray:
    """R_{n,l}(r): Zernike radial polynomial (n >= l, n-l even)."""
    out = np.zeros_like(r)
    for k in range((n - l) // 2 + 1):
        c = ((-1) ** k * math.factorial(n - k) /
             (math.factorial(k) * math.factorial((n + l) // 2 - k) *
              math.factorial((n - l) // 2 - k)))
        out = out + c * r ** (n - 2 * k)
    return out


def real_sph_harm(l: int, m: int, theta: np.ndarray,
                  phi: np.ndarray) -> np.ndarray:
    """Real spherical harmonics (scipy backend, Condon-Shortley removed).
    Needs SciPy >= 1.15 (sph_harm_y); an older SciPy raises ImportError."""
    from scipy.special import sph_harm_y
    # sph_harm_y(l, m, theta=polar, phi=azimuth)
    if m == 0:
        return np.real(sph_harm_y(l, 0, theta, phi))
    if m > 0:
        return np.sqrt(2) * (-1) ** m * np.real(sph_harm_y(l, m, theta, phi))
    return np.sqrt(2) * (-1) ** m * np.imag(sph_harm_y(l, -m, theta, phi))


def zernike_indices(L1: int, L2: int) -> list[tuple[int, int, int]]:
    """(l, n, m) index list up to radial order L1 and angular order L2
    (the reference's depth parameters)."""
    out = []
    for n in range(L1 + 1):
        for l in range(n % 2, min(n, L2) + 1, 2):
            for m in range(-l, l + 1):
                out.append((l, n, m))
    return out


def zernike_basis_grid(size: int, L1: int = 3, L2: int = 2,
                       radius: float | None = None) -> np.ndarray:
    """Basis array (K, size, size, size) float32 on the centered voxel
    grid, zero outside the unit ball of `radius` voxels (host numpy). The
    last few grids are kept for the process (about 2.5 s of scipy a
    128^3 grid); each call returns its own copy."""
    return _basis_grid(int(size), int(L1), int(L2),
                       None if radius is None else float(radius)).copy()


@lru_cache(maxsize=2)
def _basis_grid(size, L1, L2, radius):
    if radius is None:
        radius = size / 2 - 1
    z, y, x = np.mgrid[0:size, 0:size, 0:size].astype(np.float64)
    z, y, x = ((z - size // 2) / radius, (y - size // 2) / radius,
               (x - size // 2) / radius)
    r = np.sqrt(x * x + y * y + z * z)
    inside = r <= 1.0
    rs = np.where(r > 0, r, 1e-9)
    theta = np.arccos(np.clip(z / rs, -1, 1))
    phi = np.arctan2(y, x)
    idx = zernike_indices(L1, L2)
    basis = np.zeros((len(idx), size, size, size), np.float32)
    for k, (l, n, m) in enumerate(idx):
        B = zernike_radial(n, l, r) * real_sph_harm(l, m, theta, phi)
        basis[k] = np.where(inside, B, 0.0).astype(np.float32)
    return basis


def displacement(basis, coeffs):
    """The (..., 3, D, H, W) displacement field coeffs . basis of
    (..., 3, K) coefficients, in full float32."""
    K = basis.shape[0]
    with fp32_products():
        d = coeffs @ basis.reshape(K, -1)
    return d.reshape(coeffs.shape[:-1] + basis.shape[1:])


def warp_trilinear(vol, field):
    """Backward trilinear warp out(x) = vol(x - d(x)) of a (D,H,W) volume
    by (..., 3, D, H, W) (x, y, z) displacement fields; the gather index
    is clamped to the volume, the weights come from floor, and the result
    is differentiable in the field. Returns (..., D, H, W)."""
    D, H, W = vol.shape
    dev = vol.device
    z = torch.arange(D, dtype=torch.float32, device=dev)[:, None, None]
    y = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    x = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    zi = z - field[..., 2, :, :, :]
    yi = y - field[..., 1, :, :, :]
    xi = x - field[..., 0, :, :, :]
    z0, y0, x0 = (torch.floor(a).to(torch.int64) for a in (zi, yi, xi))
    fz, fy, fx = zi - z0, yi - y0, xi - x0
    flat = vol.reshape(-1)
    out = None
    for dz in range(2):
        wz = fz if dz else 1 - fz
        zj = (z0 + dz).clamp(0, D - 1) * (H * W)
        for dy in range(2):
            wy = fy if dy else 1 - fy
            zyj = zj + (y0 + dy).clamp(0, H - 1) * W
            for dx in range(2):
                wx = fx if dx else 1 - fx
                tap = wz * wy * wx * flat[zyj + (x0 + dx).clamp(0, W - 1)]
                out = tap if out is None else out + tap
    return out


def deform_volume(vol, basis, coeffs, device=None):
    """Warp a volume with the Zernike3D displacement field.

    vol (D,D,D); basis (K,D,D,D); coeffs (3,K) or (B,3,K): x/y/z
    displacement coefficients (voxels). Gather-based backward warp,
    differentiable in coeffs: out(x) = vol(x - d(x)). Returns (D,D,D),
    or (B,D,D,D) for batched coefficients, on vol's device (or
    `device`)."""
    vol = as_tensor(vol, device)
    basis = as_tensor(basis, vol.device)
    coeffs = as_tensor(coeffs, vol.device)
    return warp_trilinear(vol, displacement(basis, coeffs))


def _vol_ncc(a, b):
    am = a - a.mean()
    bm = b - b.mean()
    return (am * bm).sum() / torch.sqrt(
        (am ** 2).sum() * (bm ** 2).sum()).clamp(min=1e-12)


def fit_deformation(vol_ref, vol_target, L1: int = 3, L2: int = 2,
                    n_steps: int = 100, lr: float = 0.05,
                    radius: float | None = None, verbose: int = 0,
                    lam: float = 0.0, sigmas=None, mask=None,
                    coeffs0=None, device=None):
    """Find Zernike3D coefficients deforming vol_ref onto vol_target
    (the volume_deform_sph engine). Returns (coeffs (3,K), deformed, ncc)
    as numpy arrays and a float.

    lam adds the reference's deformation penalty (--regularization,
    volume_deform_sph.cpp:47); sigmas is the --sigma multiresolution
    list: the NCC is averaged over Gaussian-filtered copies of both
    volumes at each sigma (0 = unfiltered); mask zeroes the basis
    outside its support; coeffs0 seeds the optimization (--clnm)."""
    from xmipp3_tpu_torch.ops.fourier import freq_grid_3d
    from xmipp3_tpu_torch.ops.optim import adam_scan
    vol_ref = as_tensor(vol_ref, device)
    dev = vol_ref.device
    D = vol_ref.shape[0]
    basis = zernike_basis_grid(D, L1, L2, radius)
    if mask is not None:
        basis = basis * (np.squeeze(np.asarray(mask)) > 0.5
                         ).astype(np.float32)[None]
    basis = torch.as_tensor(basis, device=dev)
    K = basis.shape[0]
    vol_target = as_tensor(vol_target, dev)

    gmasks = []
    if sigmas:
        fz, fy, fx = freq_grid_3d(D, D, D)
        r2 = fz * fz + fy * fy + fx * fx
        for sg in sigmas:
            # real-space Gaussian of std sg px == Fourier Gaussian of
            # std 1/(2 pi sg) cycles/px
            gmasks.append(None if sg <= 0 else torch.as_tensor(np.exp(
                -2 * np.pi ** 2 * sg * sg * r2).astype(np.float32),
                device=dev))

    def _filtered(v, gm):
        if gm is None:
            return v
        return torch.fft.irfftn(torch.fft.rfftn(v) * gm, s=(D, D, D))

    targets = [(_filtered(vol_target, gm), gm) for gm in gmasks] \
        if gmasks else [(vol_target, None)]

    def loss_fn(coeffs):
        d = displacement(basis, coeffs)
        warped = warp_trilinear(vol_ref, d)
        ncc = 0.0
        for tgt, gm in targets:
            ncc = ncc + _vol_ncc(_filtered(warped, gm), tgt)
        loss = -ncc / len(targets)
        if lam > 0:
            g2 = (d ** 2).sum(0).mean()
            loss = loss + lam * torch.sqrt(g2 + 1e-12)
        return loss

    c_init = (np.zeros((3, K), np.float32) if coeffs0 is None
              else np.asarray(coeffs0, np.float32))
    coeffs, last = adam_scan(loss_fn, torch.as_tensor(c_init, device=dev),
                             n_steps, lr)
    if verbose:
        print(f"  deform refine ({n_steps} steps): NCC "
              f"{-float(last):.4f}")
    deformed = warp_trilinear(vol_ref, displacement(basis, coeffs))
    return (coeffs.cpu().numpy(), deformed.cpu().numpy(),
            float(_vol_ncc(deformed, vol_target)))


def strain_rotation_volumes(basis, coeffs):
    """Local strain / rotation analysis of the Zernike3D displacement
    field (volume_deform_sph --analyzeStrain): from the displacement
    jacobian J, strain = ||(J + J^T)/2||_F and rotation =
    ||(J - J^T)/2||_F per voxel (host numpy). Returns (strain, rotation)
    volumes."""
    b = np.asarray(basis)
    c = np.asarray(coeffs, np.float32).reshape(3, -1)
    d = np.einsum("ck,kzyx->czyx", c, b)        # displacement x,y,z fields
    # np.gradient axes: z,y,x -> J[c][ax]
    J = np.empty((3, 3) + d.shape[1:], np.float32)
    for ci in range(3):
        gz, gy, gx = np.gradient(d[ci])
        J[ci] = np.stack([gx, gy, gz])          # d u_ci / d(x,y,z)
    sym = 0.5 * (J + np.swapaxes(J, 0, 1))
    asym = 0.5 * (J - np.swapaxes(J, 0, 1))
    strain = np.sqrt((sym ** 2).sum(axis=(0, 1)))
    rotation = np.sqrt((asym ** 2).sum(axis=(0, 1)))
    return strain.astype(np.float32), rotation.astype(np.float32)


def deformation_amplitude(basis, coeffs) -> float:
    """RMS displacement of the field (the reference's sphDeformation
    metric; host numpy)."""
    dx = np.einsum("k,kzyx->zyx", coeffs[0], np.asarray(basis))
    dy = np.einsum("k,kzyx->zyx", coeffs[1], np.asarray(basis))
    dz = np.einsum("k,kzyx->zyx", coeffs[2], np.asarray(basis))
    mag2 = dx ** 2 + dy ** 2 + dz ** 2
    inside = np.asarray(basis)[0] != 0 if len(basis) else mag2 > -1
    return float(np.sqrt(mag2[inside].mean())) if inside.any() else 0.0


# ---------------------------------------------------------------------------
# 2-D Zernike polynomials over images (the reference PolyZernikes,
# data/xmipp_polynomials.{h,cpp}: Cartesian-coefficient representation per
# SPIE 3190; used by ctf_enhance_psd and fringe processing). Host numpy.
# ---------------------------------------------------------------------------

def _zernike2d_nl(nz: int):
    n = int(np.ceil((-3 + np.sqrt(9 + 8 * nz)) / 2))
    return n, 2 * nz - n * (n + 2)


def zernike2d_cart_matrix(nz: int) -> np.ndarray:
    """Integer matrix C with Z_nz(x, y) = sum_ab C[a, b] x^a y^b."""
    from math import comb, factorial
    n, l = _zernike2d_nl(nz)
    p = 1 if l > 0 else 0
    labs = abs(l)
    q = (labs - 1) // 2 if n % 2 else (labs // 2 - 1 if l > 0 else labs // 2)
    m = (n - labs) // 2
    C = np.zeros((n + 1, n + 1), np.int64)
    for i in range(q + 1):
        K1 = comb(labs, 2 * i + p)
        for j in range(m + 1):
            factor = 1 if (i + j) % 2 == 0 else -1
            K2 = (factor * K1 * factorial(n - j)
                  // (factorial(j) * factorial(m - j) * factorial(n - m - j)))
            for k in range(m - j + 1):
                ypow = 2 * (i + k) + p
                xpow = n - 2 * (i + j + k) - p
                C[xpow, ypow] += K2 * comb(m - j, k)
    return C


def _zernike2d_design(shape, indices):
    """Evaluate each Z_k over the centered grid (x = j*2/maxdim), returning
    (len(indices), H, W) float64."""
    H, W = shape
    c = 2.0 / max(H, W)
    y = (np.arange(H) - H // 2)[:, None] * c
    x = (np.arange(W) - W // 2)[None, :] * c
    out = np.zeros((len(indices), H, W), np.float64)
    for t, nz in enumerate(indices):
        C = zernike2d_cart_matrix(nz)
        acc = np.zeros((H, W), np.float64)
        for a in range(C.shape[0]):
            for b in range(C.shape[1]):
                if C[a, b]:
                    acc += C[a, b] * (x ** a) * (y ** b)
        out[t] = acc
    return out


def zernike2d_pols(coef, shape, roi=None) -> np.ndarray:
    """Image = sum_k coef[k] Z_k over the ROI (PolyZernikes::zernikePols);
    zero outside. Output in direct coordinates."""
    coef = np.asarray(coef, np.float64)
    nzs = [k for k in range(coef.size) if coef[k] != 0]
    Z = _zernike2d_design(shape, nzs)
    img = np.tensordot(coef[nzs], Z, axes=1)
    if roi is not None:
        img = np.where(np.asarray(roi, bool), img, 0.0)
    return img


def zernike2d_fit(im, coef_mask, weight=None, roi=None) -> np.ndarray:
    """Weighted LS fit of the masked Zernike set to `im` over `roi`
    (PolyZernikes::fit). Returns the fitted coefficients (one per selected
    polynomial, in index order)."""
    im = np.asarray(im, np.float64)
    H, W = im.shape
    mask = (np.ones_like(im, bool) if roi is None
            else np.asarray(roi, bool))
    w = np.ones_like(im) if weight is None else np.abs(
        np.asarray(weight, np.float64))
    coef_mask = np.asarray(coef_mask)
    nzs = [k for k in range(coef_mask.size) if coef_mask[k] != 0]
    Z = _zernike2d_design((H, W), nzs)
    A = Z[:, mask].T
    b = im[mask]
    sw = np.sqrt(w[mask])
    coeffs, *_ = np.linalg.lstsq(A * sw[:, None], b * sw, rcond=None)
    return coeffs
