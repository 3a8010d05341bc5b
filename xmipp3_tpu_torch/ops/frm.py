"""Fast Rotational Matching (FRM) over SO(3) via spherical harmonics.

Counterpart of the reference package's ops/frm.py (the reference's
interface/frm.{h,cpp} and its Situs-derived sh_alignment):

1. both volumes are sampled trilinearly on concentric spherical shells
   (index clamping at the border, as there);
2. the per-shell SH analysis is one complex64 matrix product against the
   conj(Y) quadrature matrix (scipy sph_harm_y on the host, cached per L);
3. the SO(3) correlation C(alpha, beta, gamma) = sum_l sum_mm'
   d^l_mm'(beta) T^l_mm' e^{i m alpha} e^{i m' gamma} is one 2-D FFT per
   beta over the (m, m') accumulator, in complex128 as the reference's
   numpy computes it;
4. the Wigner-d tables come from one cached eigendecomposition of J_y per
   l (host float64);
5. the grid peak is polished by a compass search on the real-space
   correlation of the warped volumes, every round's 7 candidates warped
   and scored together and the round's choice kept on the card.

Everything after the tables runs on `device` (default: the card), with
full float32 products. Conventions: the returned matrix M maximizes
corr(v1, rot) where rot = ops.geo.apply_affine_3d(v2, M)[0], i.e.
rot(x) = v2(M^-1 x) on (x, y, z) coordinates about the volume center.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor, fp32_products
from xmipp3_tpu_torch.ops.geo import apply_affine_3d


@lru_cache(maxsize=8)
def _sphere_grid(L: int):
    """Equiangular (theta, phi) grid + quadrature weights for degree L."""
    nt = 2 * L + 2
    nph = 2 * L + 2
    theta = (np.arange(nt) + 0.5) * np.pi / nt
    phi = np.arange(nph) * 2 * np.pi / nph
    w = np.sin(theta) * (np.pi / nt) * (2 * np.pi / nph)   # (nt,)
    return theta, phi, w


@lru_cache(maxsize=8)
def _sh_matrix(L: int):
    """conj(Y_lm) * quadrature weight, flattened: ((L+1)^2, nt*nph)."""
    from scipy.special import sph_harm_y
    theta, phi, w = _sphere_grid(L)
    T, P = np.meshgrid(theta, phi, indexing="ij")
    rows = []
    for l in range(L + 1):
        for m in range(-l, l + 1):
            Y = sph_harm_y(l, m, T, P)
            rows.append((np.conj(Y) * w[:, None]).ravel())
    return np.stack(rows).astype(np.complex64)


@lru_cache(maxsize=8)
def _wigner_d_tables(L: int, n_beta: int):
    """d^l_{mm'}(beta_j) for all l<=L on a beta grid in (0, pi), via one
    eigendecomposition of J_y per l: d^l(beta) = V e^{-i beta Lam} V^H.
    Returns a list of (n_beta, 2l+1, 2l+1) float64 arrays and the grid."""
    betas = (np.arange(n_beta) + 0.5) * np.pi / n_beta
    out = []
    for l in range(L + 1):
        m = np.arange(-l, l + 1)
        dim = 2 * l + 1
        Jy = np.zeros((dim, dim), complex)
        for i, mm in enumerate(m[:-1]):
            cp = np.sqrt(l * (l + 1) - mm * (mm + 1))
            Jy[i + 1, i] = cp / 2j        # <m+1|J_y|m>
            Jy[i, i + 1] = -cp / 2j       # Hermitian conjugate
        lam, V = np.linalg.eigh(Jy)
        ph = np.exp(-1j * betas[:, None] * lam[None, :])   # (nb, dim)
        out.append(np.real(np.einsum("ik,bk,jk->bij", V, ph, np.conj(V))))
    return out, betas


def _shell_coeffs(vol, L: int, radii, device=None):
    """SH coefficients f_lm(r) of each shell radius: (nR, (L+1)^2)
    complex64 on the volume's device."""
    vol = as_tensor(vol, device)
    dev = vol.device
    theta, phi, _ = _sphere_grid(L)
    T, P = np.meshgrid(theta, phi, indexing="ij")
    st = np.sin(T)
    u = np.stack([(st * np.cos(P)).ravel(), (st * np.sin(P)).ravel(),
                  np.cos(T).ravel()])                       # (x, y, z)
    D, H, W = vol.shape
    radii = np.asarray(radii, np.float64)
    # sample coordinates in float64 on the host, as the reference's numpy
    xs, ys, zs = (torch.as_tensor(radii[:, None] * u[a][None, :] + c,
                                  dtype=torch.float32, device=dev)
                  for a, c in ((0, W // 2), (1, H // 2), (2, D // 2)))
    z0, y0, x0 = (torch.floor(c).to(torch.int64) for c in (zs, ys, xs))
    fz, fy, fx = zs - z0, ys - y0, xs - x0
    vals = torch.zeros(z0.shape, device=dev)
    for dz in range(2):
        for dy in range(2):
            for dx in range(2):
                w = ((fz if dz else 1 - fz) * (fy if dy else 1 - fy)
                     * (fx if dx else 1 - fx))
                vals = vals + w * vol[(z0 + dz).clamp(0, D - 1),
                                      (y0 + dy).clamp(0, H - 1),
                                      (x0 + dx).clamp(0, W - 1)]
    Y = torch.as_tensor(_sh_matrix(L), device=dev)          # (nlm, npts)
    with fp32_products():
        return vals.to(torch.complex64) @ Y.T


def so3_correlation(flm, glm, L: int, n_beta: int = 64, n_ang: int = 128,
                    shell_w=None, device=None):
    """C(alpha, beta, gamma) grid from per-shell SH coefficients.

    flm/glm: (nR, (L+1)^2) (tensors or arrays). Returns (C (n_beta, n_ang,
    n_ang) float64 tensor, betas): C[b, a, g] = correlation at
    alpha_a = 2 pi a / n_ang etc."""
    flm = as_tensor(flm, device, torch.complex128)
    glm = as_tensor(glm, flm.device, torch.complex128)
    dev = flm.device
    nR = flm.shape[0]
    w = torch.as_tensor(np.ones(nR) if shell_w is None else shell_w,
                        dtype=torch.complex128, device=dev)
    dtab, betas = _wigner_d_tables(L, n_beta)
    # the (m, m') accumulator of sum_l d^l(beta) T^l, T^l_{mm'} =
    # sum_r w_r f_lm(r) conj(g_lm'(r)), placed at frequencies m mod n_ang
    big = torch.zeros((n_beta, n_ang, n_ang), dtype=torch.complex128,
                      device=dev)
    for l in range(L + 1):
        sl = slice(l * l, (l + 1) * (l + 1))
        T = (w[:, None] * flm[:, sl]).T @ glm[:, sl].conj()
        idx = torch.as_tensor(np.arange(-l, l + 1) % n_ang, device=dev)
        big[:, idx[:, None], idx[None, :]] += \
            torch.as_tensor(dtab[l], device=dev) * T[None]
    C = torch.fft.ifft2(big, dim=(1, 2)) * (n_ang * n_ang)
    return C.real, betas


def _zyz_active(alpha, beta, gamma):
    """Active rotation R_z(alpha) R_y(beta) R_z(gamma) on (x, y, z)."""
    ca, sa = np.cos(alpha), np.sin(alpha)
    cb, sb = np.cos(beta), np.sin(beta)
    cg, sg = np.cos(gamma), np.sin(gamma)
    Rza = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1.0]])
    Ryb = np.array([[cb, 0, sb], [0, 1.0, 0], [-sb, 0, cb]])
    Rzg = np.array([[cg, -sg, 0], [sg, cg, 0], [0, 0, 1.0]])
    return (Rza @ Ryb @ Rzg).astype(np.float32)


def frm_align_volumes(v1, v2, L: int = 24, n_beta: int = 64,
                      n_ang: int = 128, refine: bool = True,
                      radii=None, device=None):
    """Best rotation matrix M (3x3 float32 numpy) aligning v2 onto v1:
    maximizes corr(v1, apply_affine_3d(v2, M)).

    Reference: interface/frm.h:35-52 (frm_align via sh_alignment); the
    translation part of the reference pipeline is left to the caller."""
    v1 = as_tensor(v1, device)
    v2 = as_tensor(v2, v1.device)
    D = v1.shape[0]
    if radii is None:
        radii = np.arange(2.0, D // 2 - 1, 1.0)
    radii = np.asarray(radii, np.float64)
    flm = _shell_coeffs(v1 - v1.mean(), L, radii)
    glm = _shell_coeffs(v2 - v2.mean(), L, radii)
    C, betas = so3_correlation(flm, glm, L, n_beta, n_ang,
                               shell_w=radii ** 2)
    b, a, g = np.unravel_index(int(torch.argmax(C)), C.shape)
    M = _zyz_active(2 * np.pi * a / n_ang, betas[b], 2 * np.pi * g / n_ang)
    if refine:
        M = _refine_rotation(v1, v2, M)
    return M


def _rotvec_mats(w):
    """Rodrigues rotation matrices (S, 3, 3) of rotation vectors (S, 3)."""
    th = torch.linalg.vector_norm(w, dim=1) + 1e-12
    k = w / th[:, None]
    z = torch.zeros_like(th)
    K = torch.stack([torch.stack([z, -k[:, 2], k[:, 1]], dim=1),
                     torch.stack([k[:, 2], z, -k[:, 0]], dim=1),
                     torch.stack([-k[:, 1], k[:, 0], z], dim=1)], dim=1)
    s, c = torch.sin(th)[:, None, None], torch.cos(th)[:, None, None]
    return torch.eye(3, device=w.device) + s * K + (1 - c) * (K @ K)


def _refine_rotation(v1, v2, M0, step0: float = 0.02, n_rounds: int = 18):
    """Polish of the rotation on the real-space correlation: a compass
    search over the rotation-vector perturbation w (exp(w^) applied on the
    left of M0), the +/- candidates of a round warped and scored together.
    The round's choice stays on the card; the host reads M once."""
    v1 = as_tensor(v1)
    v2 = as_tensor(v2, v1.device)
    dev = v1.device
    M0 = torch.as_tensor(np.asarray(M0, np.float32), device=dev)
    v1c = v1 - v1.mean()
    n1 = torch.linalg.vector_norm(v1c)

    def costs(ws):
        with fp32_products():
            mats = _rotvec_mats(ws) @ M0
        r = apply_affine_3d(v2, mats)
        r = r - r.mean(dim=(1, 2, 3), keepdim=True)
        num = (r * v1c).sum(dim=(1, 2, 3))
        return -num / torch.clamp(
            torch.linalg.vector_norm(r.reshape(len(r), -1), dim=1) * n1,
            min=1e-12)

    E = torch.cat([torch.zeros((1, 3), device=dev),
                   torch.eye(3, device=dev), -torch.eye(3, device=dev)])
    w = torch.zeros(3, device=dev)
    step = torch.tensor(step0, device=dev)
    best = costs(w[None])[0]
    for _ in range(n_rounds):
        cands = w[None, :] + E * step
        c = costs(cands)
        k = torch.argmin(c)
        improved = (k != 0) & (c[k] < best - 1e-9)
        w = torch.where(improved, cands[k], w)
        step = torch.where(improved, step, step * 0.5)
        best = torch.where(improved, c[k], best)
    with fp32_products():
        return (_rotvec_mats(w[None])[0] @ M0).cpu().numpy()
