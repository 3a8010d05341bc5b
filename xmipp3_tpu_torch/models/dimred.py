"""Principal components: PCA, EM-PCA and the EM-PCA z-scores.

Counterpart of the first part of the reference package's models/dimred.py
(`pca`, `empca`, `pca_zscores`, dimred.py:18-72), the part that the
classification programs call (classify_CL2D_core_analysis,
angular_accuracy_pca). Everything runs on `device` (default: the card).
The reference's other dimension reductions come with the programs that
call them (ROADMAP.md, port queue items 11 and 14).
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor, fp32_products, resolve_device


def pca(X, d=2, return_model=False, device=None):
    """Projections (N, d) on the top-d principal axes of X (N, D), float64.

    The reference takes a full SVD of the centred data. Here the same
    subspace comes from a float64 eigendecomposition of the smaller of the
    two Gram matrices, Xc Xc^T (N, N) or Xc^T Xc (D, D): at 10,000 images of
    128^2 pixels that is a 10,000^2 problem instead of an SVD of 10,000 x
    16,384. An axis and its projections carry the sign the solver gives
    (as with the SVD, the sign is arbitrary). With return_model also
    dict(mean, components (d, D), explained (d,)) as numpy."""
    X = as_tensor(X, device, torch.float64)
    N, D = X.shape
    mu = X.mean(dim=0)
    Xc = X - mu
    if N <= D:
        lam, U = torch.linalg.eigh(Xc @ Xc.T)
        lam, U = lam.flip(0)[:d].clamp(min=0.0), U.flip(1)[:, :d]
        s = torch.sqrt(lam)
        Y = U * s
        comps = (Xc.T @ U / s.clamp(min=1e-300)).T
    else:
        lam, V = torch.linalg.eigh(Xc.T @ Xc)
        lam, V = lam.flip(0)[:d].clamp(min=0.0), V.flip(1)[:, :d]
        Y = Xc @ V
        comps = V.T
    Y = Y.cpu().numpy()
    if return_model:
        return Y, dict(mean=mu.cpu().numpy(), components=comps.cpu().numpy(),
                       explained=(lam / (N - 1)).cpu().numpy())
    return Y


def empca(X, d=2, n_iters: int = 10, seed: int = 0, return_basis=False,
          device=None):
    """EM-PCA (Roweis, NIPS'97; the reference PCAMahalanobisAnalyzer::
    learnPCABasis, basic_pca.cpp:170): the E-step solves the coefficients
    for the current basis, the M-step refits the basis; float32 products
    on the card, as the reference's. The start basis is d samples drawn
    from default_rng(seed). Returns projections (N, d) float64 numpy; with
    return_basis also (basis (d, D), mean)."""
    rng = np.random.default_rng(seed)
    X = np.asarray(X, np.float64)
    N, D = X.shape
    d = min(d, N)
    mu = X.mean(axis=0)
    dev = resolve_device(device)
    Y = torch.as_tensor((X - mu).T, dtype=torch.float32, device=dev)  # (D,N)
    C = torch.as_tensor(X[rng.choice(N, d, replace=False)].T - mu[:, None],
                        dtype=torch.float32, device=dev)              # (D,d)
    with fp32_products():
        for _ in range(n_iters):
            Xc = torch.linalg.solve(C.T @ C, C.T @ Y)      # E-step
            C = (Y @ Xc.T) @ torch.linalg.inv(Xc @ Xc.T)   # M-step
        # orthonormalise for a clean projection
        Q, _ = torch.linalg.qr(C)
        proj = (Q.T @ Y).T.cpu().numpy().astype(np.float64)
    if return_basis:
        return proj, Q.T.cpu().numpy().astype(np.float64), mu
    return proj


def pca_zscores(X, d=3, n_iters: int = 10, seed: int = 0, device=None):
    """Mahalanobis z-scores in the EM-PCA subspace (the reference
    PCAMahalanobisAnalyzer::evaluateZScore, basic_pca.cpp:384): project on
    the learned basis, estimate the (d, d) covariance of the projections,
    z = sqrt(p^T cov^-1 p). Returns (N,) float64 numpy."""
    proj = empca(X, d=d, n_iters=n_iters, seed=seed, device=device)
    cov = proj.T @ proj / len(proj)
    covinv = np.linalg.inv(cov + 1e-12 * np.eye(proj.shape[1]))
    return np.sqrt(np.abs(np.einsum("ni,ij,nj->n", proj, covinv, proj)))
