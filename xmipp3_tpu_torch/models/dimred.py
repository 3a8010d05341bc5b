"""Dimensionality reduction: PCA, EM-PCA and its z-scores, and the
reference's other reductions (incremental and probabilistic PCA, kernel
PCA, Laplacian eigenmaps, LPP, LLE, LTSA, diffusion maps, Sammon, NPE,
LLTSA, Hessian LLE, SPE, NCA, GPLVM) with the intrinsic dimension.

Counterpart of the reference package's models/dimred.py. Every function
takes X (N, D) and returns Y (N, d) as float64 numpy; the work runs on
`device` (default: the card).
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


# ------------------------------------------------- the other reductions
#
# Counterpart of the rest of the reference's models/dimred.py (dimred.py:
# 75-521), where everything runs on the host in numpy/scipy float64. Here
# the dense (N, N) and (D, D) problems run in float64 on `device`: the
# generalized symmetric eigenproblems through a Cholesky (or a diagonal)
# reduction to a standard one, which keeps scipy's normalisation
# v^T B v = I. Random starts come from numpy Generators in the reference's
# order, and starts that the reference takes from its SVD-based pca come
# from the same numpy SVD on the host. SPE's 20,000 sequential pair updates
# stay on the host, as in the reference. An embedding's axes carry the
# signs that the solver gives.


def _f64(X, device):
    return as_tensor(X, device, torch.float64)


def _host(t):
    return t.cpu().numpy()


def _svd_pca(X, d):
    """The reference's pca (dimred.py:18): projections on the top-d axes
    of a numpy SVD of the centred data."""
    X = np.asarray(X, np.float64)
    U, S, _ = np.linalg.svd(X - X.mean(axis=0), full_matrices=False)
    return U[:, :d] * S[:d]


def _sqdist(X):
    """(N, N) squared Euclidean distances of the rows of X, each pair summed
    directly as scipy's pdist does (no Gram-matrix cancellation), in row
    blocks of about 2^27 differences."""
    N, D = X.shape
    step = max(1, (1 << 27) // max(N * D, 1))
    return torch.cat([((X[i:i + step, None, :] - X[None, :, :]) ** 2)
                      .sum(-1) for i in range(0, N, step)])


def _median(t):
    """numpy's median of a 1-D tensor (the mean of the two middle values
    of an even count; torch.median takes the lower one)."""
    s = torch.sort(t.reshape(-1))[0]
    n = len(s)
    return float(s[n // 2]) if n % 2 else float(0.5 * (s[n // 2 - 1]
                                                        + s[n // 2]))


def _knn_graph(X, k):
    D = torch.sqrt(_sqdist(X))
    D.fill_diagonal_(float("inf"))
    return D, torch.argsort(D, dim=1)[:, :k]


def _eigh_general(A, B):
    """Eigenpairs of A v = w B v (B symmetric positive definite), ascending,
    with v^T B v = I, as scipy.linalg.eigh(A, B) gives them."""
    L = torch.linalg.cholesky(B)
    Li = torch.linalg.solve_triangular(
        L, torch.eye(len(B), dtype=B.dtype, device=B.device), upper=False)
    C = Li @ A @ Li.T
    w, U = torch.linalg.eigh(0.5 * (C + C.T))
    return w, Li.T @ U


def _heat_weights(D, nn, sigma):
    N = len(D)
    rows = torch.arange(N, device=D.device)[:, None]
    W = torch.zeros_like(D)
    W[rows, nn] = torch.exp(-D[rows, nn] ** 2 / (2 * sigma ** 2))
    return torch.maximum(W, W.T)


class IncrementalPCA:
    """Streaming PCA (the reference PCAonline role, basic_pca.cpp:518):
    accumulates the sum and, up to EXACT_DIM_LIMIT features, the exact
    second moments batch by batch; beyond it a rank-k sketch bounds memory.
    float64 on `device`."""

    EXACT_DIM_LIMIT = 4096

    def __init__(self, d: int = 2, sketch_rank: int | None = None,
                 device=None):
        self.d = d
        self._k = sketch_rank or max(4 * d + 16, 32)  # oversampled rank
        self.device = resolve_device(device)
        self.n = 0
        self._sum = None             # running sum(x)
        self._moment = None          # running sum(x x^T) when D small
        self._sketch = None          # (k, D) sketch when D large

    def partial_fit(self, X):
        X = _f64(X, self.device)
        s = X.sum(dim=0)
        self._sum = s if self._sum is None else self._sum + s
        self.n += len(X)
        if X.shape[1] <= self.EXACT_DIM_LIMIT:
            m = X.T @ X
            self._moment = m if self._moment is None else self._moment + m
        else:
            stack = X if self._sketch is None else torch.cat([self._sketch,
                                                              X])
            _, S, Vt = torch.linalg.svd(stack, full_matrices=False)
            k = min(self._k, len(S))
            self._sketch = S[:k, None] * Vt[:k]
        return self

    @property
    def mean(self):
        return _host(self._sum / self.n)

    @property
    def components(self):
        mu = self._sum / self.n
        if self._moment is not None:
            cov = self._moment / self.n - torch.outer(mu, mu)
            _, V = torch.linalg.eigh(cov)
            return _host(V.flip(1)[:, :self.d].T)
        # sketch path: remove the mean from the sketch rows
        sk = self._sketch - (self._sketch @ mu)[:, None] \
            * mu[None, :] / torch.clamp(mu @ mu, min=1e-300)
        _, _, Vt = torch.linalg.svd(sk, full_matrices=False)
        return _host(Vt[:self.d])

    def transform(self, X):
        return (np.asarray(X, np.float64) - self.mean) @ self.components.T


def probabilistic_pca(X, d=2, n_iters: int = 50, seed: int = 0,
                      device=None):
    """EM for pPCA (Tipping & Bishop); the start W from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    X = _f64(X, device)
    N, D = X.shape
    Xc = X - X.mean(dim=0)
    W = _f64(rng.standard_normal((D, d)), X.device)
    I = torch.eye(d, dtype=X.dtype, device=X.device)
    sigma2 = 1.0
    for _ in range(n_iters):
        Minv = torch.linalg.inv(W.T @ W + sigma2 * I)
        Ez = Xc @ W @ Minv                       # (N,d)
        Ezz = N * sigma2 * Minv + Ez.T @ Ez      # (d,d)
        W = Xc.T @ Ez @ torch.linalg.inv(Ezz)
        sigma2 = float(((Xc ** 2).sum() - 2 * ((Xc @ W) * Ez).sum()
                        + torch.trace(Ezz @ W.T @ W)) / (N * D))
        sigma2 = max(sigma2, 1e-9)
    return _host(Xc @ W @ torch.linalg.inv(W.T @ W + sigma2 * I))


def kernel_pca(X, d=2, gamma=None, device=None):
    X = _f64(X, device)
    sq = _sqdist(X)
    if gamma is None:
        gamma = 1.0 / _median(sq[sq > 0])
    K = torch.exp(-gamma * sq)
    # K - 1K - K1 + 1K1 with 1 = ones/N
    Kc = K - K.mean(dim=0, keepdim=True) - K.mean(dim=1, keepdim=True) \
        + K.mean()
    w, v = torch.linalg.eigh(Kc)
    w, v = w.flip(0)[:d], v.flip(1)[:, :d]
    return _host(v * torch.sqrt(torch.clamp(w, min=1e-12)))


def laplacian_eigenmap(X, d=2, k=8, sigma=None, device=None):
    X = _f64(X, device)
    D, nn = _knn_graph(X, k)
    rows = torch.arange(len(X), device=X.device)[:, None]
    if sigma is None:
        sigma = _median(D[rows, nn])
    W = _heat_weights(D, nn, sigma)
    deg = W.sum(dim=1)
    # L v = w Deg v with a diagonal Deg: v = Deg^-1/2 u
    r = 1.0 / torch.sqrt(deg + 1e-12)
    L = torch.diag(deg) - W
    _, U = torch.linalg.eigh(r[:, None] * L * r[None, :])
    return _host((r[:, None] * U)[:, 1:d + 1])


def lpp(X, d=2, k=8, device=None):
    """Locality Preserving Projections (linear Laplacian eigenmap)."""
    X = _f64(X, device)
    Xc = X - X.mean(dim=0)
    D, nn = _knn_graph(Xc, k)
    rows = torch.arange(len(X), device=X.device)[:, None]
    W = _heat_weights(D, nn, _median(D[rows, nn]))
    deg = W.sum(dim=1)
    A = Xc.T @ (torch.diag(deg) - W) @ Xc
    B = Xc.T @ (deg[:, None] * Xc) \
        + 1e-9 * torch.eye(X.shape[1], dtype=X.dtype, device=X.device)
    _, v = _eigh_general(A, B)
    return _host(Xc @ v[:, :d])


def _lle_weights(X, nn, k, reg):
    """(N, N) reconstruction weights of each point from its k neighbours
    (the reference's per-point loop, batched)."""
    N = len(X)
    Z = X[nn] - X[:, None, :]                          # (N, k, D)
    C = Z @ Z.transpose(1, 2)
    tr = torch.diagonal(C, dim1=1, dim2=2).sum(dim=1)
    I = torch.eye(k, dtype=X.dtype, device=X.device)
    C = C + torch.where(tr > 0, reg * tr, reg)[:, None, None] * I
    w = torch.linalg.solve(C, torch.ones(N, k, dtype=X.dtype,
                                         device=X.device))
    W = torch.zeros((N, N), dtype=X.dtype, device=X.device)
    W[torch.arange(N, device=X.device)[:, None], nn] = \
        w / w.sum(dim=1, keepdim=True)
    return W


def lle(X, d=2, k=8, reg=1e-3, device=None):
    """Locally Linear Embedding."""
    X = _f64(X, device)
    _, nn = _knn_graph(X, k)
    M = torch.eye(len(X), dtype=X.dtype, device=X.device) \
        - _lle_weights(X, nn, k, reg)
    _, v = torch.linalg.eigh(M.T @ M)
    return _host(v[:, 1:d + 1])


def _ltsa_alignment(X, nn, d):
    """The LTSA alignment matrix: sum over the neighbourhoods {i} + nn[i]
    of I - G G^T, G = [1/sqrt(k+1), top-d local left singular vectors]."""
    N = len(X)
    idx = torch.cat([torch.arange(N, device=X.device)[:, None], nn], dim=1)
    n = idx.shape[1]
    Xi = X[idx] - X[idx].mean(dim=1, keepdim=True)       # (N, k+1, D)
    U = torch.linalg.svd(Xi, full_matrices=False)[0][:, :, :d]
    G = torch.cat([torch.full((N, n, 1), 1.0 / np.sqrt(n), dtype=X.dtype,
                              device=X.device), U], dim=2)
    Wi = torch.eye(n, dtype=X.dtype, device=X.device) - G @ G.transpose(1, 2)
    B = torch.zeros((N, N), dtype=X.dtype, device=X.device)
    B.index_put_((idx[:, :, None].expand(N, n, n),
                  idx[:, None, :].expand(N, n, n)), Wi, accumulate=True)
    return B


def ltsa(X, d=2, k=8, device=None):
    """Local Tangent Space Alignment."""
    X = _f64(X, device)
    _, nn = _knn_graph(X, k)
    _, v = torch.linalg.eigh(_ltsa_alignment(X, nn, d))
    return _host(v[:, 1:d + 1])


def diffusion_map(X, d=2, sigma=None, t=1, device=None):
    """The reference takes np.linalg.eig of the Markov matrix
    P = Dg^-1 Knorm; P is similar to the symmetric Dg^-1/2 Knorm Dg^-1/2,
    whose eigh gives the same eigenvalues and, mapped by Dg^-1/2 and scaled
    to unit norm as eig scales them, the same eigenvectors."""
    X = _f64(X, device)
    sq = _sqdist(X)
    if sigma is None:
        sigma = float(np.sqrt(_median(sq[sq > 0])))
    K = torch.exp(-sq / (2 * sigma ** 2))
    q = K.sum(dim=1)
    Knorm = K / torch.outer(q, q)
    r = 1.0 / torch.sqrt(Knorm.sum(dim=1))
    w, U = torch.linalg.eigh(r[:, None] * Knorm * r[None, :])
    w, U = w.flip(0)[1:d + 1], U.flip(1)[:, 1:d + 1]
    v = r[:, None] * U
    v = v / torch.linalg.vector_norm(v, dim=0)
    return _host(v * w ** t)


def sammon(X, d=2, n_iters=100, lr=0.3, seed=0, device=None):
    """Sammon mapping by gradient descent from the reference's start
    (its SVD pca plus 1e-4 noise from default_rng(seed))."""
    rng = np.random.default_rng(seed)
    Y0 = _svd_pca(X, d) + 1e-4 * rng.standard_normal((len(X), d))
    X = _f64(X, device)
    Dx = torch.sqrt(_sqdist(X))
    Dx.fill_diagonal_(1.0)
    Y = _f64(Y0, X.device)
    c = Dx.sum()
    for _ in range(n_iters):
        Dy = torch.sqrt(_sqdist(Y))
        Dy.fill_diagonal_(1.0)
        ratio = (Dx - Dy) / (Dx * Dy)
        ratio.fill_diagonal_(0.0)
        # sum_j ratio_ij (Y_i - Y_j)
        grad = -2.0 / c * (ratio.sum(dim=1, keepdim=True) * Y - ratio @ Y)
        Y = Y - lr * grad
    return _host(Y)


def npe(X, d=2, k=8, reg=1e-3, device=None):
    """Neighborhood Preserving Embedding — the linear variant of LLE
    (reference libraries/dimred/npe.cpp): X^T M X v = w X^T X v with
    M = (I-W)^T (I-W)."""
    X = _f64(X, device)
    Xc = X - X.mean(dim=0)
    _, nn = _knn_graph(Xc, k)
    M = torch.eye(len(X), dtype=X.dtype, device=X.device) \
        - _lle_weights(Xc, nn, k, reg)
    A = Xc.T @ (M.T @ M) @ Xc
    B = Xc.T @ Xc + 1e-9 * torch.eye(X.shape[1], dtype=X.dtype,
                                     device=X.device)
    _, v = _eigh_general(A, B)
    return _host(Xc @ v[:, :d])


def lltsa(X, d=2, k=8, device=None):
    """Linear Local Tangent Space Alignment (reference dimred/lltsa.cpp):
    the LTSA alignment matrix constrained to a linear projection."""
    X = _f64(X, device)
    Xc = X - X.mean(dim=0)
    _, nn = _knn_graph(Xc, k)
    A = Xc.T @ _ltsa_alignment(Xc, nn, d) @ Xc
    B = Xc.T @ Xc + 1e-9 * torch.eye(X.shape[1], dtype=X.dtype,
                                     device=X.device)
    _, v = _eigh_general(A, B)
    return _host(Xc @ v[:, :d])


def hlle(X, d=2, k=None, device=None):
    """Hessian Locally Linear Embedding (reference dimred/hessianLLE.cpp):
    null space of the accumulated local Hessian estimators, every
    neighbourhood's SVD and QR batched."""
    X = _f64(X, device)
    N = len(X)
    dp = d * (d + 1) // 2
    if k is None:
        k = max(d + dp + 2, 8)
    _, nn = _knn_graph(X, k)
    Xi = X[nn] - X[nn].mean(dim=1, keepdim=True)          # (N, k, D)
    tang = torch.linalg.svd(Xi, full_matrices=False)[0][:, :, :d]
    # design matrix: [1, tangent coords, symmetric quadratic terms]
    cols = [torch.ones(N, k, dtype=X.dtype, device=X.device)] \
        + [tang[:, :, a] for a in range(d)] \
        + [tang[:, :, a] * tang[:, :, b] for a in range(d)
           for b in range(a, d)]
    Q = torch.linalg.qr(torch.stack(cols, dim=2))[0]
    H = Q[:, :, 1 + d:1 + d + dp]            # Hessian estimator columns
    # normalize columns so each quadratic form integrates to 1
    s = H.sum(dim=1, keepdim=True)
    H = H / torch.where(s.abs() < 1e-12, 1.0, s)
    Hacc = torch.zeros((N, N), dtype=X.dtype, device=X.device)
    Hacc.index_put_((nn[:, :, None].expand(N, k, k),
                     nn[:, None, :].expand(N, k, k)),
                    H @ H.transpose(1, 2), accumulate=True)
    _, v = torch.linalg.eigh(Hacc)
    emb = v[:, 1:d + 1]
    # scale to unit covariance (standard HLLE post-normalization)
    ww, vv = torch.linalg.eigh(emb.T @ emb / N)
    return _host(emb @ vv @ torch.diag(
        1.0 / torch.sqrt(torch.clamp(ww, min=1e-12))) @ vv.T)


def spe(X, d=2, n_iters=20000, lam=1.0, rcut=None, seed=0, device=None):
    """Stochastic Proximity Embedding (Agrafiotis; reference
    dimred/spe.cpp): random pair updates matching input distances within
    a neighborhood cutoff. Its n_iters sequential updates of two points
    each run on the host, as in the reference; the distance matrix comes
    from `device`."""
    rng = np.random.default_rng(seed)
    Xt = _f64(X, device)
    Dx = _host(torch.sqrt(_sqdist(Xt)))
    N = len(Dx)
    if rcut is None:
        rcut = np.percentile(Dx[Dx > 0], 25)
    Y = _svd_pca(X, d) * 0.1 + 0.01 * rng.standard_normal((N, d))
    lam0, lam1 = lam, 0.01
    for it in range(n_iters):
        l = lam0 + (lam1 - lam0) * it / max(n_iters - 1, 1)
        i, j = rng.integers(0, N, 2)
        if i == j:
            continue
        dy = np.linalg.norm(Y[i] - Y[j]) + 1e-10
        dx = Dx[i, j]
        if dx <= rcut or dy < dx:
            delta = l * 0.5 * (dx - dy) / dy * (Y[i] - Y[j])
            Y[i] += delta
            Y[j] -= delta
    return Y


def nca(X, d=2, labels=None, n_iters=60, lr=0.2, seed=0, device=None):
    """Neighborhood Component Analysis (reference dimred/nca.cpp):
    maximizes the softmax leave-one-out classification of `labels` under a
    linear map, by gradient steps (autograd), float32 as the reference's.
    Without labels, scipy k-means pseudo-labels from `seed`."""
    X = np.asarray(X, np.float64)
    N = len(X)
    if labels is None:
        from scipy.cluster.vq import kmeans2
        _, labels = kmeans2(X, max(2, d + 1), seed=seed, minit="++")
    labels = np.asarray(labels)
    A0 = np.linalg.svd(X - X.mean(0), full_matrices=False)[2][:d]
    dev = resolve_device(device)
    same = torch.as_tensor((labels[:, None] == labels[None, :])
                           & ~np.eye(N, dtype=bool), dtype=torch.float32,
                           device=dev)
    Xt = as_tensor(X, dev)
    A = as_tensor(A0, dev)
    eye = 1e10 * torch.eye(N, device=dev)
    with fp32_products():
        for _ in range(n_iters):
            A = A.detach().requires_grad_(True)
            Y = Xt @ A.T
            sq = ((Y[:, None, :] - Y[None, :, :]) ** 2).sum(-1) + eye
            loss = -(torch.softmax(-sq, dim=1) * same).sum()
            g, = torch.autograd.grad(loss, A)
            A = A.detach() - lr * g / N
        return _host(Xt @ A.T)


def gplvm(X, d=2, n_iters=100, lr=0.05, seed=0, device=None):
    """Gaussian Process Latent Variable Model (reference dimred/gplvm.cpp):
    latent positions maximizing the GP marginal likelihood with an RBF
    kernel; Adam on the autograd gradient, float32 as the reference's,
    from its SVD pca start."""
    X = np.asarray(X, np.float64)
    N, D = X.shape
    Xc = X - X.mean(axis=0)
    Y0 = _svd_pca(Xc, d)
    Y0 = Y0 / max(np.abs(Y0).max(), 1e-9)
    dev = resolve_device(device)
    S = as_tensor(Xc @ Xc.T, dev)
    eye = torch.eye(N, device=dev)

    def neg_ll(Y, log_g, log_s):
        sq = ((Y[:, None, :] - Y[None, :, :]) ** 2).sum(-1)
        K = torch.exp(-0.5 * torch.exp(log_g) * sq) + torch.exp(log_s) * eye
        L = torch.linalg.cholesky(K)
        logdet = 2.0 * torch.log(torch.diagonal(L)).sum()
        return 0.5 * (D * logdet + torch.trace(torch.cholesky_solve(S, L)))

    params = [as_tensor(Y0, dev), torch.tensor(0.0, device=dev),
              torch.tensor(-2.0, device=dev)]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    b1, b2, eps = 0.9, 0.999, 1e-8
    with fp32_products():
        for t in range(1, n_iters + 1):
            ps = [p.detach().requires_grad_(True) for p in params]
            g = torch.autograd.grad(neg_ll(*ps), ps)
            for i in range(3):
                m[i] = b1 * m[i] + (1 - b1) * g[i]
                v[i] = b2 * v[i] + (1 - b2) * g[i] ** 2
                mh = m[i] / (1 - b1 ** t)
                vh = v[i] / (1 - b2 ** t)
                params[i] = params[i] - lr * mh / (torch.sqrt(vh) + eps)
    return _host(params[0])


METHODS = {
    "PCA": pca, "pPCA": probabilistic_pca, "kPCA": kernel_pca,
    "LE": laplacian_eigenmap, "LPP": lpp, "LLE": lle, "LTSA": ltsa,
    "DM": diffusion_map, "Sammon": sammon, "NPE": npe, "LLTSA": lltsa,
    "HLLE": hlle, "SPE": spe, "NCA": nca, "GPLVM": gplvm,
}


def reduce_dimensionality(X, method: str = "PCA", d: int = 2, device=None,
                          **kw):
    if method not in METHODS:
        raise ValueError(f"unknown dimred method {method} "
                         f"(available: {', '.join(METHODS)})")
    return np.asarray(METHODS[method](X, d=d, device=device, **kw))


def intrinsic_dimensionality(X, method: str = "CorrDim",
                             normalize: bool = True, device=None) -> float:
    """Intrinsic dimensionality estimate (reference dimred_tools.cpp:341-448
    intrinsicDimensionality): 'MLE' = Levina-Bickel k-NN MLE averaged over
    k in [5, 12]; 'CorrDim' = correlation dimension from the pairwise
    distance CDF between the median and maximum 3-NN distance."""
    X = np.asarray(X, np.float64)
    if normalize:
        # on the host, as the reference: a last-bit difference of the
        # scaled data flips the pairs that tie with the median distance
        X = (X - X.mean(axis=0)) / np.maximum(X.std(axis=0), 1e-300)
    X = _f64(X, device)
    N = len(X)
    d2 = _sqdist(X)
    d2.fill_diagonal_(float("inf"))
    if method == "MLE":
        k1, k2 = 5, 12
        if k2 > N:
            k2 = N - 1
            k1 = k2 // 2
        knn = torch.sqrt(torch.sort(d2, dim=1)[0][:, :k2])
        logd = torch.log(torch.clamp(knn, min=1e-300))
        S = torch.cumsum(logd, dim=1)
        dsum = 0.0
        for k in range(k1, k2):
            dsum += float(((k - 1) / (S[:, k] - logd[:, k] * (k + 1))).sum())
        return -dsum / ((k2 - k1) * N)
    if method == "CorrDim":
        K = min(3, N - 1)
        flat = torch.sort(torch.sqrt(torch.sort(d2, dim=1)[0][:, :K])
                          .reshape(-1))[0]
        median = float(flat[len(flat) // 2]) ** 2
        max_val = float(flat[-1]) ** 2
        if max_val == 0:
            return 0.0
        iu = torch.triu_indices(N, N, offset=1, device=X.device)
        pair = d2[iu[0], iu[1]]
        p_max = float((pair <= max_val).double().mean())
        p_med = float((pair <= median).double().mean())
        if p_med <= 0 or p_max <= 0 or max_val <= median:
            return 0.0
        return 2.0 * np.log(p_max / p_med) / np.log(max_val / median)
    raise ValueError(f"unknown dimensionality estimate method {method}")
