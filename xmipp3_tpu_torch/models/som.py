"""Self-organizing maps: SOM, kerdenSOM, batch SOM, fuzzy c-means, fuzzy SOM
and the code book.

Counterpart of the reference package's models/som.py (the reference
classification/ library: som, kerdensom, batch_som, fcmeans, fuzzy_som,
code_book). Each map's (N, K) distances, responsibilities and its (K, K)
solve run in float64 on `device` (default: the card). The initial code
books and memberships are drawn on the host from numpy Generators made
from the same seeds as the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor


def _grid_distances(shape, topology: str = "RECT"):
    """Squared map-lattice distances (K, K), float64 numpy. HEXA offsets
    every other row by half a cell and compresses rows by sqrt(3)/2 (the
    reference's hexagonal lattice, classification/map.cpp)."""
    ny, nx = shape
    yy, xx = np.mgrid[0:ny, 0:nx]
    coords = np.stack([yy.ravel(), xx.ravel()], axis=1).astype(np.float64)
    if topology.upper() == "HEXA":
        coords[:, 1] += 0.5 * (coords[:, 0] % 2)
        coords[:, 0] *= np.sqrt(3.0) / 2.0
    return ((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1)


def _data(X, device):
    return as_tensor(X, device, torch.float64)


def _sqdist(X, code):
    """(N, K) squared distances, each as a sum of squared differences."""
    return ((X[:, None, :] - code[None, :, :]) ** 2).sum(-1)


def _initial_code(X, K: int, seed: int):
    """K samples of X plus 1 % noise, drawn from default_rng(seed) (the
    reference's initial code book)."""
    rng = np.random.default_rng(seed)
    N, D = X.shape
    pick = rng.choice(N, K, replace=N < K)
    noise = rng.standard_normal((K, D))
    return X[torch.as_tensor(pick, device=X.device)] + 0.01 * \
        torch.as_tensor(noise, device=X.device)


def _result(X, code):
    return code.cpu().numpy(), _sqdist(X, code).argmin(dim=1).cpu().numpy()


def som(X, shape=(4, 4), n_iters: int = 200, radius0: float | None = None,
        radiusF: float = 0.5, alpha0: float = 0.5, seed: int = 0,
        verbose: int = 0, device=None):
    """Classic Kohonen SOM with the deterministic batch update. Returns
    (codebook (K, D), assignments (N,)) as numpy."""
    X = _data(X, device)
    code = _initial_code(X, shape[0] * shape[1], seed)
    d2 = torch.as_tensor(_grid_distances(shape), device=X.device)
    if radius0 is None:
        radius0 = max(shape) / 2.0
    for it in range(n_iters):
        frac = it / max(n_iters - 1, 1)
        radius = radius0 * (radiusF / radius0) ** frac
        alpha = alpha0 * (0.01 / alpha0) ** frac
        bmu = _sqdist(X, code).argmin(dim=1)
        Hw = torch.exp(-d2 / (2 * radius ** 2))[bmu]          # (N, K)
        target = (Hw.T @ X) / (Hw.sum(dim=0)[:, None] + 1e-12)
        code = code + alpha * (target - code)
    return _result(X, code)


def kerdensom(X, shape=(4, 4), n_iters: int = 100, reg0: float = 1000.0,
              regF: float = 100.0, seed: int = 0, verbose: int = 0,
              annealing_steps: int = 0, eps: float = 1e-7,
              topology: str = "RECT", device=None):
    """Kernel-density SOM (the reference's kerdenSOM): soft
    responsibilities with annealed smoothness regularisation over the map
    graph. With annealing_steps > 0, the reference's deterministic
    annealing (kerdensom.cpp KerDenSOM::train): that many regularisation
    values geometrically spaced from reg0 to regF, each run to a relative
    code change below eps or n_iters inner iterations; reg0 = regF = 0 is
    kernel C-means. Returns (codebook, assignments) as numpy."""
    X = _data(X, device)
    N, D = X.shape
    K = shape[0] * shape[1]
    code = _initial_code(X, K, seed)
    d2 = _grid_distances(shape, topology)
    # graph Laplacian of the map grid (4/6-neighbourhood)
    Wg = (d2 < 1.0 + 1e-6).astype(np.float64) - np.eye(K)
    lap = torch.as_tensor(np.diag(Wg.sum(1)) - Wg, device=X.device)
    eye = torch.eye(K, dtype=torch.float64, device=X.device)
    sigma2 = float(X.var(unbiased=False)) + 1e-12

    def step(code, sigma2, reg):
        dist = _sqdist(X, code)
        r = torch.exp(-dist / (2 * sigma2))
        r = r / (r.sum(dim=1, keepdim=True) + 1e-300)
        # regularised M-step: (diag(Nk) + reg * Lap) code = r^T X
        A = torch.diag(r.sum(dim=0)) + reg * lap + 1e-9 * eye
        code = torch.linalg.solve(A, r.T @ X)
        return code, max(float((r * dist).sum()) / (N * D), 1e-12)

    def moved(code, prev):
        return float(torch.linalg.vector_norm(code - prev)), \
            float(torch.linalg.vector_norm(prev))

    if annealing_steps > 0:
        regs = (np.geomspace(max(reg0, 1e-12), max(regF, 1e-12),
                             annealing_steps)
                if reg0 > 0 and regF > 0 else np.zeros(annealing_steps))
        for si, reg in enumerate(regs):
            for _ in range(n_iters):
                prev = code
                code, sigma2 = step(code, sigma2, float(reg))
                delta, size = moved(code, prev)
                if delta / max(size, 1e-300) < eps:
                    break
            if verbose:
                print(f"  annealing step {si + 1}/{annealing_steps} "
                      f"reg={reg:.2f} sigma2={sigma2:.5f}")
    else:
        for it in range(n_iters):
            frac = it / max(n_iters - 1, 1)
            reg = reg0 * (regF / max(reg0, 1e-12)) ** frac
            prev = code
            code, sigma2 = step(code, sigma2, reg)
            delta, size = moved(code, prev)
            if delta < eps * max(size, 1e-300):
                break
            if verbose and (it + 1) % 20 == 0:
                print(f"  kerdensom iter {it + 1}: sigma2={sigma2:.5f} "
                      f"reg={reg:.1f}")
    return _result(X, code)


def batch_som(X, shape=(4, 4), n_epochs: int = 20,
              radius0: float | None = None, radiusF: float = 0.5,
              seed: int = 0, device=None):
    """Batch SOM (reference classification/batch_som): each epoch every
    code vector becomes the neighbourhood-weighted mean of all samples.
    Returns (codebook, assignments) as numpy."""
    X = _data(X, device)
    code = _initial_code(X, shape[0] * shape[1], seed)
    d2 = torch.as_tensor(_grid_distances(shape), device=X.device)
    if radius0 is None:
        radius0 = max(shape) / 2.0
    for it in range(n_epochs):
        frac = it / max(n_epochs - 1, 1)
        radius = radius0 * (radiusF / radius0) ** frac
        bmu = _sqdist(X, code).argmin(dim=1)
        Hw = torch.exp(-d2 / (2 * radius ** 2))[bmu]
        code = (Hw.T @ X) / (Hw.sum(dim=0)[:, None] + 1e-12)
    return _result(X, code)


def _fuzzy_round(X, U, m):
    """One fuzzy c-means round: the code book of memberships U and the new
    memberships."""
    Um = U ** m
    code = (Um.T @ X) / (Um.sum(dim=0)[:, None] + 1e-12)
    inv = (_sqdist(X, code) + 1e-12) ** (-1.0 / (m - 1.0))
    return code, inv / inv.sum(dim=1, keepdim=True)


def fcmeans(X, K: int = 4, m: float = 2.0, n_iters: int = 100,
            tol: float = 1e-5, seed: int = 0, device=None):
    """Fuzzy c-means (reference classification/fcmeans). Returns
    (codebook (K, D), memberships U (N, K)) as numpy."""
    X = _data(X, device)
    U = torch.as_tensor(np.random.default_rng(seed).dirichlet(
        np.ones(K), len(X)), device=X.device)
    code = None
    for _ in range(n_iters):
        code, Unew = _fuzzy_round(X, U, m)
        done = float((Unew - U).abs().max()) < tol
        U = Unew
        if done:
            break
    return code.cpu().numpy(), U.cpu().numpy()


def fuzzy_som(X, shape=(4, 4), m0: float = 2.0, mF: float = 1.02,
              n_iters: int = 60, seed: int = 0, device=None):
    """Fuzzy SOM / FKCN (reference fuzzy_som, fkcn): fuzzy c-means whose
    fuzziness exponent anneals m0 -> mF. Returns (codebook, memberships)
    as numpy."""
    X = _data(X, device)
    K = shape[0] * shape[1]
    U = torch.as_tensor(np.random.default_rng(seed).dirichlet(
        np.ones(K), len(X)), device=X.device)
    code = None
    for it in range(n_iters):
        frac = it / max(n_iters - 1, 1)
        m = max(m0 * (mF / m0) ** frac, 1.01)
        code, U = _fuzzy_round(X, U, m)
    return code.cpu().numpy(), U.cpu().numpy()


class CodeBook:
    """Vector code book with per-unit assignment bookkeeping (reference
    classification/code_book; the fuzzy variant keeps the membership
    matrix). The vectors live on `device` (default: the card)."""

    def __init__(self, vectors, memberships=None, device=None):
        self.vectors = _data(vectors, device)
        self.memberships = None if memberships is None else \
            np.asarray(memberships, np.float64)

    def _d2(self, X):
        return _sqdist(as_tensor(X, self.vectors.device, torch.float64),
                       self.vectors)

    def assign(self, X):
        return self._d2(X).argmin(dim=1).cpu().numpy()

    def quantization_error(self, X):
        return float(torch.sqrt(self._d2(X).min(dim=1).values).mean())

    def histogram(self, X):
        return np.bincount(self.assign(X), minlength=len(self.vectors))
