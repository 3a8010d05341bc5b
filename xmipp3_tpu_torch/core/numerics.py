"""Dense linear-algebra toolkit mirroring the reference Matrix2D helpers;
the port's own copy of the reference package's core/numerics.py.

Reference: xmippCore core/matrix2d.{h,cpp} (solveLinearSystem via
PseudoInverseHelper, ransacWeightedLeastSquares, schur, generalizedEigs,
firstEigs/lastEigs, connectedComponentsOfUndirectedGraph), exercised by
applications/tests/function_tests/test_matrix_main.cpp whose embedded
expected values pin tests/test_golden_matrix.py.

These run on the host (numpy/scipy): they are O(n^3) on tiny matrices
used for model fitting and spectral embeddings, not device-scale compute.
"""
from __future__ import annotations

import numpy as np


def solve_linear_system(A, b, w=None):
    """Least-squares solution of A x = b (reference solveLinearSystem:
    x = pseudoinverse(A) b; the weighted variant scales rows by sqrt(w))."""
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    if w is not None:
        sw = np.sqrt(np.asarray(w, np.float64))
        A = A * sw[:, None]
        b = b * sw
    x, *_ = np.linalg.lstsq(A, b, rcond=None)
    return x


def ransac_weighted_least_squares(A, b, w, tol, n_iter=10000,
                                  outlier_fraction=0.5, seed=0):
    """RANSAC around weighted least squares (reference
    ransacWeightedLeastSquares, test_matrix_main.cpp RANSAC): sample
    minimal row subsets, fit, count inliers |Ax-b| < tol, refit the best
    consensus set with the full weighted LSQ.

    All candidate fits are solved in one batched lstsq-equivalent sweep
    (pinv of stacked minimal systems) instead of a Python loop per trial.
    """
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    w = np.ones(len(b)) if w is None else np.asarray(w, np.float64)
    n, p = A.shape
    rng = np.random.default_rng(seed)
    n_trials = min(n_iter, 4096)
    idx = rng.integers(0, n, size=(n_trials, p))
    As = A[idx]                                   # (T, p, p)
    bs = b[idx]                                   # (T, p)
    # batched solve; singular samples fall back to pinv
    try:
        xs = np.linalg.solve(As, bs[..., None])[..., 0]
    except np.linalg.LinAlgError:
        xs = np.einsum("tij,tj->ti", np.linalg.pinv(As), bs)
    resid = np.abs(A @ xs.T - b[:, None])         # (n, T)
    # LMedS scoring: a candidate is judged by its median absolute
    # residual, which ignores up to 50% outliers entirely — inlier
    # counting at `tol` would let outliers that straddle the line bias
    # the consensus refit.
    score = np.median(resid, axis=0)
    best = int(np.argmin(score))
    r_best = resid[:, best]
    mad = 1.4826 * np.median(np.abs(r_best - np.median(r_best)))
    thr = min(tol, max(2.5 * mad, 1e-9))
    mask = r_best <= thr
    if mask.sum() < p:
        mask = r_best <= tol
    if mask.sum() < p:
        mask = np.ones(n, bool)
    return solve_linear_system(A[mask], b[mask], w[mask])


def schur_decomposition(A):
    """Real Schur A = O T O^T with T quasi-upper-triangular
    (reference schur, wraps the same LAPACK dgees family)."""
    import scipy.linalg
    T, O = scipy.linalg.schur(np.asarray(A, np.float64), output="real")
    return O, T


def generalized_eigs(A, B):
    """Symmetric-definite generalized eigenproblem A v = lambda B v,
    eigenvalues ascending, B-orthonormal eigenvectors (reference
    generalizedEigs)."""
    import scipy.linalg
    D, P = scipy.linalg.eigh(np.asarray(A, np.float64),
                             np.asarray(B, np.float64))
    return D, P


def first_eigs(A, m):
    """Largest-m eigenpairs of symmetric A, eigenvalues descending
    (reference firstEigs — used by pca.cpp/lpp.cpp)."""
    D, P = np.linalg.eigh(np.asarray(A, np.float64))
    order = np.argsort(D)[::-1][:m]
    return D[order], P[:, order]


def last_eigs(A, m):
    """Smallest-m eigenpairs of symmetric A, eigenvalues ascending
    (reference lastEigs — used by laplacianEigenmaps.cpp/npe.cpp)."""
    D, P = np.linalg.eigh(np.asarray(A, np.float64))
    order = np.argsort(D)[:m]
    return D[order], P[:, order]


def connected_components_undirected(A, threshold: float = 0.0):
    """Component label per node of the graph whose edges are A[i,j] >
    threshold (reference connectedComponentsOfUndirectedGraph). Labels
    count up from 0 in first-seen node order."""
    A = np.asarray(A)
    n = A.shape[0]
    adj = (A > threshold) | (A.T > threshold)
    labels = np.full(n, -1, np.int64)
    comp = 0
    for start in range(n):
        if labels[start] >= 0:
            continue
        frontier = np.zeros(n, bool)
        frontier[start] = True
        seen = frontier.copy()
        while frontier.any():
            frontier = (adj[frontier].any(axis=0)) & ~seen
            seen |= frontier
        labels[seen] = comp
        comp += 1
    return labels
