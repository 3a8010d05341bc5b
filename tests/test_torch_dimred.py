"""The dimension reductions of the port (xmipp3_tpu_torch.models.dimred)
against the reference package's on the CPU.

The port's pca takes the top-d subspace from a float64 eigendecomposition
of the smaller Gram matrix instead of a full SVD: projections and
components agree with the reference's to 1e-8 of their max once each
axis's sign is aligned, the means exactly and the explained variances to
1e-10 relative, in both the N <= D and the N > D branch. EM-PCA runs its
float32 products as the reference does: projections (signs aligned) and
z-scores <= 1e-4 of their max.

The other reductions on a noisy 3-D spiral (N=60, D=10), each embedding
held to the reference's up to each axis's sign:
- the float64 ones 1e-6 of the max (the generalized eigenproblems go
  through a Cholesky or diagonal reduction where scipy solves them
  directly; read 1e-9 at worst, LLE);
- NCA (float32 gradient steps, as the reference's) 1e-5;
- GPLVM (float32 Adam): 1e-4 after 30 steps; after its 100 default steps
  5e-2, because the reference itself moves 9e-3 when its input moves by
  1e-7 relative (Adam's normalised steps follow the sign of near-zero
  gradients);
- IncrementalPCA's projections (both branches: exact moments and the
  sketch) 1e-8, the intrinsic dimension estimates 1e-10 relative."""
import numpy as np
import pytest
import torch

from test_torch_common import rel_err
from xmipp3_tpu.models import dimred as jdr
from xmipp3_tpu_torch.models import dimred as tdr

torch.set_num_threads(1)


def _data(N, D, seed=0):
    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((4, D))
    return (rng.standard_normal((N, 4)) * [5.0, 3.0, 2.0, 1.0]) @ basis \
        + 0.05 * rng.standard_normal((N, D)) + 1.5


def _aligned(got, want):
    """got's columns with the sign that matches want's."""
    s = np.sign((got * want).sum(axis=0))
    return got * np.where(s == 0, 1, s)


@pytest.mark.parametrize("N,D", [(30, 64), (80, 12)])
def test_pca_matches_the_reference(N, D):
    X = _data(N, D)
    Yj, mj = jdr.pca(X, d=3, return_model=True)
    Yt, mt = tdr.pca(X, d=3, return_model=True, device="cpu")
    assert rel_err(_aligned(Yt, Yj), Yj) <= 1e-8
    assert rel_err(_aligned(mt["components"].T, mj["components"].T),
                   mj["components"].T) <= 1e-8
    assert np.allclose(mt["mean"], mj["mean"], rtol=0, atol=1e-12)
    assert rel_err(mt["explained"], mj["explained"]) <= 1e-10
    assert rel_err(_aligned(tdr.pca(X, d=2, device="cpu"), Yj[:, :2]),
                   Yj[:, :2]) <= 1e-8


def test_empca_and_zscores_match_the_reference():
    X = _data(40, 50, seed=1)
    pj, bj, muj = jdr.empca(X, d=3, return_basis=True)
    pt, bt, mut = tdr.empca(X, d=3, return_basis=True, device="cpu")
    assert rel_err(_aligned(pt, pj), pj) <= 1e-4
    assert rel_err(_aligned(bt.T, bj.T), bj.T) <= 1e-4
    assert np.array_equal(mut, muj)
    zj = jdr.pca_zscores(X, d=3)
    zt = tdr.pca_zscores(X, d=3, device="cpu")
    assert rel_err(zt, zj) <= 1e-4


def _spiral(N=60, D=10, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 3 * np.pi, N)
    return np.stack([np.cos(t), np.sin(t), t / 3]
                    + [0.05 * rng.standard_normal(N) for _ in range(D - 3)],
                    axis=1)


REDUCTIONS = {"pPCA": {}, "kPCA": {}, "LE": {}, "LPP": {}, "LLE": {},
              "LTSA": {}, "DM": {"t": 2}, "Sammon": {}, "NPE": {},
              "LLTSA": {}, "HLLE": {}, "SPE": {"n_iters": 3000},
              "NCA": {}, "GPLVM": {"n_iters": 30}, "LE_sigma":
              {"sigma": 0.7, "k": 6}, "DM_sigma": {"sigma": 0.8}}


@pytest.mark.parametrize("method", list(REDUCTIONS))
def test_reduction_matches_the_reference(method):
    X = _spiral()
    name = method.split("_")[0]
    want = np.asarray(jdr.reduce_dimensionality(X, name, 2,
                                                **REDUCTIONS[method]))
    got = tdr.reduce_dimensionality(X, name, 2, device="cpu",
                                    **REDUCTIONS[method])
    tol = 1e-5 if name == "NCA" else 1e-4 if name == "GPLVM" else 1e-6
    assert got.shape == want.shape
    assert rel_err(_aligned(got, want), want) <= tol


def test_gplvm_default_steps_match_the_reference():
    X = _spiral()
    want = jdr.gplvm(X, 2)
    assert rel_err(_aligned(tdr.gplvm(X, 2, device="cpu"), want), want) \
        <= 5e-2


@pytest.mark.parametrize("D", [12, 5000])
def test_incremental_pca_matches_the_reference(D):
    X = _data(45, D, seed=2)
    ij, it = jdr.IncrementalPCA(3), tdr.IncrementalPCA(3, device="cpu")
    for k in range(3):
        ij.partial_fit(X[15 * k:15 * (k + 1)])
        it.partial_fit(X[15 * k:15 * (k + 1)])
    want = ij.transform(X)
    assert np.allclose(it.mean, ij.mean, rtol=0, atol=1e-12)
    assert rel_err(_aligned(it.transform(X), want), want) <= 1e-8


@pytest.mark.parametrize("method", ["CorrDim", "MLE"])
@pytest.mark.parametrize("normalize", [True, False])
def test_intrinsic_dimensionality_matches_the_reference(method, normalize):
    X = _spiral(80)
    want = jdr.intrinsic_dimensionality(X, method, normalize)
    got = tdr.intrinsic_dimensionality(X, method, normalize, device="cpu")
    assert abs(got - want) <= 1e-10 * abs(want)


def test_unknown_method_is_refused():
    with pytest.raises(ValueError):
        tdr.reduce_dimensionality(_spiral(), "tSNE", 2, device="cpu")
