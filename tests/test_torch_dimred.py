"""pca, empca and pca_zscores of the port (xmipp3_tpu_torch.models.dimred)
against the reference package's on the CPU.

The port's pca takes the top-d subspace from a float64 eigendecomposition
of the smaller Gram matrix instead of a full SVD: projections and
components agree with the reference's to 1e-8 of their max once each
axis's sign is aligned, the means exactly and the explained variances to
1e-10 relative, in both the N <= D and the N > D branch. EM-PCA runs its
float32 products as the reference does: projections (signs aligned) and
z-scores <= 1e-4 of their max."""
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
