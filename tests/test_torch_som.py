"""The SOM family of the port (xmipp3_tpu_torch.models.som) against the
reference package's on the CPU, with the same numpy seeds: som, kerdensom
(the regularisation schedule, deterministic annealing, kernel C-means,
HEXA), batch_som, fcmeans, fuzzy_som and CodeBook. Code books and
memberships <= 1e-4 of their max, assignments equal (float64 on both
sides)."""
import numpy as np
import pytest
import torch

from test_torch_common import rel_err
from xmipp3_tpu.models import som as jsom
from xmipp3_tpu_torch.models import som as tsom

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def X():
    rng = np.random.default_rng(0)
    return np.concatenate([rng.normal(0, 0.4, (60, 5)),
                           rng.normal(3, 0.4, (60, 5)),
                           rng.normal((0, 3, 0, 3, 0), 0.4, (40, 5))])


def _hold(got, want):
    for g, w in zip(got, want):
        if np.issubdtype(np.asarray(w).dtype, np.integer):
            assert np.array_equal(g, w)
        else:
            assert rel_err(g, w) <= 1e-4


@pytest.mark.parametrize("name,kw", [
    ("som", dict(shape=(2, 3), n_iters=50)),
    ("kerdensom", dict(shape=(3, 3), n_iters=40, reg0=10, regF=0.1)),
    ("kerdensom", dict(shape=(3, 3), n_iters=20, annealing_steps=3,
                       reg0=100, regF=1)),
    ("kerdensom", dict(shape=(2, 2), n_iters=20, annealing_steps=2,
                       reg0=0, regF=0)),
    ("kerdensom", dict(shape=(3, 3), n_iters=30, reg0=50, regF=5,
                       topology="HEXA")),
    ("batch_som", dict(shape=(2, 3), n_epochs=10)),
    ("fcmeans", dict(K=3, n_iters=50)),
    ("fuzzy_som", dict(shape=(2, 2), n_iters=30)),
], ids=["som", "kerdensom", "annealing", "kernel_cmeans", "hexa",
        "batch_som", "fcmeans", "fuzzy_som"])
def test_som_variants_match_the_reference(X, name, kw):
    want = getattr(jsom, name)(X, seed=3, **kw)
    got = getattr(tsom, name)(X, seed=3, device="cpu", **kw)
    _hold(got, want)


def test_grid_distances_match_the_reference():
    for topo in ("RECT", "HEXA"):
        assert np.array_equal(tsom._grid_distances((3, 4), topo),
                              jsom._grid_distances((3, 4), topo))


def test_codebook_matches_the_reference(X):
    code, U = jsom.fuzzy_som(X, (2, 2), n_iters=20)
    cj, ct = jsom.CodeBook(code, U), tsom.CodeBook(code, U, device="cpu")
    assert np.array_equal(ct.assign(X), cj.assign(X))
    assert np.array_equal(ct.histogram(X), cj.histogram(X))
    assert ct.quantization_error(X) == pytest.approx(
        cj.quantization_error(X), rel=1e-12)
    assert np.array_equal(ct.memberships, cj.memberships)
