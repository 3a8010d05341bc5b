"""The port's ops/optim.py and models/svm.py against the reference
package's, on the CPU, on numpy-seeded inputs.

Tolerances:
- adam_scan on a quadratic with a vector learning rate, and on the hinge
  loss: x and the final loss 1e-5 relative to their max (float32 Adam
  steps in both packages; the gradients agree to roundoff);
- trust_region_dfo: the same minimiser as the reference to 1e-6 (both
  are scipy's COBYQA on the same float64 objective); an error raised
  inside the objective propagates, and only SciPy's "Unknown solver"
  error falls back to Powell, with a warning that names it;
- LinearSVM and RBFSVM: the standardisation equal, gamma and the random
  features' W and b equal (the same float64 host code and numpy draws),
  the weights 1e-4 of their max (300-400 float32 Adam steps), the same
  predictions on the training set;
- a model saved by either package loads in the other with the same keys
  and gives the same decisions to 1e-12 (host float64 on the same
  arrays);
- GaussianNB: equal (host numpy in both);
- particle_features: 1e-4 of the features' max (the port's polar
  resampling against the reference's).
"""
import warnings

import numpy as np
import pytest
import scipy.optimize
import torch

import jax.numpy as jnp
from xmipp3_tpu.models import svm as jsvm
from xmipp3_tpu.ops import optim as joptim
from xmipp3_tpu_torch.models import svm as tsvm
from xmipp3_tpu_torch.ops import optim as toptim

torch.set_num_threads(1)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def blobs():
    """Two overlapping Gaussian clouds in 12 dimensions (0/1 labels)."""
    rng = np.random.default_rng(5)
    X = np.concatenate([rng.normal(0.0, 1.0, (60, 12)),
                        rng.normal(0.7, 1.2, (50, 12))]).astype(np.float32)
    y = np.concatenate([np.zeros(60), np.ones(50)])
    return X, y


def test_adam_scan_on_a_quadratic_with_a_vector_rate():
    rng = np.random.default_rng(0)
    t = rng.normal(size=(4, 6)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (4, 6)).astype(np.float32)
    x0 = np.zeros((4, 6), np.float32)
    lr = np.float32([0.05, 0.1, 0.02, 0.2])
    jx, jl = joptim.adam_scan(
        lambda x: jnp.sum((x - t) ** 2 * w), x0, 120, lr)
    tt, tw = torch.as_tensor(t), torch.as_tensor(w)
    x, l = toptim.adam_scan(lambda x: torch.sum((x - tt) ** 2 * tw), x0,
                            120, lr, device="cpu")
    assert rel(x.numpy(), jx) <= 1e-5
    assert rel(float(l), float(jl)) <= 1e-5


def test_adam_scan_on_the_hinge_loss(blobs):
    X, y = blobs
    yy = np.where(y > 0, 1.0, -1.0).astype(np.float32)

    def loss(p, xp, mx, X, yy):
        w, b = p[:-1], p[-1]
        return 0.5 * (w @ w) / len(yy) + mx(0.0 * b, 1.0 - yy * (X @ w + b)
                                            ).mean()
    p0 = np.zeros(X.shape[1] + 1, np.float32)
    jp, jl = joptim.adam_scan(
        lambda p: loss(p, jnp, jnp.maximum, jnp.asarray(X),
                       jnp.asarray(yy)), p0, 200, 0.05)
    tX, ty = torch.as_tensor(X), torch.as_tensor(yy)
    tp, tl = toptim.adam_scan(
        lambda p: loss(p, torch, torch.maximum, tX, ty), p0, 200, 0.05,
        device="cpu")
    assert rel(tp.numpy(), jp) <= 1e-5
    assert rel(float(tl), float(jl)) <= 1e-5


def test_trust_region_dfo_matches_the_reference():
    c = np.array([0.3, -1.2, 2.0])
    f = lambda x: float(np.sum((x - c) ** 2) + 0.1 * np.sum(x ** 4))
    jx, jf = joptim.trust_region_dfo(f, np.zeros(3), max_nfev=200)
    with warnings.catch_warnings():
        warnings.simplefilter("error")         # COBYQA ran: no warning
        x, fx = toptim.trust_region_dfo(f, np.zeros(3), max_nfev=200)
    np.testing.assert_allclose(x, jx, atol=1e-6)
    assert abs(fx - jf) <= 1e-6


def test_trust_region_dfo_raises_what_the_objective_raises():
    def f(x):
        raise RuntimeError("launch failed")
    with pytest.raises(RuntimeError, match="launch failed"):
        toptim.trust_region_dfo(f, np.zeros(2))


def test_trust_region_dfo_falls_back_to_powell_without_cobyqa(monkeypatch):
    real = scipy.optimize.minimize

    def minimize(fun, x0, method=None, **kw):
        if method == "COBYQA":
            raise ValueError(f"Unknown solver {method}")
        return real(fun, x0, method=method, **kw)
    monkeypatch.setattr(scipy.optimize, "minimize", minimize)
    f = lambda x: float(np.sum((x - 1.5) ** 2))
    with pytest.warns(RuntimeWarning, match="no COBYQA; ran Powell"):
        x, fx = toptim.trust_region_dfo(f, np.zeros(2))
    np.testing.assert_allclose(x, 1.5, atol=1e-3)


@pytest.mark.parametrize("kind", ["linear", "rbf"])
def test_svm_fit_matches_the_reference(blobs, kind):
    X, y = blobs
    if kind == "linear":
        j = jsvm.LinearSVM().fit(X, y)
        t = tsvm.LinearSVM(device="cpu").fit(X, y)
        jin, tin = j, t
    else:
        j = jsvm.RBFSVM().fit(X, y)
        t = tsvm.RBFSVM(device="cpu").fit(X, y)
        assert t.gamma == j.gamma
        np.testing.assert_array_equal(t.W, j.W)
        np.testing.assert_array_equal(t.b, j.b)
        jin, tin = j.inner, t.inner
    np.testing.assert_array_equal(tin._mu, jin._mu)
    np.testing.assert_array_equal(tin._sd, jin._sd)
    assert rel(np.append(tin.w, tin.b), np.append(jin.w, jin.b)) <= 1e-4
    np.testing.assert_array_equal(t.predict(X), j.predict(X))


def test_median_sq_distance_is_the_references_median():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(70, 5))
    X[3] = X[4]                      # a zero distance that the median skips
    d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    assert tsvm.median_sq_distance(X, rows=16) == np.median(d2[d2 > 0])
    assert tsvm.median_sq_distance(np.ones((3, 2))) == 1.0


@pytest.mark.parametrize("kind", ["linear", "rbf"])
@pytest.mark.parametrize("trained_by", ["port", "reference"])
def test_a_model_loads_in_the_other_package(blobs, tmp_path, kind,
                                            trained_by):
    X, y = blobs
    cls = {"linear": "LinearSVM", "rbf": "RBFSVM"}[kind]
    train, load = (tsvm, jsvm) if trained_by == "port" else (jsvm, tsvm)
    kw = {"device": "cpu"} if train is tsvm else {}
    model = getattr(train, cls)(**kw).fit(X, y)
    fn = str(tmp_path / "model")
    model.save(fn)
    keys = set(np.load(fn + ".npz").files)
    assert keys == ({"w", "b", "mu", "sd", "C"} if kind == "linear" else
                    {"kind", "W", "b", "gamma", "w", "bias", "mu", "sd"})
    other = getattr(load, cls).load(fn)
    np.testing.assert_allclose(other.decision(X), model.decision(X),
                               rtol=0, atol=1e-12)


def test_gaussian_nb_equals_the_reference(blobs, tmp_path):
    X, y = blobs
    j = jsvm.GaussianNB().fit(X, y)
    t = tsvm.GaussianNB().fit(X, y)
    np.testing.assert_array_equal(t.log_proba(X), j.log_proba(X))
    t.save(str(tmp_path / "nb"))
    back = jsvm.GaussianNB.load(str(tmp_path / "nb.npz"))
    np.testing.assert_array_equal(back.predict(X), t.predict(X))


def test_particle_features_match_the_reference():
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[:24, :24] - 12.0
    disc = (yy ** 2 + xx ** 2 < 36).astype(np.float32)
    boxes = disc[None] * rng.uniform(0.5, 2, (10, 1, 1)) \
        + 0.3 * rng.standard_normal((10, 24, 24))
    boxes = boxes.astype(np.float32)
    want = jsvm.particle_features(boxes)
    got = tsvm.particle_features(boxes, device="cpu")
    assert got.shape == want.shape
    assert rel(got, want) <= 1e-4
