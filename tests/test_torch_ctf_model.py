"""models/ctf_estimation.py of the port, its model and fitness, against the
reference package on the CPU; and the compass search's rounds, which never
wait for the host.

Held to: the model's noise and signal halves and the clamped model PSD at
random parameter vectors around a realistic point (with and without the
phase plate) to 1e-5 of each half's max; the weighted Pearson
correlation and the fitness, single and batched, with and without the
enhanced-PSD term, to 1e-5 absolute (the fitness is O(1)); the seeded
per-PSD defocus refinement of 4 PSDs within 0.5 % of the reference's
defocus. The model evaluates sin, cos, exp and the polynomial J0 of
arguments up to ~80 rad in float32 in both packages, so an argmin among
near-equal candidates may differ by an ulp: functions are held tightly,
searches loosely.
"""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import synthetic_psd
from xmipp3_tpu.models import ctf_estimation as jce
from xmipp3_tpu_torch.models import ctf_estimation as ce

torch.set_num_threads(1)
N, TS = 128, 1.5


def _point(vpp: bool) -> np.ndarray:
    """A realistic parameter vector: every envelope and background term on."""
    p = np.zeros(ce.NPARAMS, np.float32)
    p[[ce.DEFU, ce.DEFV, ce.ANGLE, ce.LOGK]] = [17500, 14500, 40, 0.1]
    p[[ce.ESPR, ce.ALPHA, ce.DELTAF, ce.DELTAR, ce.ENVR1, ce.ENVR2]] = \
        [1.0, 2e-4, 30.0, 2.0, 0.01, 0.02]
    p[ce.BASE:ce.SQANG + 1] = [0.1, 3.0, 12.0, 14.0, 20.0]
    p[ce.G1K:ce.G1CV + 1] = [1.5, 8000, 9000, 10, 0.02, 0.022]
    p[ce.G2K:ce.G2CV + 1] = [0.3, 6000, 7000, 30, 0.25, 0.27]
    p[ce.PHASE_SHIFT] = 0.5 if vpp else 0.0
    return p


def _around(p, k, seed):
    rng = np.random.default_rng(seed)
    return (p[None] * (1 + 0.02 * rng.standard_normal((k, ce.NPARAMS)))
            ).astype(np.float32)


def _consts(vpp: bool):
    return (300.0, 2.7, 2.0, 0.07, 0.05 if vpp else 0.0)


@pytest.mark.parametrize("vpp", [False, True])
def test_model_halves_and_psd_match_the_reference(vpp):
    fy, fx = jce._freq_grids(N, TS)
    consts = _consts(vpp)
    P = _around(_point(vpp), 6, seed=1)
    noise, signal = ce._model_parts(torch.as_tensor(P), torch.as_tensor(fy),
                                    torch.as_tensor(fx), N, consts)
    model = ce._model_psd(torch.as_tensor(P), torch.as_tensor(fy),
                          torch.as_tensor(fx), N, consts)
    assert noise.shape == (6, N, N // 2 + 1)
    for k, p in enumerate(P):
        want = jce._model_parts(jnp.asarray(p), jnp.asarray(fy),
                                jnp.asarray(fx), N, consts)
        for got, ref in zip((noise[k], signal[k]), want):
            ref = np.asarray(ref)
            assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
        ref = np.asarray(jce._model_psd(jnp.asarray(p), jnp.asarray(fy),
                                        jnp.asarray(fx), N, consts))
        assert np.abs(model[k].numpy() - ref).max() <= 1e-5 * ref.max()


@pytest.fixture(scope="module")
def fit_inputs():
    """An n=128 synthetic PSD in the estimator's flat band layout, the
    full-plane grids and band, and the enhanced PSD."""
    psd, _ = synthetic_psd(N, TS)
    fy, fx = jce._freq_grids(N, TS)
    r = np.sqrt((fy * TS) ** 2 + (fx * TS) ** 2)
    band = ((r >= 0.03) & (r <= 0.35)).astype(np.float32)
    enh = jce.CTFEstimator._enhanced_half(psd, 0.02, 0.15)
    full = lambda a: np.broadcast_to(a, psd.shape).ravel()
    return dict(psd=psd, fy=fy, fx=fx, band=band, enh=enh,
                flat=[torch.as_tensor(full(a).copy())
                      for a in (psd, fy, fx, band, enh)])


@pytest.mark.parametrize("use_enh", [False, True])
@pytest.mark.parametrize("vpp", [False, True])
def test_fitness_matches_the_reference(fit_inputs, use_enh, vpp):
    d = fit_inputs
    consts = _consts(vpp)
    P = _around(_point(vpp), 24, seed=2)
    jenh = (jnp.asarray(d["enh"]), 0.8) if use_enh else None
    want = np.asarray(jce._fitness_batch(
        jnp.asarray(P), jnp.asarray(d["psd"]), jnp.asarray(d["fy"]),
        jnp.asarray(d["fx"]), jnp.asarray(d["band"]), N, consts, jenh))
    psd, fy, fx, band, enh = d["flat"]
    tenh = (enh, 0.8) if use_enh else None
    got = ce._fitness_batch(torch.as_tensor(P), psd, fy, fx, band, N, consts,
                            tenh)
    assert np.abs(got.numpy() - want).max() <= 1e-5
    one = ce._fitness(torch.as_tensor(P[3]), psd, fy, fx, band, N, consts,
                      tenh)
    assert one.ndim == 0 and abs(float(one) - want[3]) <= 1e-5
    # the lockstep form: two estimates share nothing but the grid
    got2 = ce._fitness_lockstep(np.stack([P, P[::-1]]),
                                torch.stack([psd, psd]), fy, fx,
                                torch.stack([band, band]), N, consts)
    if not use_enh:
        assert np.abs(got2[0].numpy() - want).max() <= 1e-5
        assert np.abs(got2[1].numpy() - want[::-1]).max() <= 1e-5


def test_masked_pearson_matches_the_reference():
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((2, 500)).astype(np.float32)
    w = (rng.random(500) < 0.6).astype(np.float32)
    want = float(jce._masked_pearson(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(w)))
    got = ce._masked_pearson(torch.as_tensor(a), torch.as_tensor(b),
                             torch.as_tensor(w))
    assert abs(float(got) - want) <= 1e-6


def test_refine_defocus_batch_matches_the_reference():
    """Four PSDs of defoci 10-14 % away from one seed: each refined
    defocus within 0.5 % of the reference's."""
    truths = [(9000, 8000, 30), (9500, 8200, 35), (10200, 9100, 25),
              (8700, 7600, 40)]
    psds = np.stack([synthetic_psd(N, TS, u, v, a, seed=5 + k)[0]
                     for k, (u, v, a) in enumerate(truths)])
    seed = _point(False)
    seed[[ce.DEFU, ce.DEFV, ce.ANGLE, ce.LOGK]] = [9300, 8300, 32, 0.0]
    seed[ce.G2K] = 0.0
    want = jce.refine_defocus_batch(psds, seed, TS)
    got = ce.refine_defocus_batch(psds, seed, TS, device="cpu")
    assert got.shape == (4, ce.NPARAMS)
    for k in range(4):
        for i in (ce.DEFU, ce.DEFV):
            assert abs(got[k, i] - want[k, i]) <= 5e-3 * abs(want[k, i]), \
                (k, i, got[k, i], want[k, i])


_SYNCS = ("item", "tolist", "numpy", "cpu", "__bool__", "__float__",
          "__int__", "__index__")


def test_compass_rounds_never_wait_for_the_host(fit_inputs):
    """Every method that brings a tensor's value to the host raises while
    the compass runs its rounds, and the search still ends where it ends
    unwatched (on the card, tests/test_torch_kernels.py runs it under
    torch.cuda's sync debug mode)."""
    psd, fy, fx, band, enh = fit_inputs["flat"]
    data = ce._FitData(psd, fy, fx, band, _consts(False), (enh, 1.0))
    P0 = torch.as_tensor(_around(_point(False), 3, seed=4))
    free = tuple(ce.STAGE_SETS["envelope"])
    steps = ce.CTFEstimator._STEPS[list(free)]
    mirror = ((ce.SQV, ce.SQU),)
    want = ce._compass_loop(P0, steps, data.costs, free, 9, mirror)
    calls = []

    def watch(name):
        def refuse(*a, **k):
            calls.append(name)
            raise AssertionError(f"Tensor.{name} inside the compass rounds")
        return refuse

    patches = [mock.patch.object(torch.Tensor, name, watch(name))
               for name in _SYNCS]
    for p in patches:
        p.start()
    try:
        got = ce._compass_loop(P0, steps, data.costs, free, 9, mirror)
    finally:
        for p in patches:
            p.stop()
    assert calls == []
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(got[0], P0)
