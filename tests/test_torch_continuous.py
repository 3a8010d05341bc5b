"""ops/continuous.py of the port against the reference package's, on the
CPU (N=32, the 8-blob phantom, 12 particles 3-6 degrees and 1-2 px off
their true poses, with noise).

Tolerances:
- each loss against the reference's at the same parameters: the port
  returns the SUM of the per-particle losses and the reference the mean,
  so the port's value and gradient are held to B times the reference's,
  1e-4 relative (the values) and 1e-4 of the largest component (each
  parameter's gradient row);
- a few Adam steps against the reference's scan (continuous_assign,
  continuous_assign_full with CTF, gray and scale): poses 2e-3 degrees,
  shifts 2e-4 px, the other parameters 1e-4 relative, costs 1e-4;
- chunking the particle set: equal to one batch, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_project import phantom8
from xmipp3_tpu.ops import continuous as jc
from xmipp3_tpu.ops.project import prepare_fourier_volume as jax_prepare
from xmipp3_tpu_torch.ops import continuous as tc
from xmipp3_tpu_torch.ops.project import (FourierProjector,
                                          prepare_fourier_volume)

torch.set_num_threads(1)

N, B = 32, 12
CTF = dict(defU0=np.linspace(15000, 20000, B).astype(np.float32),
           defV0=np.linspace(14000, 19000, B).astype(np.float32),
           def_ang=np.linspace(0, 90, B).astype(np.float32), Ts=2.0)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(5)
    vol = phantom8(N)
    rot = rng.uniform(0, 360, B).astype(np.float32)
    tilt = rng.uniform(20, 160, B).astype(np.float32)
    psi = rng.uniform(0, 360, B).astype(np.float32)
    sx, sy = rng.uniform(-2, 2, (2, B)).astype(np.float32)
    imgs = FourierProjector(vol, device="cpu").project_euler(
        rot, tilt, psi, shifts=np.stack([-sx, -sy], 1)).numpy()
    imgs += 0.05 * imgs.std() * rng.standard_normal(imgs.shape).astype(
        np.float32)
    d = lambda s: rng.uniform(-s, s, B).astype(np.float32)
    init = dict(rot0=rot + d(6), tilt0=tilt + d(4), psi0=psi + d(5),
                sx0=sx + d(1.5), sy0=sy + d(1.5))
    return dict(vol=vol, imgs=imgs, init=init,
                truth=dict(rot=rot, tilt=tilt, psi=psi, sx=sx, sy=sy))


def _params(case, k):
    i = case["init"]
    base = [i["rot0"], i["tilt0"], i["psi0"], -i["sx0"], -i["sy0"]]
    rng = np.random.default_rng(9)
    extra = [1 + rng.uniform(-0.01, 0.01, B), 1 + rng.uniform(-0.03, 0.03, B),
             rng.uniform(-0.1, 0.1, B), rng.uniform(-200, 200, B),
             rng.uniform(-200, 200, B)]
    return [np.asarray(a, np.float32) for a in (base + extra)[:k]]


def _grads_t(fn, params):
    ps = [torch.tensor(p, requires_grad=True) for p in params]
    loss, aux = fn(tuple(ps))
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    return (float(loss.detach()), aux.detach().numpy(),
            [np.zeros(B, np.float32) if g is None else g.numpy()
             for g in grads])


def _hold(case, jax_fn, torch_fn, k):
    params = _params(case, k)
    (lj, auxj), gj = jax_fn(tuple(jnp.asarray(p) for p in params))
    lt, auxt, gt = _grads_t(torch_fn, params)
    assert abs(lt - B * float(lj)) <= 1e-4 * abs(B * float(lj))
    np.testing.assert_allclose(auxt, np.asarray(auxj), rtol=0,
                               atol=1e-4 * np.abs(auxj).max())
    for n, (a, b) in enumerate(zip(gt, gj)):
        want = B * np.asarray(b)
        if np.abs(want).max() == 0:
            assert np.abs(a).max() == 0, n
            continue
        assert np.abs(a - want).max() <= 1e-4 * np.abs(want).max(), n


def _vf(case):
    vf_j, _ = jax_prepare(jnp.asarray(case["vol"]), 2.0)
    vf_t, _ = prepare_fourier_volume(case["vol"], 2.0, "cpu")
    return vf_j, vf_t


def test_ncc_loss_and_gradient_match_the_reference(case):
    vf_j, vf_t = _vf(case)
    imgs = case["imgs"]
    _hold(case, lambda p: jc._loss_grad(p, vf_j, jnp.asarray(imgs), N, 0.35),
          lambda p: tc._ncc_loss(p, vf_t, torch.as_tensor(imgs), N, 0.35), 5)


@pytest.mark.parametrize("weights", [False, True])
def test_wavelet_loss_and_gradient_match_the_reference(case, weights):
    vf_j, vf_t = _vf(case)
    imgs = case["imgs"]
    spec_t, real_t = tc._weight_masks(N, 0.3, 0.4, 0.5, "cpu") if weights \
        else (None, None)
    spec_j, real_j = (None, None) if not weights else (
        jnp.asarray(spec_t.numpy()), jnp.asarray(real_t.numpy()))
    _hold(case, lambda p: jc._wavelet_loss_grad(
        p, vf_j, jnp.asarray(imgs), N, 2, spec_j, real_j),
        lambda p: tc._wavelet_loss(p, vf_t, torch.as_tensor(imgs), N, 2,
                                   spec_t, real_t), 5)


@pytest.mark.parametrize("ctf", ["none", "ctf", "flipped_same"])
def test_l2_loss_and_gradient_match_the_reference(case, ctf):
    vf_j, vf_t = _vf(case)
    imgs = case["imgs"]
    yy, xx = np.mgrid[:N, :N] - N // 2
    mask = (np.hypot(yy, xx) <= 13).astype(np.float32)
    lam = 12.2643247 / np.sqrt(300e3 * (1 + 0.978466e-6 * 300e3))
    consts = (float(np.pi * lam), float(np.pi / 2 * 2.7e7 * lam ** 3),
              float(np.sqrt(1 - 0.07 ** 2)), 0.07, 2.0)
    use, flipped, same = ctf != "none", ctf == "flipped_same", \
        ctf == "flipped_same"
    defs = (CTF["defU0"], CTF["defV0"], CTF["def_ang"])
    _hold(case, lambda p: jc._l2_loss_grad(
        p, vf_j, jnp.asarray(imgs), jnp.asarray(mask),
        tuple(jnp.asarray(a) for a in defs), consts, N, 0.3, use, flipped,
        same),
        lambda p: tc._l2_loss_full(
            p, vf_t, torch.as_tensor(imgs), torch.as_tensor(mask),
            tuple(torch.as_tensor(a) for a in defs), consts, N, 0.3, use,
            flipped, same), 10)


def _hold_result(got, want, keys=("rot", "tilt", "psi", "sx", "sy"),
                 others=()):
    for k in keys:
        tol = 2e-3 if k in ("rot", "tilt", "psi") else 2e-4
        assert np.abs(got[k] - np.asarray(want[k])).max() <= tol, k
    for k in others:
        w = np.asarray(want[k])
        assert np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max(), k
    assert np.abs(got["cost"] - want["cost"]).max() <= 1e-4


@pytest.mark.parametrize("domain", ["fourier", "wavelet"])
def test_adam_steps_match_the_reference_scan(case, domain):
    kw = dict(n_steps=4, domain=domain, max_angular_change=3.0,
              max_shift=2.5)
    if domain == "wavelet":
        kw.update(gaussian_fourier=0.4, gaussian_real=0.45,
                  zerofreq_weight=0.0)
    want = jc.continuous_assign(case["vol"], case["imgs"], **case["init"],
                                **kw)
    got = tc.continuous_assign(case["vol"], case["imgs"], **case["init"],
                               device="cpu", **kw)
    _hold_result(got, want)


def test_full_adam_steps_match_the_reference_scan(case):
    kw = dict(CTF, n_steps=4, optimize_gray=True, optimize_defocus=True,
              optimize_scale=True, max_freq=0.3, Rmax=13.0,
              max_angular_change=3.0, max_shift=2.0, max_scale=0.02,
              max_defocus_change=300.0, max_gray_scale=0.05,
              max_gray_shift=0.05, compute_outputs=True)
    want = jc.continuous_assign_full(case["vol"], case["imgs"],
                                     **case["init"], **kw)
    got = tc.continuous_assign_full(case["vol"], case["imgs"],
                                    **case["init"], device="cpu", **kw)
    _hold_result(got, want, others=("scale", "grayA", "defocusU",
                                    "defocusV", "projections", "residuals"))
    assert np.abs(got["grayB"] - want["grayB"]).max() <= 1e-5


def test_refinement_moves_toward_the_truth(case):
    got = tc.continuous_assign(case["vol"], case["imgs"], **case["init"],
                               n_steps=40, device="cpu")
    t, i = case["truth"], case["init"]
    err = lambda a, b: np.abs((a - b + 180) % 360 - 180)
    assert np.median(err(got["psi"], t["psi"])) < \
        np.median(err(i["psi0"], t["psi"]))
    assert np.median(np.hypot(got["sx"] - t["sx"], got["sy"] - t["sy"])) < \
        np.median(np.hypot(i["sx0"] - t["sx"], i["sy0"] - t["sy"]))
    assert got["cost"].mean() > got["cost_first"].mean()


@pytest.mark.parametrize("full", [False, True])
def test_chunking_leaves_the_result_unchanged(case, full):
    fn = tc.continuous_assign_full if full else tc.continuous_assign
    kw = dict(CTF, optimize_gray=True) if full else {}
    one = fn(case["vol"], case["imgs"], **case["init"], n_steps=5,
             device="cpu", **kw)
    parts = fn(case["vol"], case["imgs"], **case["init"], n_steps=5,
               device="cpu", chunk=5, **kw)
    assert one.keys() == parts.keys()
    for k in one:
        np.testing.assert_array_equal(parts[k], one[k], err_msg=k)
