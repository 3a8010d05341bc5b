"""The image feature extractors and the SPG TV denoising of the port
(xmipp3_tpu_torch.ops.features) against the reference package's, on the
CPU, on the same seeded numpy images (N=32, and 31 x 33 for odd shapes).

Tolerances, relative to each feature's max over the batch:
- the extractors: 1e-5 (LBP counts equal: integer comparisons of the same
  float32 pixels; the histogram extractors quantise the same float32
  values into the same bins);
- tv_denoise_spg: 50 steps 1e-3 absolute on the [0, 1] images. Over 200
  steps the two packages' float32 Barzilai-Borwein paths walk a flat
  valley where roundoff moves the path (the images end up to 1e-3 apart,
  and which package's energy ends lower depends on the host's rounding),
  so each of the reference's 200 iterations is fed to one step of the
  port (TVSPG.step) and the next iterate held to the reference's: x 1e-6
  absolute (x + ksi d, one float32 rounding; read 0), the energy 1e-5
  relative (float32 sums of 1,024 terms; read 7.2e-7) and the next
  direction 1e-4 absolute (the BB step theta, up to 1e3, times the
  gradient's float32 roundoff; read 3e-6); the port's own 200 steps end
  below the reference's energy at step 100;
- the batch: each image leaves its line search when its own condition
  holds, so the batched result equals each image denoised alone (1e-6),
  in a batch whose images search for different numbers of rounds at the
  same step; its energies after 30 steps 1e-5 of the reference's.
"""
import numpy as np
import pytest
import torch

from test_torch_common import rel_err
from xmipp3_tpu.ops import features as jf
from xmipp3_tpu_torch.ops import features as tf

torch.set_num_threads(1)

EXTRACTORS = ["extract_entropy", "extract_granulo", "extract_histdist",
              "extract_lbp", "extract_ramp", "extract_variance",
              "extract_zernike"]


def _imgs(seed, shape=(6, 32, 32)):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:shape[1], 0:shape[2]] - shape[1] // 2
    blob = np.exp(-(x * x + y * y) / 40.0)
    return (blob[None] * rng.uniform(0.5, 2.0, (shape[0], 1, 1))
            + 0.3 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("shape", [(6, 32, 32), (4, 31, 33)])
@pytest.mark.parametrize("name", EXTRACTORS)
def test_extractor_matches_the_reference(name, shape):
    x = _imgs(1, shape)
    want = np.asarray(getattr(jf, name)(x), np.float64)
    got = getattr(tf, name)(x, device="cpu").numpy().astype(np.float64)
    assert got.shape == want.shape
    if name == "extract_lbp":
        np.testing.assert_array_equal(got, want)
        return
    assert np.isfinite(want).all()
    assert (np.abs(got - want) <= 1e-5 * np.abs(want).max(axis=0)).all()


def test_granulo_refuses_small_images():
    with pytest.raises(ValueError):
        tf.extract_granulo(np.zeros((1, 14, 20), np.float32), device="cpu")


def test_tv_denoise_spg_matches_the_reference():
    x = _imgs(2, (3, 32, 32))
    want = np.asarray(jf.tv_denoise_spg(x, 50))
    got = tf.tv_denoise_spg(x, 50, device="cpu").numpy()
    assert np.abs(got - want).max() <= 1e-3


def _tv_energy(x, X):
    """The SPG objective of filters.cpp:4129-4259 at the VST-domain images
    X (B,H,W) denoised from the raw images x (numpy, float64)."""
    lam, sigmag, q, mu, beta2 = 1.0, 5.8, 255.0, 0.03, 1e-10
    x, X = np.asarray(x, np.float64), np.asarray(X, np.float64)
    xm = x.min(axis=(1, 2), keepdims=True)
    v = (x - xm) * 255.0 / (x.max(axis=(1, 2), keepdims=True) - xm)
    K1a = (3.0 / 8.0) * lam * lam + sigmag * sigmag
    v = 2.0 / lam * np.sqrt(np.maximum(lam * v + K1a, 0.0))
    s = v.max(axis=(1, 2), keepdims=True)
    y = v / s
    dx = np.roll(X, -1, axis=2) - X
    dy = np.roll(X, -1, axis=1) - X
    tv = np.sqrt(dx * dx + dy * dy + beta2).sum(axis=(1, 2))
    msq = 2.0 / lam * np.sqrt(np.maximum(lam * q / (s * s) * X
                                         + K1a / (s * s), 0.0)) - y
    return 0.5 * (msq * msq).sum(axis=(1, 2)) + mu * tv


def _reference_spg_carries(x, max_iter, monkeypatch):
    """The reference's scan carries (x, gradient, direction, energy) of
    each image, start and after every iteration: its _tv_spg_one with
    lax.scan run as a loop of its jitted step."""
    import jax
    import jax.numpy as jnp

    carries = []

    def scan(f, init, xs, length=None):
        step = jax.jit(f)
        c = init
        carries[-1].append(c)
        for _ in range(length):
            c, _ = step(c, None)
            carries[-1].append(c)
        return c, None

    monkeypatch.setattr(jax.lax, "scan", scan)
    for xi in x:
        carries.append([])
        jf._tv_spg_one.__wrapped__(jnp.asarray(xi), max_iter)
    monkeypatch.undo()
    # (max_iter + 1) batched states of numpy arrays
    return [tuple(np.stack([np.asarray(c[k][j]) for c in carries])
                  for j in range(4)) for k in range(max_iter + 1)]


def test_tv_denoise_spg_200_steps_reach_the_reference_energy(monkeypatch):
    x = _imgs(3, (3, 32, 32))
    ref = _reference_spg_carries(x, 200, monkeypatch)
    spg = tf.TVSPG(x, device="cpu")
    start = spg.start()
    assert np.abs(start[0].numpy() - ref[0][0]).max() <= 1e-6
    assert (np.abs(start[3].numpy() - ref[0][3])
            <= 1e-5 * np.abs(ref[0][3])).all()
    for k in range(200):
        (xn, _, dn, fn), _ = spg.step(tuple(torch.as_tensor(a)
                                            for a in ref[k]))
        want = ref[k + 1]
        assert np.abs(xn.numpy() - want[0]).max() <= 1e-6, k
        assert (np.abs(fn.numpy() - want[3])
                <= 1e-5 * np.abs(want[3])).all(), k
        assert np.abs(dn.numpy() - want[2]).max() <= 1e-4, k
    # the port's own 200 steps end below the reference's energy at step
    # 100 (each step descends: the Armijo condition)
    et = _tv_energy(x, tf.tv_denoise_spg(x, device="cpu").numpy())
    assert (et < _tv_energy(x, ref[100][0])).all()


def test_tv_batch_images_leave_the_line_search_on_their_own():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 32, 32)).astype(np.float32)
    x[1] = np.abs(x[1]) ** 3          # other statistics, other step histories
    x[3] = np.sign(x[3])
    got, rounds = tf.tv_denoise_spg(x, 30, return_rounds=True,
                                    device="cpu")
    # some step where the images searched for different numbers of rounds
    r = rounds.numpy()
    assert (r.max(axis=1) != r.min(axis=1)).any()
    for i in range(len(x)):
        alone = tf.tv_denoise_spg(x[i:i + 1], 30, device="cpu")
        assert rel_err(got[i:i + 1], alone) <= 1e-6
    ej = _tv_energy(x, jf.tv_denoise_spg(x, 30))
    assert np.abs(_tv_energy(x, got.numpy()) - ej).max() \
        <= 1e-5 * np.abs(ej).max()


def test_center_translationally_matches_the_reference():
    x = _imgs(5)
    want = np.asarray(jf.center_translationally(x))
    assert rel_err(tf.center_translationally(x, device="cpu"), want) <= 5e-5
