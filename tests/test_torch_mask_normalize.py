"""ops/mask.py and ops/normalize.py of the port against the reference
package on the CPU (N=32, B=5).

Masks are the reference's numpy code and must be equal. Every
normalization method, dust removal and the plane fits are held to 1e-5 *
max; the methods that draw noise (Neighbour, dust removal) draw from a
numpy Generator with the same seed on both sides and must agree draw for
draw. The images carry a particle on a sloped background, so that the
denominators of NewXmipp2 and Michael are well away from zero.
"""
import numpy as np
import pytest
import torch

from test_torch_common import rel_err
from xmipp3_tpu.ops import mask as jmask
from xmipp3_tpu.ops import normalize as jnorm
from xmipp3_tpu_torch.ops import mask, normalize

torch.set_num_threads(1)
CPU = dict(device="cpu")
N, B = 32, 5


def _imgs(seed=2):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:N, 0:N].astype(np.float32) - N // 2
    particle = 6 * np.exp(-(x * x + y * y) / 40)
    ramp = 0.05 * x + 0.03 * y + 3
    imgs = particle + ramp + rng.standard_normal((B, N, N))
    return (imgs * rng.uniform(0.5, 2, (B, 1, 1))).astype(np.float32)


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("shape", [(32, 32), (9, 10, 11)])
def test_masks(shape):
    cases = [("circular_mask", (None,)), ("circular_mask", (10,)),
             ("circular_mask", (-3,)), ("circular_mask", (10, 3)),
             ("circular_mask", (9, 2, "gaussian")),
             ("circular_mask", (9, 2, "raised_cosine")),
             ("crown_mask", (3, 9)), ("blob_circular_mask", (6, 3)),
             ("blob_circular_mask", (6, 3, 2, 10.4, False)),
             ("blob_crown_mask", (3, 8, 2)),
             ("blob_crown_mask", (3, 8, 2, 2, 10.4, False)),
             ("background_mask", (8,)), ("gaussian_mask", (3.5,)),
             ("rectangular_mask", (3, 4) + ((2,) if len(shape) == 3 else ()))]
    for name, args in cases:
        got = getattr(mask, name)(shape, *args)
        want = getattr(jmask, name)(shape, *args)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_window_and_region_growing():
    np.testing.assert_array_equal(mask.raised_cosine_window_1d(32, 0.4),
                                  jmask.raised_cosine_window_1d(32, 0.4))
    v = (np.random.default_rng(1).uniform(size=(6, 7, 8)) > 0.5).astype(
        np.float32)
    np.testing.assert_array_equal(
        mask.region_growing_equal_value(v, (0, 0, 0), 3),
        jmask.region_growing_equal_value(v, (0, 0, 0), 3))


METHODS = ["OldXmipp", "None", "NewXmipp", "NewXmipp2", "Near_OldXmipp",
           "Ramp", "Robust", "Michael", "Neighbour"]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("radius", [None, 12])
def test_normalize_methods(method, radius):
    imgs = _imgs()
    want = jnorm.normalize(imgs, method, radius, thr_neigh=1.2,
                           rng=np.random.default_rng(0))
    got = normalize.normalize(imgs, method, radius, thr_neigh=1.2,
                              rng=np.random.default_rng(0), **CPU)
    assert rel_err(_host(got), np.asarray(want)) <= 1e-5


def test_normalize_robust_clip_and_functions():
    imgs = _imgs(3)
    bg = jmask.background_mask((N, N), 11)
    for got, want in (
            (normalize.normalize(imgs, "Robust", 11, clip=True, **CPU),
             jnorm.normalize(imgs, "Robust", 11, clip=True)),
            (normalize.normalize_robust(imgs, **CPU),
             jnorm.normalize_robust(imgs)),
            (normalize.normalize_robust(imgs[:, :, :-1], **CPU),
             jnorm.normalize_robust(imgs[:, :, :-1])),
            (normalize.least_squares_plane_fit(imgs, **CPU),
             jnorm.least_squares_plane_fit(imgs)),
            (normalize.least_squares_plane_fit(imgs, bg, **CPU),
             jnorm.least_squares_plane_fit(imgs, bg)),
            (normalize.normalize_ramp(imgs, **CPU),
             jnorm.normalize_ramp(imgs)),
            (normalize.normalize_new_xmipp(imgs[0], bg, **CPU),
             jnorm.normalize_new_xmipp(imgs[0], bg)),
            (normalize.subtract_background_plane(imgs[0], bg, **CPU),
             jnorm.subtract_background_plane(imgs[0], bg))):
        assert rel_err(_host(got), np.asarray(want)) <= 1e-5
    with pytest.raises(ValueError, match="unknown normalize method"):
        normalize.normalize(imgs, "nope", **CPU)


@pytest.mark.parametrize("thr", [(-2.5, None), (None, 2.5), (-2.0, 2.0)])
def test_remove_dust_draws_as_the_reference(thr):
    imgs = _imgs(4)
    imgs[:, 3, 4] = 40.0
    imgs[:, 20, 9] = -40.0
    got = normalize.remove_dust(imgs, *thr, rng=np.random.default_rng(7))
    want = jnorm.remove_dust(imgs, *thr, rng=np.random.default_rng(7))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, imgs)


@pytest.mark.parametrize("tilt", [0.0, 35.0, 60.0])
@pytest.mark.parametrize("mask_band", [False, True])
def test_normalize_tomography(tilt, mask_band):
    img = _imgs(5)[0]
    for kw in ({}, {"tomography0": True, "mu0": 0.3, "sigma0": 1.7}):
        got = normalize.normalize_tomography(img, tilt, tilt_mask=mask_band,
                                             **kw)
        want = jnorm.normalize_tomography(img, tilt, tilt_mask=mask_band,
                                          **kw)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
