"""The rest of ops/geo.py in the port against the reference package on the
CPU: the cubic B-spline path (prefilter, 16-tap gather, order-3 warps),
the reference readApplyGeo convention, the 2-D helpers, the trilinear 3-D
warp and the windows; and ops/fourier.py's freq_grid_3d.

Tolerances: the B-spline prefilter <= 1e-6 * max (the port applies the
mirror boundary's DCT-II deconvolution as one float64-built matrix per
axis, the reference as float32 DCTs); order-3 and bilinear warps, the
16-tap gather, read_apply_geo and the 3-D warp <= 1e-5 * max; matrices
<= 1e-6; windows and frequency grids exact. The warped images are
band-limited and apodized (zero near the frame), so a sample that a
matrix inverse's roundoff moves across the frame's edge carries nothing.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_common import rel_err
from xmipp3_tpu.core.geometry import euler_matrix
from xmipp3_tpu.ops import fourier as jfourier
from xmipp3_tpu.ops import geo as jgeo
from xmipp3_tpu_torch.ops import fourier, geo

torch.set_num_threads(1)
CPU = dict(device="cpu")


def _smooth_stack(B, H, W, seed):
    """Band-limited noise, apodized to zero beyond 0.4 of the frame."""
    rng = np.random.default_rng(seed)
    F = np.fft.fft2(rng.standard_normal((B, H, W)))
    fy = np.fft.fftfreq(H)[:, None]
    fx = np.fft.fftfreq(W)[None, :]
    F *= np.exp(-(fx ** 2 + fy ** 2) / (2 * 0.12 ** 2))
    img = np.real(np.fft.ifft2(F))
    yy, xx = np.mgrid[0:H, 0:W]
    r = np.hypot((yy - H // 2) / H, (xx - W // 2) / W)
    apod = 0.5 * (1 + np.cos(np.clip((r - 0.25) / 0.15, 0, 1) * np.pi))
    return (img * apod).astype(np.float32)


def _poses(B, seed):
    rng = np.random.default_rng(seed)
    psi = rng.uniform(-180, 180, B).astype(np.float32)
    sx, sy = rng.uniform(-4, 4, (2, B)).astype(np.float32)
    flip = rng.uniform(size=B) < 0.5
    scale = rng.uniform(0.8, 1.2, B).astype(np.float32)
    return psi, sx, sy, flip, scale


@pytest.mark.parametrize("shape", [(32, 32), (33, 40), (48, 31)])
@pytest.mark.parametrize("wrap", [True, False])
def test_bspline3_prefilter(shape, wrap):
    x = np.random.default_rng(1).standard_normal((3,) + shape).astype(
        np.float32)
    want = np.asarray(jgeo.bspline3_prefilter_2d(jnp.asarray(x), wrap=wrap))
    got = geo.bspline3_prefilter_2d(x, wrap, **CPU)
    assert rel_err(got, want) <= 1e-6
    # one image without a batch axis
    assert rel_err(geo.bspline3_prefilter_2d(x[0], wrap, **CPU),
                   want[0]) <= 1e-6


def test_bspline3_prefilter_inverts_the_sampled_kernel():
    """Convolving the coefficients with [1/6, 4/6, 1/6] per axis (mirror
    off bounds) gives the image back."""
    x = np.random.default_rng(2).standard_normal((20, 17)).astype(np.float32)
    c = geo.bspline3_prefilter_2d(x, False, **CPU).numpy().astype(np.float64)
    for axis in (0, 1):
        p = np.concatenate([np.take(c, [0], axis), c, np.take(c, [-1], axis)],
                           axis)
        n = c.shape[axis]
        c = (np.take(p, range(0, n), axis) + 4 * np.take(p, range(1, n + 1),
                                                         axis)
             + np.take(p, range(2, n + 2), axis)) / 6
    assert np.abs(c - x).max() <= 1e-5 * np.abs(x).max()


@pytest.mark.parametrize("wrap", [True, False])
def test_gather_bspline3(wrap):
    rng = np.random.default_rng(3)
    coeffs = rng.standard_normal((2, 20, 17)).astype(np.float32)
    yy = rng.uniform(-3, 23, (2, 9, 11)).astype(np.float32)
    xx = rng.uniform(-3, 20, (2, 9, 11)).astype(np.float32)
    for b in range(2):
        want = np.asarray(jgeo._gather_bspline3(
            jnp.asarray(coeffs[b]), jnp.asarray(yy[b]), jnp.asarray(xx[b]),
            wrap))
        got = geo._gather_bspline3(*map(torch.as_tensor, (coeffs, yy, xx)),
                                   wrap)[b]
        assert rel_err(got, want) <= 1e-5
        single = geo._gather_bspline3(
            *map(torch.as_tensor, (coeffs[b], yy[b], xx[b])), wrap)
        assert rel_err(single, want) <= 1e-5


def test_mirror_off_and_bspline_weight():
    idx = np.arange(-7, 14)
    want = np.asarray(jgeo._mirror_off(jnp.asarray(idx), 7))
    np.testing.assert_array_equal(
        geo._mirror_off(torch.as_tensor(idx), 7).numpy(), want)
    t = np.linspace(-2.5, 2.5, 101).astype(np.float32)
    assert np.abs(geo._bspline3_weight(torch.as_tensor(t)).numpy()
                  - np.asarray(jgeo._bspline3_weight(jnp.asarray(t)))
                  ).max() <= 1e-7


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("shape", [(32, 32), (33, 36)])
def test_apply_affine_2d_orders(order, wrap, shape):
    B = 5
    imgs = _smooth_stack(B, *shape, seed=4)
    psi, sx, sy, flip, scale = _poses(B, 5)
    A = np.asarray(jgeo.alignment_matrices_2d(psi, sx, sy, flip, scale))
    want = np.asarray(jgeo.apply_affine_2d(imgs, A, order=order, wrap=wrap))
    got = geo.apply_affine_2d(imgs, A, order=order, wrap=wrap, **CPU)
    assert rel_err(got, want) <= 1e-5
    inv = np.linalg.inv(A.astype(np.float64)).astype(np.float32)
    want = np.asarray(jgeo.apply_affine_2d(imgs, inv, order=order, wrap=wrap,
                                           inverse=True))
    got = geo.apply_affine_2d(imgs, inv, order=order, wrap=wrap, inverse=True,
                              **CPU)
    assert rel_err(got, want) <= 1e-5


def test_xmipp_geo_matrices_and_read_apply_geo():
    B = 6
    imgs = _smooth_stack(B, 32, 32, seed=6)
    psi, sx, sy, flip, scale = _poses(B, 7)
    for sc in (None, scale):
        for fl in (None, flip):
            want = np.asarray(jgeo.xmipp_geo_matrices(psi, sx, sy, fl, sc))
            got = geo.xmipp_geo_matrices(psi, sx, sy, fl, sc, **CPU)
            assert np.abs(got.numpy() - want).max() <= 1e-6
    for order in (1, 3):
        want = np.asarray(jgeo.read_apply_geo(imgs, psi, sx, sy, flip, scale,
                                              order=order))
        got = geo.read_apply_geo(imgs, psi, sx, sy, flip, scale, order=order,
                                 **CPU)
        assert rel_err(got, want) <= 1e-5


def test_registration_pose_to_xmipp_row():
    psi, sx, sy, flip, _ = _poses(8, 8)
    for fl in (None, flip):
        want = jgeo.registration_pose_to_xmipp_row(psi, sx, sy, fl)
        got = geo.registration_pose_to_xmipp_row(psi, sx, sy, fl, **CPU)
        for g, w in zip(got, want):
            assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(got[3], want[3])
        d = (np.asarray(got[0], np.float64) - want[0] + 180) % 360 - 180
        assert np.abs(d).max() <= 1e-4
        for k in (1, 2, 4):
            assert np.abs(got[k] - want[k]).max() <= 1e-5


@pytest.mark.parametrize("order", [1, 3])
def test_rotate_and_shift_2d(order):
    imgs = _smooth_stack(3, 32, 32, seed=9)
    want = np.asarray(jgeo.rotate_2d(imgs, 33.0, order=order))
    assert rel_err(geo.rotate_2d(imgs, 33.0, order=order, **CPU),
                   want) <= 1e-5
    ang = np.float32([10.0, -70.0, 150.0])
    want = np.asarray(jgeo.rotate_2d(imgs, ang, order=order, wrap=True))
    assert rel_err(geo.rotate_2d(imgs, ang, order=order, wrap=True, **CPU),
                   want) <= 1e-5
    want = np.asarray(jgeo.shift_2d_real(imgs, 1.3, -0.4, order=order))
    assert rel_err(geo.shift_2d_real(imgs, 1.3, -0.4, order=order, **CPU),
                   want) <= 1e-5
    sx, sy = np.float32([0.5, -2.25, 3.0]), np.float32([1.5, 0.0, -0.75])
    want = np.asarray(jgeo.shift_2d_real(imgs, sx, sy, order=order))
    assert rel_err(geo.shift_2d_real(imgs, sx, sy, order=order, **CPU),
                   want) <= 1e-5


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("translate", [False, True])
def test_apply_affine_3d(wrap, translate):
    rng = np.random.default_rng(10)
    vol = rng.standard_normal((12, 14, 16)).astype(np.float32)
    M = np.stack([np.asarray(euler_matrix(30, 40, 50)),
                  np.asarray(euler_matrix(-10, 80, 5))]).astype(np.float32)
    if translate:
        M = np.concatenate([M, rng.uniform(-2, 2, (2, 3, 1)).astype(
            np.float32)], -1)
    want = np.asarray(jgeo.apply_affine_3d(vol, M, wrap=wrap))
    got = geo.apply_affine_3d(vol, M, wrap=wrap, **CPU)
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-5
    one = geo.apply_affine_3d(vol, M[0], wrap=wrap, **CPU)
    assert rel_err(one[0], want[0]) <= 1e-5


@pytest.mark.parametrize("out", [(20, 30), (50, 41), (33, 33)])
def test_windows(out):
    img = np.random.default_rng(11).standard_normal((3, 33, 36)).astype(
        np.float32)
    want = np.asarray(jgeo.window_2d(img, *out, 1.5))
    np.testing.assert_array_equal(geo.window_2d(img, *out, 1.5, **CPU).numpy(),
                                  want)
    np.testing.assert_array_equal(
        geo.window_2d(img[0], *out, **CPU).numpy(),
        np.asarray(jgeo.window_2d(img[0], *out)))
    for win in ((-5, -6, 7, 9), (-20, -3, 25, 2), (0, 0, 0, 0)):
        np.testing.assert_array_equal(geo.window_2d_logical(img, *win, 2.0),
                                      jgeo.window_2d_logical(img, *win, 2.0))


@pytest.mark.parametrize("dims", [(8, 9, 10), (5, 6, 7)])
def test_freq_grid_3d(dims):
    for g, w in zip(fourier.freq_grid_3d(*dims),
                    jfourier.freq_grid_3d(*dims)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
