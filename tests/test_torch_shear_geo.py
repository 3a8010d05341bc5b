"""ops/shear_rotate.py and the 2-D part of ops/geo.py of the port against
the reference package on the CPU, with the cases of tests/test_shear_rotate.py
and tests/test_geo_ops.py.

Tolerances: the Fourier shears <= 1e-4 * max (table products there,
torch.fft here); the bilinear gathers <= 1e-5 * max, on pixels whose
source coordinate is not within 1e-3 of a pixel boundary when a matrix
inverse is involved (its roundoff can move a sample across the boundary of
the zero-filled frame); matrices and pose conversions <= 1e-5."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_common import rel_err
from xmipp3_tpu.ops import geo as jgeo
from xmipp3_tpu.ops import shear_rotate as jshear
from xmipp3_tpu_torch.ops import geo, shear_rotate

torch.set_num_threads(1)
CPU = dict(device="cpu")


def _bandlimited_apodized_n(N, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(N, N)).astype(np.float32)
    F = np.fft.fft2(img)
    fy = np.fft.fftfreq(N)[:, None]
    fx = np.fft.fftfreq(N)[None, :]
    F *= np.exp(-((fx ** 2 + fy ** 2) / (2 * 0.15 ** 2)))
    img = np.real(np.fft.ifft2(F)).astype(np.float32)
    yy, xx = np.mgrid[0:N, 0:N]
    r = np.sqrt((yy - N // 2) ** 2 + (xx - N // 2) ** 2)
    apod = 0.5 * (1 + np.cos(np.clip((r - 18) / 8, 0, 1) * np.pi))
    return (img * apod).astype(np.float32), r


@pytest.mark.parametrize("N", [63, 64, 65])
@pytest.mark.parametrize("psi", [10.0, 45.0, 90.0, 135.0, -90.0, 180.0])
def test_rotate_shift_fourier_sizes(N, psi):
    img, r = _bandlimited_apodized_n(N)
    args = (np.float32([psi]), np.float32([1.5]), np.float32([-2.0]))
    want = np.asarray(jshear.rotate_shift_fourier(jnp.asarray(img[None]),
                                                  *map(jnp.asarray, args)))
    got = shear_rotate.rotate_shift_fourier(img[None], *args, **CPU)
    if psi % 90 != 45:
        # at 45 + k*90 the quadrant reduction is a tie that roundoff
        # decides: residual +45 or -45, two valid rotations that differ by
        # their interpolation error
        assert rel_err(got, want) <= 1e-4
    # and against the spatial warp, as the reference's own test does
    M = geo.alignment_matrices_2d(np.float32([psi]), np.zeros(1, np.float32),
                                  np.zeros(1, np.float32), **CPU)
    ref = geo.apply_affine_2d(img[None], M, wrap=True, **CPU)[0].numpy()
    rot = shear_rotate.rotate_shift_fourier(
        img[None], np.float32([psi]), np.zeros(1), np.zeros(1), **CPU)[0]
    mask = r < 16
    assert np.corrcoef(ref[mask], rot.numpy()[mask])[0, 1] > 0.99


def test_rotate_shift_fourier_per_image_poses_and_translate():
    img, _ = _bandlimited_apodized_n(64)
    psis = np.float32([17.0, -95.0, 160.0, 0.0, 200.0, -44.9])
    sxs = np.float32([1.0, -2.0, 0.5, 3.0, 0.0, -1.25])
    sys_ = np.float32([-1.5, 0.0, 2.0, -0.5, 0.75, 4.0])
    batch = np.stack([img] * 6)
    want = np.asarray(jshear.rotate_shift_fourier(
        jnp.asarray(batch), *map(jnp.asarray, (psis, sxs, sys_))))
    assert rel_err(shear_rotate.rotate_shift_fourier(batch, psis, sxs, sys_,
                                                     **CPU), want) <= 1e-4
    want = np.asarray(jshear.translate_fourier(
        jnp.asarray(batch), jnp.asarray(sxs), jnp.asarray(sys_)))
    assert rel_err(shear_rotate.translate_fourier(batch, sxs, sys_, **CPU),
                   want) <= 1e-4


def test_rotate_shift_fourier_invertible():
    img, r = _bandlimited_apodized_n(64)
    fwd = shear_rotate.rotate_shift_fourier(
        img[None], np.float32([33.0]), np.float32([2.0]), np.float32([-1.0]),
        **CPU)
    c, s = np.cos(np.deg2rad(33.0)), np.sin(np.deg2rad(33.0))
    back = shear_rotate.rotate_shift_fourier(
        fwd, np.float32([-33.0]), np.float32([-(c * 2.0 + s)]),
        np.float32([-(s * 2.0 - c)]))
    mask = r < 14
    err = np.abs(back.numpy()[0][mask] - img[mask]).max()
    assert err < 5e-3 * np.abs(img[mask]).max() + 1e-4


def _poses(seed, B):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-180, 180, B).astype(np.float32),
            rng.uniform(-4, 4, B).astype(np.float32),
            rng.uniform(-4, 4, B).astype(np.float32),
            rng.uniform(size=B) < 0.5)


def _agree_off_the_boundaries(got, want, tol=1e-5):
    """rel error over all pixels but at most 1 % outliers: samples that the
    two matrix inverses put on either side of a pixel boundary of the
    zero-filled frame."""
    d = np.abs(got.numpy() - want) / np.abs(want).max()
    assert np.mean(d > tol) <= 0.01
    assert np.quantile(d, 0.99) <= tol


@pytest.mark.parametrize("wrap", [False, True])
def test_apply_affine_and_alignment_2d(wrap):
    imgs = np.random.default_rng(1).standard_normal((6, 24, 30)).astype(
        np.float32)
    psi, sx, sy, flip = _poses(2, 6)
    scale = np.linspace(0.9, 1.1, 6).astype(np.float32)
    for f, sc in ((None, None), (flip, None), (flip, scale)):
        want = np.asarray(jgeo.alignment_matrices_2d(psi, sx, sy, f, sc))
        M = geo.alignment_matrices_2d(psi, sx, sy, f, sc, **CPU)
        assert np.abs(M.numpy() - want).max() <= 1e-5
        _agree_off_the_boundaries(
            geo.apply_affine_2d(imgs, M, wrap=wrap, **CPU),
            np.asarray(jgeo.apply_affine_2d(imgs, want, wrap=wrap)))
        # with the inverse given, the samples are the same ones: every pixel
        assert rel_err(geo.apply_affine_2d(imgs, M, wrap=wrap, inverse=True,
                                           **CPU),
                       np.asarray(jgeo.apply_affine_2d(imgs, want, wrap=wrap,
                                                       inverse=True))) <= 1e-5
    _agree_off_the_boundaries(
        geo.apply_alignment_2d(imgs, psi, sx, sy, flip, wrap=wrap, **CPU),
        np.asarray(jgeo.apply_alignment_2d(imgs, psi, sx, sy, flip,
                                           wrap=wrap)))
    _agree_off_the_boundaries(
        geo.apply_md_geometry(imgs, psi, sx, sy, flip, wrap=wrap, **CPU),
        np.asarray(jgeo.apply_md_geometry(imgs, psi, sx, sy, flip,
                                          wrap=wrap)))
    assert np.abs(geo.metadata_alignment_matrices(psi, sx, sy, flip, **CPU)
                  .numpy() - np.asarray(jgeo.metadata_alignment_matrices(
                      psi, sx, sy, flip))).max() <= 1e-5


def test_affine_matches_alignment_and_one_matrix_for_all():
    from xmipp3_tpu_torch.core.geometry import rotation2d_matrix
    y, x = np.mgrid[0:32, 0:32].astype(np.float32)
    img = np.exp(-((y - 16) ** 2 + (x - 20) ** 2) / 8.0)
    A = np.asarray(rotation2d_matrix(45.0), np.float32)
    out1 = geo.apply_affine_2d(img, A, **CPU)[0]
    out2 = geo.apply_alignment_2d(img[None], np.float32([45.0]), np.zeros(1),
                                  np.zeros(1), **CPU)[0]
    assert np.abs(out1.numpy() - out2.numpy()).max() <= 1e-5
    assert rel_err(out1, np.asarray(jgeo.apply_affine_2d(img[None],
                                                         A[None]))[0]) <= 1e-5
    # order 3, the cubic B-spline (tests/test_torch_geo_bspline.py has
    # the rest of its cases)
    assert rel_err(geo.apply_affine_2d(img, A, order=3, **CPU)[0],
                   np.asarray(jgeo.apply_affine_2d(img[None], A[None],
                                                   order=3))[0]) <= 1e-5


def test_gather_bilinear():
    img = np.random.default_rng(3).standard_normal((20, 17)).astype(np.float32)
    rng = np.random.default_rng(4)
    yy = rng.uniform(-3, 23, (9, 11)).astype(np.float32)
    xx = rng.uniform(-3, 20, (9, 11)).astype(np.float32)
    for wrap in (False, True):
        want = np.asarray(jgeo._gather_bilinear(jnp.asarray(img),
                                                jnp.asarray(yy),
                                                jnp.asarray(xx), wrap))
        got = geo._gather_bilinear(*map(torch.as_tensor, (img, yy, xx)), wrap)
        assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("n", [8, 9])
def test_centered_flip_and_pose_conversion(n):
    x = np.random.default_rng(5).standard_normal((2, n, n + 1)).astype(
        np.float32)
    for axis in (1, 2):
        np.testing.assert_array_equal(
            geo.centered_flip(torch.as_tensor(x), axis).numpy(),
            np.asarray(jgeo.centered_flip(x, axis)))
    psi, sx, sy, flip = _poses(6, 16)
    psi = psi * 2                     # beyond +-180: the wrap is exercised
    want = jgeo.alignment_to_md_pose(psi, sx, sy, flip)
    got = geo.alignment_to_md_pose(psi, sx, sy, flip, **CPU)
    for g, w in zip(got[:3], want[:3]):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-4
    np.testing.assert_array_equal(got[3].numpy(), flip)
    assert not geo.alignment_to_md_pose(psi, sx, sy, **CPU)[3].any()
    vx, vy = geo.rotate_vector_2d(*map(torch.as_tensor, (sx, sy, psi)))
    wx, wy = jgeo.rotate_vector_2d(sx, sy, psi)
    assert np.abs(vx.numpy() - np.asarray(wx)).max() <= 1e-5
    assert np.abs(vy.numpy() - np.asarray(wy)).max() <= 1e-5
