"""ops/psd.py, ops/arma.py, ops/resize.py and fourier.radial_average_half of
the port against the reference package on the CPU.

Held to: tile and patch geometry, the tile stacks and the Hermitian
expansions exactly; periodograms, the centred full plane, radial averages
and profiles, and the psd_estimate engine (with and without its display
normalisation) to 1e-5 of the reference's max; the ARMA model (host
float64 in both) to 1e-9; the resizes to 1e-5 of the max, the nearest
rescale and the reslices exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import rel_err
from xmipp3_tpu.ops import arma as jarma
from xmipp3_tpu.ops import fourier as jfourier
from xmipp3_tpu.ops import psd as jpsd
from xmipp3_tpu.ops import resize as jresize
from xmipp3_tpu_torch.ops import arma, fourier, psd, resize

torch.set_num_threads(1)
CPU = dict(device="cpu")


def _mic(shape=(300, 280), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("n,piece,overlap", [
    (300, 128, 0.5), (280, 128, 0.5), (512, 128, 0.5), (100, 128, 0.5),
    (300, 96, 0.4), (4096, 512, 0.5), (301, 64, 0.0)])
def test_tile_positions_and_tiles_equal_the_reference(n, piece, overlap):
    assert np.array_equal(psd.tile_positions(n, piece, overlap),
                          jpsd.tile_positions(n, piece, overlap))
    if n <= 512:
        mic = _mic((n, n - 3), seed=n)
        p = min(piece, n - 3)
        want = jpsd.extract_tiles(mic, p, overlap)
        assert np.array_equal(psd.extract_tiles(mic, p, overlap), want)
        got = psd.gather_tiles(torch.as_tensor(mic),
                               psd.tile_positions(n, p, overlap),
                               psd.tile_positions(n - 3, p, overlap), p)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("borders,dims,patch,overlap", [
    ((0, 0), (300, 280), (96, 96), 0.4), ((5, 3), (512, 384), (128, 64), 0.5),
    ((0, 0), (100, 100), (100, 100), 0.4), ((2, 2), (257, 199), (60, 50), 0.7)])
def test_patches_location_equals_the_reference(borders, dims, patch, overlap):
    assert psd.get_patches_location(borders, dims, patch, overlap) == \
        jpsd.get_patches_location(borders, dims, patch, overlap)


@pytest.mark.parametrize("shape,sx", [((8, 5), 8), ((9, 5), 9), ((6, 4), 7)])
def test_half2whole_equals_the_reference(shape, sx):
    half = np.random.default_rng(1).standard_normal(shape)
    assert np.array_equal(psd.half2whole_sized(half, sx),
                          jpsd.half2whole_sized(half, sx))
    assert np.array_equal(psd.half2whole(half), jpsd.half2whole(half))
    assert np.array_equal(psd._piece_smoother(*shape),
                          jpsd._piece_smoother(*shape))


@pytest.mark.parametrize("piece,overlap", [(128, 0.5), (96, 0.3)])
def test_estimate_psd_and_periodogram_match_the_reference(piece, overlap):
    mic = _mic()
    want = np.asarray(jpsd.estimate_psd(mic, piece, overlap))
    got = psd.estimate_psd(mic, piece, overlap, **CPU)
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-5
    tiles = jpsd.extract_tiles(mic, piece, overlap)
    window = psd.tile_window(piece)
    want = np.asarray(jpsd.periodogram_average(tiles, jnp.asarray(window)))
    assert rel_err(psd.periodogram_average(tiles, window, **CPU), want) \
        <= 1e-5
    full = psd.psd_half_to_full_centered(got, piece)
    assert rel_err(full, jpsd.psd_half_to_full_centered(want, piece)) <= 1e-5


@pytest.mark.parametrize("shape,nbins", [((64, 33), 32), ((48, 25), 17),
                                         ((3, 40, 21), 20)])
def test_radial_average_and_profile_match_the_reference(shape, nbins):
    power = np.random.default_rng(2).uniform(0, 2, shape).astype(np.float32)
    want = np.asarray(jfourier.radial_average_half(jnp.asarray(power), nbins))
    got = fourier.radial_average_half(torch.as_tensor(power), nbins)
    assert rel_err(got, want) <= 1e-5
    if len(shape) == 2:
        f1, p1 = psd.radial_profile(power, **CPU)
        f0, p0 = jpsd.radial_profile(power)
        assert np.array_equal(f1, f0)
        assert rel_err(p1, p0) <= 1e-5


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("patch,overlap", [((96, 96), 0.4), ((64, 80), 0.5)])
def test_psd_estimate_engine_matches_the_reference(normalize, patch, overlap):
    mic = _mic((260, 250), seed=4) + 3.0
    want = jpsd.estimate_psd_reference(mic, overlap, patch, normalize)
    got = psd.estimate_psd_reference(mic, overlap, patch, normalize, **CPU)
    assert got.shape == want.shape and got.dtype == want.dtype
    if not normalize:
        # the DC bin sums a mean-removed patch: float32 roundoff of each
        # package's mean of the offset patch (a few ulps of 3.0, times the
        # smoother's sum) decides it, so it is held to 1e-3 of itself
        assert abs(got[0, 0] - want[0, 0]) <= 1e-3 * abs(want[0, 0])
        got, want = got.ravel()[1:], want.ravel()[1:]
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("orders", [(12, 12, 6, 6), (4, 3, 0, 0),
                                    (5, 6, 2, 3)])
def test_arma_model_matches_the_reference(orders):
    Nh, Nv, N_MA, M_MA = orders
    tiles = jpsd.extract_tiles(_mic((160, 160), seed=5), 64, 0.5)
    want, s_want = jarma.causal_arma_psd(tiles, 64, Nh, Nv, N_MA, M_MA)
    got, s_got = arma.causal_arma_psd(tiles, 64, Nh, Nv, N_MA, M_MA)
    assert got.dtype == np.float64
    assert rel_err(got, want) <= 1e-9
    assert abs(s_got - s_want) <= 1e-9 * abs(s_want)


@pytest.mark.parametrize("order", [0, 1, 3])
@pytest.mark.parametrize("out", [(64, 60), (25, 30)])
def test_spline_resize_matches_the_reference(order, out):
    imgs = _mic((3, 40, 36), seed=6)
    want = np.asarray(jresize.spline_resize_2d(imgs, *out, order=order))
    got = resize.spline_resize_2d(imgs, *out, order=order, **CPU)
    if order == 0:
        assert np.array_equal(got.numpy(), want)
    assert rel_err(got, want) <= 1e-5
    one = resize.spline_resize_2d(imgs[0], *out, order=order, **CPU)
    assert one.shape == out and rel_err(one, want[0]) <= 1e-5


@pytest.mark.parametrize("out", [(64, 60), (25, 31), (40, 36)])
def test_fourier_resizes_match_the_reference(out):
    imgs = _mic((3, 40, 36), seed=7)
    want = np.asarray(jresize.fourier_resize_2d(imgs, *out))
    assert rel_err(resize.fourier_resize_2d(imgs, *out, **CPU), want) <= 1e-5
    want = np.asarray(jresize.pyramid_reduce_2d(imgs, 2))
    assert rel_err(resize.pyramid_reduce_2d(imgs, 2, **CPU), want) <= 1e-5
    vol = _mic((10, 12, 14), seed=8)
    want = np.asarray(jresize.fourier_resize_3d(vol, out[0] // 4, 16, 9))
    got = resize.fourier_resize_3d(vol, out[0] // 4, 16, 9, **CPU)
    assert rel_err(got, want) <= 1e-5


def test_nearest_rescale_and_reslices_equal_the_reference():
    vol = _mic((10, 12, 14), seed=9)
    for shape in ((5, 20, 14), (10, 7, 29)):
        want = np.asarray(jresize.scale_to_size_nearest(vol, shape))
        got = resize.scale_to_size_nearest(vol, shape, **CPU)
        assert np.array_equal(got.numpy(), want)
    ints = np.arange(24, dtype=np.int32).reshape(2, 3, 4)
    assert np.array_equal(resize.scale_to_size_nearest(ints, (4, 3, 2),
                                                       **CPU).numpy(),
                          np.asarray(jresize.scale_to_size_nearest(
                              ints, (4, 3, 2))))
    for view in ("y_neg", "y_pos", "x_neg", "x_pos"):
        assert np.array_equal(resize.reslice(vol, view),
                              jresize.reslice(vol, view))
    with pytest.raises(ValueError):
        resize.reslice(vol, "z")
    with pytest.raises(ValueError):
        resize.scale_to_size_nearest(vol, (3, 3), **CPU)
