"""ops/spatial_filters.py and ops/denoise.py of the port against the
reference package on the CPU (N=32, B=3): transform_filter's bad-pixel,
mean-shift, background, median, diffusion, basis, log, retinex, TV and
wavelet modes, with the Haar/Daubechies transforms behind them.

Held to 1e-5 * max (the host numpy filters are the reference's code and
must be equal).
"""
import numpy as np
import pytest
import torch

from test_torch_common import rel_err
from xmipp3_tpu.ops import denoise as jden
from xmipp3_tpu.ops import spatial_filters as jsf
from xmipp3_tpu_torch.ops import denoise, spatial_filters as sf

torch.set_num_threads(1)
CPU = dict(device="cpu")


def _imgs(seed=3, shape=(3, 32, 32)):
    return (np.random.default_rng(seed).standard_normal(shape) + 2).astype(
        np.float32)


def _close(got, want, tol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert rel_err(got, want) <= tol


@pytest.mark.parametrize("single", [False, True])
def test_device_filters(single):
    x = _imgs()
    x = x[0] if single else x
    basis = _imgs(4, (4, 32, 32))
    _close(sf.median_3x3(x, **CPU), jsf.median_3x3(x))
    _close(sf.log_filter(x + 3, 4.431, 0.4018, 336.6, **CPU),
           jsf.log_filter(x + 3, 4.431, 0.4018, 336.6))
    _close(sf.basis_filter(x, basis, **CPU), jsf.basis_filter(x, basis))
    for hr, hs, it, fast in ((1.0, 3.0, 2, False), (1.0, 2.0, 1, True),
                             (0.5, 6.0, 1, False)):
        _close(sf.mean_shift_filter(x, hr, hs, it, fast=fast, **CPU),
               jsf.mean_shift_filter(x, hr, hs, it, fast=fast))


@pytest.mark.parametrize("args", [{}, {"outer": 3, "inner": 2,
                                        "refinement": 2},
                                   {"weights": (0.5, 20.0, 40.0, 0.05),
                                    "adjust_range": False}])
def test_smoothing_shah(args):
    x = _imgs()[0] / 5
    got = sf.smoothing_shah(x, **args, **CPU)
    want = jsf.smoothing_shah(x, **args)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_host_filters_are_the_reference_code():
    x = _imgs()[0]
    x[3, 4], x[10, 11], x[12, 11] = -5.0, 30.0, -1.0
    bad = np.zeros(x.shape, bool)
    bad[5:8, 5:9] = True
    vol = _imgs(5, (6, 8, 9))
    for got, want in (
            (sf.force_positive(x), jsf.force_positive(x)),
            (sf.pixel_desv_filter(x, 2.0), jsf.pixel_desv_filter(x, 2.0)),
            (sf.pixel_desv_filter(x, 0.0), jsf.pixel_desv_filter(x, 0.0)),
            (sf.bound_median_filter(x, bad), jsf.bound_median_filter(x, bad)),
            (sf.bound_median_filter(vol, vol > 3.5),
             jsf.bound_median_filter(vol, vol > 3.5)),
            (sf.rolling_ball_background(x, 5),
             jsf.rolling_ball_background(x, 5)),
            (sf.rolling_ball_background(x, 20),
             jsf.rolling_ball_background(x, 20)),
            (sf.retinex_filter(x), jsf.retinex_filter(x)),
            (sf.retinex_filter(x, 0.8, bad.astype(np.float32), 0.5),
             jsf.retinex_filter(x, 0.8, bad.astype(np.float32), 0.5)),
            (sf.retinex_filter(vol), jsf.retinex_filter(vol))):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("single", [False, True])
def test_tv_haar_db4(single):
    x = _imgs()
    x = x[0] if single else x
    _close(denoise.tv_denoise_2d(x, 0.1, 20, **CPU),
           jden.tv_denoise_2d(x, 0.1, 20))
    _close(denoise.wavelet_denoise_2d(x, 2.5, **CPU),
           jden.wavelet_denoise_2d(x, 2.5))
    _close(denoise.wavelet_denoise_2d(x, 3.0, 2, **CPU),
           jden.wavelet_denoise_2d(x, 3.0, 2))
    _close(denoise.db4_denoise_2d(x, 3.0, **CPU), jden.db4_denoise_2d(x, 3.0))


@pytest.mark.parametrize("kind", ["DAUB4", "DAUB12", "DAUB20"])
@pytest.mark.parametrize("mode", ["remove_scale", "soft_thresholding",
                                  "bayesian", "adaptive_soft", "central"])
def test_wavelet_filter_modes(kind, mode):
    x = _imgs()
    for kw in ({}, {"scale": 1, "threshold_pct": 70.0, "R": 9},
               {"white_noise": True, "output_scale": 1}):
        _close(denoise.wavelet_filter_2d(x, kind, mode, **kw, **CPU),
               jden.wavelet_filter_2d(x, kind, mode, **kw))


def test_wavelet_transforms():
    x = _imgs()
    ll, det = denoise.daub_dwt2(x, 2, "DAUB12", **CPU)
    jll, jdet = jden.daub_dwt2(x, 2, "DAUB12")
    _close(ll, jll)
    for bands, jbands in zip(det, jdet):
        for b, jb in zip(bands, jbands):
            _close(b, jb)
    _close(denoise.daub_idwt2(ll, det, "DAUB12"), x)
    ll, det = denoise.db4_dwt2(x, 1, **CPU)
    _close(denoise.db4_idwt2(ll, det), x)
    ll, bands = denoise._haar_dwt2(torch.as_tensor(x))
    _close(denoise._haar_idwt2(ll, bands), x)
    vol = _imgs(6, (8, 10, 12))
    for b, jb in zip(denoise.dwt3(vol, **CPU), jden.dwt3(vol)):
        _close(b, jb)
    _close(denoise.idwt3(denoise.dwt3(vol, **CPU)), vol)
    with pytest.raises(ValueError, match="unknown wavelet mode"):
        denoise.wavelet_filter_2d(x, "DAUB4", "nope", **CPU)
