"""ops/dft_mm.py, ops/fourier.py, ops/shift.py and ops/polar.py of the port
against the reference package, function by function, on the CPU.

Tolerances: <= 1e-4 * max for what goes through an FFT (the reference uses
float32 table products, the port torch.fft), <= 1e-5 * max for the gathers
(the same taps, weights multiplied in another order); shifts and angles of
correlation peaks <= 1e-3 px / 1e-2 deg (2e-2 px for phase correlation)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_common import rel_err
from xmipp3_tpu.ops import dft_mm as jdft
from xmipp3_tpu.ops import fourier as jfourier
from xmipp3_tpu.ops import polar as jpolar
from xmipp3_tpu.ops import shift as jshift
from xmipp3_tpu_torch.ops import dft_mm, fourier, polar, shift

torch.set_num_threads(1)
CPU = dict(device="cpu")


def _imgs(seed, B=5, H=32, W=32, smooth=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W)).astype(np.float32)
    if smooth:
        F = np.fft.fft2(x)
        fy, fx = np.fft.fftfreq(H)[:, None], np.fft.fftfreq(W)[None, :]
        x = np.fft.ifft2(F * np.exp(-(fx ** 2 + fy ** 2) / (2 * 0.12 ** 2)))
        x = x.real.astype(np.float32)
    return x


@pytest.mark.parametrize("n", [32, 31])
def test_dft_1d(n):
    x = np.random.default_rng(0).standard_normal((4, 3, n)).astype(np.float32)
    X = np.asarray(jdft.rfft_mm_last(jnp.asarray(x)))
    assert rel_err(dft_mm.rfft_mm_last(x, **CPU), X) <= 1e-4
    # a non-Hermitian DC / Nyquist imaginary part is ignored by both
    Xn = X + 1j * np.float32(0.5)
    assert rel_err(dft_mm.irfft_mm_last(Xn, n, **CPU),
                   np.asarray(jdft.irfft_mm_last(jnp.asarray(Xn), n))) <= 1e-4


@pytest.mark.parametrize("shape", [(32, 32), (31, 33)])
def test_dft_2d(shape):
    x = _imgs(1, 3, *shape, smooth=False)
    X = np.asarray(jdft.rfft2_mm(jnp.asarray(x)))
    assert rel_err(dft_mm.rfft2_mm(x, **CPU), X) <= 1e-4
    assert rel_err(dft_mm.irfft2_mm(X, shape, **CPU),
                   np.asarray(jdft.irfft2_mm(jnp.asarray(X), shape))) <= 1e-4
    assert rel_err(dft_mm.fft2_abs_shifted_mm(x, **CPU),
                   np.asarray(jdft.fft2_abs_shifted_mm(jnp.asarray(x)))) <= 1e-4
    assert rel_err(fourier.rfft2(x, **CPU), np.asarray(jfourier.rfft2(x))) <= 1e-4
    assert rel_err(fourier.irfft2(X, shape, **CPU),
                   np.asarray(jfourier.irfft2(jnp.asarray(X), shape))) <= 1e-4


def test_fourier_grids_and_shift():
    for a, b in zip(fourier.freq_grid_2d(12, 9), jfourier.freq_grid_2d(12, 9)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(fourier.radial_freq_2d(12, 9),
                                  jfourier.radial_freq_2d(12, 9))
    x = _imgs(2, 4, 24, 30)
    sx = np.float32([1.5, -2.25, 0.0, 7.0])
    sy = np.float32([-0.5, 3.0, 1.0, -4.75])
    assert rel_err(fourier.fourier_shift_2d(x, sx, sy, **CPU),
                   np.asarray(jfourier.fourier_shift_2d(x, sx, sy))) <= 1e-4
    assert rel_err(fourier.fourier_shift_2d(x[0], sx[:1], sy[:1], **CPU),
                   np.asarray(jfourier.fourier_shift_2d(x[0], sx[:1], sy[:1]))
                   ) <= 1e-4
    f = np.fft.rfftfreq(30).astype(np.float32)
    assert rel_err(fourier.phase_ramp_1d(torch.as_tensor(f),
                                         torch.as_tensor(sx)),
                   np.asarray(jfourier.phase_ramp_1d(jnp.asarray(f),
                                                     jnp.asarray(sx)))) <= 1e-5


def _shifted_pairs(seed, N, max_abs):
    ref = _imgs(seed, 6, N, N)
    rng = np.random.default_rng(seed + 1)
    sx, sy = rng.uniform(-max_abs, max_abs, (2, 6)).astype(np.float32)
    oth = np.asarray(jfourier.fourier_shift_2d(ref, sx, sy))
    return ref, oth, sx, sy


@pytest.mark.parametrize("N,max_shift,windowed", [
    (32, 4, True),       # 2*4+3 <= 16: the windowed inverse DFT
    (32, 8, False),      # 2*8+3 >  16: the full correlation map
    (32, None, False), (33, 5, True)])
@pytest.mark.parametrize("normalize", [False, True])
def test_best_shift_both_paths(N, max_shift, windowed, normalize):
    assert windowed == (max_shift is not None
                        and 2 * max_shift + 3 <= N // 2)
    ref, oth, sx, sy = _shifted_pairs(3, N, 3.0)
    want = [np.asarray(v) for v in jshift.best_shift(
        ref, oth, max_shift=max_shift, normalize=normalize)]
    got = [v.numpy() for v in shift.best_shift(
        ref, oth, max_shift=max_shift, normalize=normalize, **CPU)]
    # phase correlation divides by |cross|, which is roundoff where the
    # smooth images carry no power: its peaks move by some 1e-2 px between
    # two float32 FFTs
    tol = 2e-2 if normalize else 1e-3
    for g, w in zip(got[:2], want[:2]):
        assert np.abs(g - w).max() <= tol
    assert rel_err(got[2], want[2]) <= (1e-2 if normalize else 1e-4)
    if not normalize:
        assert np.abs(got[0] + sx).max() < 0.1 and np.abs(got[1] + sy).max() < 0.1
    pairs = [v.numpy() for v in shift.best_shift_pairs(ref, oth, max_shift,
                                                       **CPU)]
    if not normalize:
        np.testing.assert_array_equal(pairs[0], got[0])


def test_correlation_peaks_and_windowed_cross_peaks():
    ref, oth, _, _ = _shifted_pairs(5, 32, 3.0)
    cross = np.fft.rfft2(oth) * np.conj(np.fft.rfft2(ref))
    cross = cross.astype(np.complex64)
    want = [np.asarray(v) for v in jshift.windowed_cross_peaks(
        jnp.asarray(cross), 32, 32, 4)]
    got = [v.numpy() for v in shift.windowed_cross_peaks(
        torch.as_tensor(cross), 32, 32, 4)]
    for g, w in zip(got[:2], want[:2]):
        assert np.abs(g - w).max() <= 1e-3
    assert rel_err(got[2], want[2]) <= 1e-4
    corr = np.fft.fftshift(np.fft.irfft2(cross, s=(32, 32)),
                           axes=(-2, -1)).astype(np.float32)
    for ms in (None, 4):
        want = [np.asarray(v) for v in jshift.correlation_peaks_2d(
            jnp.asarray(corr), ms)]
        got = [v.numpy() for v in shift.correlation_peaks_2d(
            torch.as_tensor(corr), ms)]
        for g, w in zip(got, want):
            assert np.abs(g - w).max() <= 1e-4 * max(1.0, np.abs(w).max())


def test_correlation_index_and_matrix():
    a, b = _imgs(6, 4), _imgs(7, 4)
    assert np.abs(shift.correlation_index(a, b, **CPU).numpy()
                  - np.asarray(jshift.correlation_index(a, b))).max() <= 1e-5
    assert rel_err(shift.correlation_matrix(a, b, **CPU),
                   np.asarray(jshift.correlation_matrix(a, b))) <= 1e-4
    assert rel_err(shift.correlation_matrix(a[0], a[0], **CPU)[0, 16, 16],
                   (a[0] * a[0]).sum()) <= 1e-4


@pytest.mark.parametrize("kw", [
    {}, dict(stride=2), dict(nearest=True), dict(n_angles=128, stride=2),
    dict(radius_min=3, radius_max=10, n_angles=40)])
def test_cartesian_to_polar(kw):
    x = _imgs(8, 3, 32, 32, smooth=False)
    want = np.asarray(jpolar.cartesian_to_polar(x, **kw))
    got = polar.cartesian_to_polar(x, **kw, **CPU)
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-5
    assert rel_err(polar.cartesian_to_polar(x[0], **kw, **CPU), want[0]) <= 1e-5
    for a, b in zip(polar.polar_grid(32, 32, 2, 14, kw.get("n_angles")),
                    jpolar.polar_grid(32, 32, 2, 14, kw.get("n_angles"))):
        np.testing.assert_array_equal(a, b)


def test_polar_at_static_offsets_wraps_periodically():
    x = _imgs(9, 3, 32, 32, smooth=False)
    # the last offsets push the outer rings past the frame
    offsets = ((0.0, 0.0), (2.0, -1.5), (-4.0, 4.0), (6.0, 6.0))
    want = np.asarray(jpolar.polar_at_static_offsets(
        x, offsets, 2, 14, n_angles=64, stride=2))
    got = polar.polar_at_static_offsets(x, offsets, 2, 14, n_angles=64,
                                        stride=2, **CPU)
    assert got.shape == want.shape == (3, 4, 7, 64)
    assert rel_err(got, want) <= 1e-5
    clipped = polar.cartesian_to_polar(x, 2, 14, n_angles=64, stride=2, **CPU)
    assert rel_err(got[:, 0], clipped) <= 1e-6        # no offset: same grid


@pytest.mark.parametrize("n_angles", [None, 600])
def test_ring_ffts_and_best_rotation(n_angles):
    from xmipp3_tpu.ops.geo import rotate_2d
    ref = _imgs(10, 1)[0]
    angles = np.float32([12.0, -75.5, 140.0, 0.0])
    oth = np.asarray(rotate_2d(np.stack([ref] * 4), angles))
    p = np.asarray(jpolar.cartesian_to_polar(oth, n_angles=n_angles))
    f = np.asarray(jpolar.ring_ffts(jnp.asarray(p)))
    assert rel_err(polar.ring_ffts(p, **CPU), f) <= 1e-4
    f_ref = np.asarray(jpolar.ring_ffts(jpolar.cartesian_to_polar(
        ref, n_angles=n_angles)))
    want = np.asarray(jpolar.rotational_correlation(jnp.asarray(f_ref),
                                                    jnp.asarray(f)))
    got = polar.rotational_correlation(torch.as_tensor(np.array(f_ref)),
                                       torch.as_tensor(np.array(f)))
    assert rel_err(got, want) <= 1e-4
    want = [np.asarray(v) for v in jpolar.best_rotation(ref, oth,
                                                        n_angles=n_angles)]
    got = [v.numpy() for v in polar.best_rotation(ref, oth, n_angles=n_angles,
                                                  **CPU)]
    assert np.abs((got[0] - want[0] + 180) % 360 - 180).max() <= 1e-2
    assert rel_err(got[1], want[1]) <= 1e-4
    got2 = polar.best_rotation_from_ffts(torch.as_tensor(np.array(f_ref)),
                                         torch.as_tensor(np.array(f)))
    assert np.abs(got2[0].numpy() - got[0]).max() <= 1e-3
