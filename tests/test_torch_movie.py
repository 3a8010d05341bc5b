"""The port's movie ops (xmipp3_tpu_torch.ops.movie) against the reference
package's ops/movie.py on the same numpy-seeded frames, on the CPU.

Tolerances: spectra 1e-5 of the max; sub-pixel shifts and trajectories
within 0.02 px (the parabola and the windowed DFT see float32 roundoff of
the spectra); peaks 1e-4 of the max; sums, kept stacks and warps 1e-4 of
the max; the float64 least-squares solve 1e-9; dose weights 1e-6; gains
1e-6 relative. The planted-motion check of tests/test_movie.py runs on the
port alone: its correction of measured positions undoes the planted drift.
"""
import numpy as np
import pytest
import torch

from test_torch_common import rel_err
from xmipp3_tpu.ops import movie as jm
from xmipp3_tpu_torch.ops import movie as tm
from xmipp3_tpu_torch.ops.fourier import fourier_shift_2d
from xmipp3_tpu_torch.ops.fourier_filter import (apply_fourier_mask_2d,
                                                 low_pass_mask)

torch.set_num_threads(1)
CPU = "cpu"
SHIFT_TOL = 0.02


def make_movie(n_frames=8, size=256, drift=(2.0, -1.5), seed=0, noise=1.0,
               width=None):
    """tests/test_movie.py's band-limited random scene drifting linearly
    plus per-frame noise, made with the port on the CPU; returns the frames
    and the true positions (gauge: mean zero)."""
    rng = np.random.default_rng(seed)
    W = size if width is None else width
    scene = rng.standard_normal((size, W)).astype(np.float32)
    scene = apply_fourier_mask_2d(scene, low_pass_mask(size, W, 0.2),
                                  device=CPU).numpy() * 10.0
    frames, pos = [], []
    for f in range(n_frames):
        dx, dy = drift[0] * f, drift[1] * f
        pos.append((dx, dy))
        fr = fourier_shift_2d(scene, dx, dy, device=CPU).numpy()
        frames.append(fr + noise * rng.standard_normal(fr.shape)
                      .astype(np.float32))
    pos = np.array(pos, np.float32)
    return np.stack(frames), pos - pos.mean(axis=0)


@pytest.fixture(scope="module")
def movie():
    return make_movie(n_frames=8, size=192, seed=3)


def test_frame_ffts_scaled_matches(movie):
    frames, _ = movie
    for corr_n in (192, 96):
        got = tm.frame_ffts_scaled(frames, corr_n, device=CPU)
        want = np.asarray(jm.frame_ffts_scaled(frames, corr_n))
        assert got.shape == want.shape
        assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("corr_n,ms", [(96, 6), (32, 8)])
def test_pairwise_shifts_match(movie, corr_n, ms):
    """(96, 6) takes the windowed DFT, (32, 8) the irfft2 path."""
    frames, _ = movie
    specs = np.asarray(jm.frame_ffts_scaled(frames, corr_n))
    want_s, want_pairs, want_p = (np.asarray(a) for a in
                                  jm.pairwise_shifts(specs, corr_n, ms))
    got_s, pairs, got_p = tm.pairwise_shifts(torch.tensor(specs), corr_n,
                                             ms)
    assert np.array_equal(pairs, want_pairs)
    assert np.abs(got_s.numpy() - want_s).max() <= SHIFT_TOL
    assert rel_err(got_p, want_p) <= 1e-4


def test_solve_frame_trajectory_is_the_reference():
    rng = np.random.default_rng(1)
    F = 7
    pairs = np.stack(np.triu_indices(F, k=1), axis=1)
    sh = rng.normal(size=(len(pairs), 2)).astype(np.float32)
    w = rng.uniform(0, 2, len(pairs)).astype(np.float32)
    for weights in (None, w):
        got = tm.solve_frame_trajectory(sh, pairs, F, weights)
        want = jm.solve_frame_trajectory(sh, pairs, F, weights)
        assert np.abs(got - want).max() <= 1e-9


@pytest.mark.parametrize("corr_n", [None, 64])
def test_global_align_matches(movie, corr_n):
    frames, true_pos = movie
    got = tm.global_align(frames, 20, corr_n=corr_n, device=CPU)
    want = jm.global_align(frames, 20, corr_n=corr_n)
    assert np.abs(got - want).max() <= SHIFT_TOL
    assert np.abs(got - true_pos).max() < 0.3


def test_global_align_non_square():
    frames, true_pos = make_movie(n_frames=6, size=128, width=160, seed=5)
    got = tm.global_align(frames, 16, device=CPU)
    assert np.abs(got - jm.global_align(frames, 16)).max() <= SHIFT_TOL


@pytest.mark.parametrize("dose", [False, True])
def test_shift_sum_frames_matches(movie, dose):
    frames, pos = movie
    F, H, W = frames.shape
    q = None
    if dose:
        q = np.asarray(jm.dose_filter(H, F, 1.5, 1.0))
    got = tm.shift_sum_frames(frames, -pos[:, 0], -pos[:, 1],
                              None if q is None else torch.as_tensor(q),
                              device=CPU)
    want = np.asarray(jm.shift_sum_frames(frames, -pos[:, 0], -pos[:, 1], q))
    assert rel_err(got, want) <= 1e-4


def test_shift_sum_frames_keep_matches(movie):
    frames, pos = movie
    got = tm.shift_sum_frames_keep(frames, -pos[:, 0], -pos[:, 1], device=CPU)
    want = np.asarray(jm.shift_sum_frames_keep(frames, -pos[:, 0],
                                               -pos[:, 1]))
    assert rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("avg", [1, 3])
def test_local_align_matches(avg):
    """Both forms of the local measurement: patches_avg 1 (integer roll +
    fractional phase in each patch spectrum) and 3 (full-frame correction
    + temporal box mean, the program's default)."""
    frames, _ = make_movie(n_frames=6, size=256, drift=(1.3, -0.7), seed=7,
                           noise=0.5)
    pos = jm.global_align(frames, 10)
    pos = pos + np.random.default_rng(2).uniform(-0.4, 0.4, pos.shape)
    want, cys, cxs = jm.local_align(frames, pos, patches=(3, 3),
                                    patch_size=96, max_shift_px=4,
                                    patches_avg=avg)
    got, gcys, gcxs = tm.local_align(frames, pos, patches=(3, 3),
                                     patch_size=96, max_shift_px=4,
                                     patches_avg=avg, device=CPU)
    assert np.array_equal(gcys, cys) and np.array_equal(gcxs, cxs)
    assert got.shape == want.shape == (3, 3, 6, 2)
    assert np.abs(got - want).max() <= SHIFT_TOL


def _field(seed, F, ny=3, nx=3):
    return np.random.default_rng(seed).uniform(
        -1.5, 1.5, (ny, nx, F, 2)).astype(np.float32)


@pytest.mark.parametrize("overlap", [0.5, 0.499])
def test_warp_paths_match_the_reference(overlap):
    """overlap 0.5 at tile multiples is the reference's 4-pass reshape
    path, 0.499 its scan path; both hold the same tile set, so the port's
    one implementation must match each (tests/test_movie.py:95)."""
    rng = np.random.default_rng(7)
    F, H, W = 4, 128, 128
    frames = rng.standard_normal((F, H, W)).astype(np.float32)
    cys = np.linspace(16, H - 17, 3).astype(int)
    cxs = np.linspace(16, W - 17, 3).astype(int)
    field = _field(8, F)
    got = tm.warp_sum_frames_tiled(frames, field, cys, cxs, tile=32,
                                   overlap=overlap, device=CPU)
    for path in (0.5, 0.499):
        want = np.asarray(jm.warp_sum_frames_tiled(frames, field, cys, cxs,
                                                   tile=32, overlap=path))
        assert rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("shape,tile", [((96, 120), 48), ((64, 64), 64)])
def test_warp_edge_tiles_match(shape, tile):
    """A tile set whose last tile is flush with the far edge, and one tile
    over the whole frame (no window)."""
    rng = np.random.default_rng(9)
    F = 3
    frames = rng.standard_normal((F,) + shape).astype(np.float32)
    cys = np.linspace(10, shape[0] - 11, 2).astype(int)
    cxs = np.linspace(10, shape[1] - 11, 3).astype(int)
    field = _field(4, F, 2, 3)
    want = np.asarray(jm.warp_sum_frames_tiled(frames, field, cys, cxs,
                                               tile=tile))
    got = tm.warp_sum_frames_tiled(frames, field, cys, cxs, tile=tile,
                                   device=CPU)
    assert rel_err(got, want) <= 1e-4


def test_warp_sum_frames_and_field_interpolation_match():
    rng = np.random.default_rng(11)
    F, H, W = 3, 40, 48
    frames = rng.standard_normal((F, H, W)).astype(np.float32)
    cys, cxs = np.array([5, 20, 34]), np.array([6, 23, 41])
    field = _field(12, F)
    maps = tm.interpolate_shift_field(field, cys, cxs, H, W)
    assert np.array_equal(maps, jm.interpolate_shift_field(field, cys, cxs,
                                                           H, W))
    got = tm.warp_sum_frames(frames, maps, device=CPU)
    want = np.asarray(jm.warp_sum_frames(frames, maps))
    assert rel_err(got, want) <= 1e-4


def test_warp_corrects_motion():
    """Carried over from tests/test_movie.py:117 on the port alone: with a
    zero local field the tiled warp equals the global correction
    shift_sum_frames(-pos), i.e. it UNDOES the planted positions, and the
    positions the port measures give an average closer to the scene than
    the raw mean."""
    frames, true_pos = make_movie(n_frames=6, size=256, noise=0.3)
    cys = np.linspace(64, 256 - 65, 3).astype(int)
    cxs = np.linspace(64, 256 - 65, 3).astype(int)
    total = np.broadcast_to(true_pos[None, None], (3, 3, 6, 2))
    warped = tm.warp_sum_frames_tiled(frames, np.ascontiguousarray(total),
                                      cys, cxs, tile=128, device=CPU).numpy()
    direct = tm.shift_sum_frames(frames, -true_pos[:, 0], -true_pos[:, 1],
                                 device=CPU).numpy()
    inner = (slice(32, -32), slice(32, -32))
    cc = lambda a, b: np.corrcoef(a[inner].ravel(), b[inner].ravel())[0, 1]
    assert cc(warped, direct) > 0.999
    assert cc(warped, direct) > cc(frames.mean(axis=0), direct) + 0.01
    measured = tm.global_align(frames, 20, device=CPU)
    assert np.abs(measured - true_pos).max() < 0.3
    corrected = tm.shift_sum_frames(frames, -measured[:, 0],
                                    -measured[:, 1], device=CPU).numpy()
    assert cc(corrected, direct) > 0.999
    assert cc(corrected, direct) > cc(frames.mean(axis=0), direct) + 0.01


def test_dose_filter_and_scalar_model_match():
    for kv, pre in ((300.0, 0.0), (200.0, 3.0)):
        got = tm.dose_filter(64, 5, 4.0, 1.2, pre, kv, device=CPU)
        want = np.asarray(jm.dose_filter(64, 5, 4.0, 1.2, pre, kv))
        assert rel_err(got, want) <= 1e-6
    for k, v in ((0.05, 300.0), (0.2, 200.0)):
        assert tm.critical_dose(k, v) == jm.critical_dose(k, v)
        nc = tm.critical_dose(k, v)
        assert tm.dose_filter_value(7.0, nc) == jm.dose_filter_value(7.0, nc)
        assert tm.optimal_dose(nc) == jm.optimal_dose(nc)
    with pytest.raises(ValueError):
        tm.voltage_scaling_factor(120.0)


def test_estimate_gain_matches():
    rng = np.random.default_rng(2)
    frames = 5.0 + rng.standard_normal((6, 64, 48)).astype(np.float32)
    assert rel_err(tm.estimate_gain(frames, device=CPU),
                   jm.estimate_gain(frames)) <= 1e-6


def _gain_movie(seed=4, F=4, H=40, W=56):
    """Poisson frames of a flat scene times a smooth column and row gain."""
    rng = np.random.default_rng(seed)
    g = (1 + 0.2 * np.sin(np.arange(W) / 5.0))[None, :] * \
        (1 + 0.1 * np.cos(np.arange(H) / 7.0))[:, None]
    return rng.poisson(20.0 * g, (F, H, W)).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(n_iter=2),
    dict(n_iter=1, sigma=1.0, frame_step=2),
    dict(n_iter=1, single_ref=True, max_sigma=1.5),
    dict(n_iter=1, sigma=0.0, gain0=True)])
def test_estimate_gain_histogram_matches(kw):
    """The rank-histogram gain in float64 on the device against the
    reference's host float64 (sigma searched, sigma given, a single
    reference histogram, an initial gain)."""
    frames = _gain_movie()
    if kw.pop("gain0", False):
        kw["gain0"] = np.random.default_rng(1).uniform(
            0.9, 1.1, frames.shape[1:])
    got = tm.estimate_gain_histogram(frames, device=CPU, **kw)
    want = jm.estimate_gain_histogram(frames, **kw)
    assert rel_err(got, want) <= 1e-6
