"""The modules that only tests call, ported: core/numerics.py (host, a
copy), ops/steerable.py and ops/fringe.py (torch, on the CPU here), and
the functions that no program calls (ops/polar.py's polar_at_offsets,
polar_rings_reference and polar_weighted_stats; ops/fourier.py's FFT-size,
index and whole-plane helpers; ops/shift.py's align_translationally;
ops/basis.py's Blob family), against the reference package's on
numpy-seeded inputs.

Tolerances:
- numerics: equal (the same float64 host numpy and scipy);
- steerable basis and filter: 1e-5 of the max (float32 FFT passes);
- spth, orientation map, demodulation, normalize_wb, unwrap_phase: 1e-5
  of the max (float32 FFTs) where the quantity is smooth; the phases
  compared as angles (wrapped differences) on the pixels with modulation
  above a tenth of its max;
- simul_pattern and first_psd_zero: equal (host numpy in both);
- polar_at_offsets: equal (nearest samples); polar_rings_reference 1e-6
  of the max and its weighted stats 1e-6 relative (cubic B-spline taps in
  float32); the FFT helpers equal, the whole plane 1e-12; the shifts of
  align_translationally 1e-5, its images 1e-4; the Blob family equal
  (host numpy in both).
"""
import numpy as np
import pytest
import torch

from xmipp3_tpu.core import numerics as jnum
from xmipp3_tpu.ops import fringe as jfr
from xmipp3_tpu.ops import steerable as jst
from xmipp3_tpu_torch.core import numerics as tnum
from xmipp3_tpu_torch.ops import fringe as tfr
from xmipp3_tpu_torch.ops import steerable as tst

torch.set_num_threads(1)


def rel(got, want):
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_numerics_equal_the_reference():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((30, 4))
    x0 = np.array([1.0, -2.0, 0.5, 3.0])
    b = A @ x0 + 0.01 * rng.standard_normal(30)
    b[:6] += 20.0                                  # outliers
    w = rng.uniform(0.5, 2.0, 30)
    for f, args in ((lambda m: m.solve_linear_system, (A, b)),
                    (lambda m: m.solve_linear_system, (A, b, w)),
                    (lambda m: m.ransac_weighted_least_squares,
                     (A, b, w, 0.1))):
        assert np.array_equal(f(tnum)(*args), f(jnum)(*args))
    S = rng.standard_normal((6, 6))
    S = S + S.T
    M = rng.standard_normal((6, 6))
    B = M @ M.T + 6 * np.eye(6)
    for name, args in (("schur_decomposition", (S,)),
                       ("generalized_eigs", (S, B)),
                       ("first_eigs", (S, 3)), ("last_eigs", (S, 2))):
        for a, b_ in zip(getattr(tnum, name)(*args),
                         getattr(jnum, name)(*args)):
            assert np.array_equal(a, b_), name
    G = np.zeros((7, 7))
    G[0, 1] = G[1, 2] = G[4, 5] = 1.0
    assert np.array_equal(tnum.connected_components_undirected(G),
                          jnum.connected_components_undirected(G))


@pytest.mark.parametrize("kind", ["ridge", "wall"])
def test_steerable_filter_matches_the_reference(kind):
    rng = np.random.default_rng(1)
    vol = np.zeros((24, 20, 28), np.float32)
    vol[12, 10, 4:24] = 1.0
    vol[4:20, 6, 8] = 0.7
    vol += 0.05 * rng.standard_normal(vol.shape).astype(np.float32)
    assert rel(tst.steerable_basis_3d(vol, 1.5, device="cpu"),
               jst.steerable_basis_3d(vol, 1.5)) <= 1e-5
    assert rel(tst.steerable_filter_3d(vol, 1.5, 30.0, kind, device="cpu"),
               jst.steerable_filter_3d(vol, 1.5, 30.0, kind)) <= 1e-5


def fringes(n=96, seed=2):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n].astype(np.float64) - n // 2
    phase = 2 * np.pi * (6.0 * x / n) + 0.4 * np.sin(2 * np.pi * y / n)
    im = 5.0 + 0.01 * x + (2.0 + 0.5 * np.cos(np.pi * y / n)) \
        * np.cos(phase) + 0.05 * rng.standard_normal((n, n))
    return im.astype(np.float32), np.hypot(y, x) < 0.4 * n


def test_spth_orientation_and_demodulation_match_the_reference():
    im, _ = fringes()
    q_t = tfr.spth(im, device="cpu").numpy()
    q_j = np.asarray(jfr.spth(im))
    assert rel(q_t.real, q_j.real) <= 1e-5 and rel(q_t.imag, q_j.imag) \
        <= 1e-5
    assert rel(tfr.orientation_map(im, 2.0, device="cpu"),
               jfr.orientation_map(im, 2.0)) <= 1e-4
    ph_t, mod_t = (v.numpy() for v in tfr.demodulate(im, device="cpu"))
    ph_j, mod_j = (np.asarray(v) for v in jfr.demodulate(im))
    assert rel(mod_t, mod_j) <= 1e-5
    strong = mod_j > 0.1 * mod_j.max()
    d = np.angle(np.exp(1j * (ph_t - ph_j)))[strong]
    assert np.abs(d).max() <= 1e-3


def test_normalize_wb_and_unwrapping_match_the_reference():
    im, roi = fringes(seed=3)
    for a, b in zip(tfr.normalize_wb(im, 2.0, 30.0, roi, device="cpu"),
                    jfr.normalize_wb(im, 2.0, 30.0, roi)):
        assert rel(a, np.asarray(b)) <= 1e-5
    n = 80
    y, x = np.mgrid[0:n, 0:n].astype(np.float64) - n // 2
    true = 0.004 * (x ** 2 + 0.5 * y ** 2) + 0.05 * x
    wrapped = ((true + np.pi) % (2 * np.pi) - np.pi).astype(np.float32)
    q = np.exp(-(x ** 2 + y ** 2) / 400.0)
    for quality in (None, q):
        assert rel(tfr.unwrap_phase(wrapped, quality, device="cpu"),
                   np.asarray(jfr.unwrap_phase(wrapped, quality))) <= 1e-5


@pytest.mark.parametrize("kind", ["open", "closed", "closed_mod",
                                  "complex_open", "complex_closed"])
def test_simul_pattern_equals_the_reference(kind):
    coefs = [0.0, 0.5, -0.3, 0.2, 0.1] if kind.startswith("complex") \
        else None
    a = tfr.simul_pattern(kind, 40, 32, 0.1, 1.5, coefs,
                          np.random.default_rng(4))
    b = jfr.simul_pattern(kind, 40, 32, 0.1, 1.5, coefs,
                          np.random.default_rng(4))
    assert np.array_equal(a, b)


def test_first_psd_zero_equals_the_reference():
    n = 128
    y, x = np.mgrid[0:n, 0:n].astype(np.float64) - n // 2
    psd = np.where(np.hypot(y / 1.2, x) < 30.0, 1.0, 0.0) + 0.01
    for a, b in zip(tfr.first_psd_zero(psd, 8.0, 100.0, 48),
                    jfr.first_psd_zero(psd, 8.0, 100.0, 48)):
        assert np.array_equal(a, b)


# -- the functions that no program calls --------------------------------------

def test_polar_helpers_match_the_reference():
    import jax.numpy as jnp
    from xmipp3_tpu.ops import polar as jpol
    from xmipp3_tpu_torch.ops import polar as tpol
    rng = np.random.default_rng(5)
    imgs = rng.standard_normal((3, 32, 32)).astype(np.float32)
    offs = np.array([[0.0, 0.0], [1.5, -2.0], [-3.0, 0.5]], np.float32)
    got = tpol.polar_at_offsets(imgs, offs, 2, 12, 32, device="cpu")
    want = np.asarray(jpol.polar_at_offsets(jnp.asarray(imgs),
                                            jnp.asarray(offs), 2, 12, 32))
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    coeffs = rng.standard_normal((16, 16)).astype(np.float32)
    for mode in ("full", "half"):
        tr, trad = tpol.polar_rings_reference(coeffs, 1, 3, 7.5, 8.0, mode,
                                              device="cpu")
        jr, jrad = jpol.polar_rings_reference(jnp.asarray(coeffs), 1, 3,
                                              7.5, 8.0, mode)
        assert trad == jrad
        for a, b in zip(tr, jr):
            assert rel(a, np.asarray(b)) <= 1e-6
        ms_t = tpol.polar_weighted_stats(tr, trad, mode)
        ms_j = jpol.polar_weighted_stats(jr, jrad, mode)
        assert np.allclose(ms_t, ms_j, rtol=1e-6, atol=0)


def test_fourier_helpers_match_the_reference():
    from xmipp3_tpu.ops import fourier as jf
    from xmipp3_tpu_torch.ops import fourier as tf_
    for n in (1, 7, 97, 121, 1000):
        assert tf_.next_good_fft_size(n) == jf.next_good_fft_size(n)
        assert tf_.good_fft_sizes(n, 5) == jf.good_fft_sizes(n, 5)
    for dim in (7, 8):
        assert [tf_.fft_idx2digfreq(i, dim) for i in range(dim)] == \
            [jf.fft_idx2digfreq(i, dim) for i in range(dim)]
    rng = np.random.default_rng(6)
    for w in (10, 11):
        img = rng.standard_normal((2, 9, w))
        half = np.fft.rfft2(img)
        got = tf_.hermitian_full_from_half(torch.as_tensor(half), w).numpy()
        assert np.allclose(got, np.asarray(jf.hermitian_full_from_half(
            half, w)), atol=1e-12)
        assert np.allclose(got, np.fft.fft2(img), atol=1e-9)
        # the reference's jax array is complex64
        assert rel(tf_.center_fft_2d(got).numpy(),
                   np.asarray(jf.center_fft_2d(got))) <= 1e-6


def test_align_translationally_matches_the_reference():
    from xmipp3_tpu.ops import shift as jsh
    from xmipp3_tpu_torch.ops import shift as tsh
    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:32, 0:32].astype(np.float32) - 16
    ref = np.exp(-(x ** 2 + y ** 2) / 20) + 0.5 * np.exp(
        -((x - 6) ** 2 + y ** 2) / 5)
    others = np.stack([np.roll(ref, (2, -3), (0, 1)),
                       np.roll(ref, (-1, 4), (0, 1))]).astype(np.float32)
    others += 0.05 * rng.standard_normal(others.shape).astype(np.float32)
    got = tsh.align_translationally(ref.astype(np.float32), others, 6,
                                    device="cpu")
    want = jsh.align_translationally(ref.astype(np.float32), others, 6)
    for a, b in zip(got[1:], want[1:]):
        assert rel(a, np.asarray(b)) <= 1e-5
    assert rel(got[0], np.asarray(want[0])) <= 1e-4


def test_blob_family_equals_the_reference():
    from xmipp3_tpu.ops import basis as jb
    from xmipp3_tpu_torch.ops import basis as tb
    for kind in ("cc", "bcc", "fcc"):
        assert np.array_equal(tb.grid_points(kind, 8, 2.0),
                              jb.grid_points(kind, 8, 2.0))
    blob_t, blob_j = tb.Blob(2.5, 2, 9.0), jb.Blob(2.5, 2, 9.0)
    assert np.array_equal(tb.blob_footprint(blob_t, 0.8),
                          jb.blob_footprint(blob_j, 0.8))
    pts = tb.grid_points("bcc", 12, 4.0)
    coeffs = np.random.default_rng(8).uniform(0, 1, len(pts))
    vol = tb.blobs_to_voxels(coeffs, pts, blob_t, 16)
    assert np.array_equal(vol, jb.blobs_to_voxels(coeffs, pts, blob_j, 16))
    assert np.array_equal(tb.voxels_to_blobs(vol, pts, blob_t, n_iters=5),
                          jb.voxels_to_blobs(vol, pts, blob_j, n_iters=5))
