"""The port's host and tensor helpers of the reconstruction slice against
the reference's: fsc_3d / fsc_resolution, the shift phases, the blob
profiles, the slice coordinates and the exact Kaiser-Bessel window."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import rel_err
from xmipp3_tpu.core.geometry import euler_matrix
from xmipp3_tpu.ops import basis as jbasis
from xmipp3_tpu.ops import fourier as jfourier
from xmipp3_tpu.ops import fsc as jfsc
from xmipp3_tpu.ops import reconstruct as jrec
from xmipp3_tpu_torch.ops import basis as tbasis
from xmipp3_tpu_torch.ops import fourier as tfourier
from xmipp3_tpu_torch.ops import fsc as tfsc
from xmipp3_tpu_torch.ops import reconstruct as trec

torch.set_num_threads(1)


@pytest.mark.parametrize("nbins", [None, 10])
def test_fsc_3d_matches_reference(nbins):
    rng = np.random.default_rng(7)
    a = rng.standard_normal((32, 32, 32)).astype(np.float32)
    b = (a + 0.5 * rng.standard_normal(a.shape)).astype(np.float32)
    jf, jc = jfsc.fsc_3d(a, b, nbins=nbins)
    tf, tc = tfsc.fsc_3d(a, b, nbins=nbins, device="cpu")
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    assert tfsc.fsc_resolution(tf, tc) == pytest.approx(
        jfsc.fsc_resolution(np.asarray(jf), np.asarray(jc)), rel=1e-5)


def test_fsc_3d_of_identical_volumes_is_one():
    a = np.random.default_rng(8).standard_normal((16, 16, 16))
    f, c = tfsc.fsc_3d(a, a, device="cpu")
    np.testing.assert_allclose(c.numpy(), 1.0, atol=1e-5)
    assert tfsc.fsc_resolution(f, c, sampling=1.5) == 3.0


def test_shift_spec_2d_matches_reference():
    rng = np.random.default_rng(9)
    imgs = rng.standard_normal((4, 24, 24)).astype(np.float32)
    sx, sy = rng.uniform(-3, 3, (2, 4)).astype(np.float32)
    spec = np.fft.rfft2(imgs).astype(np.complex64)
    want = np.asarray(jfourier.shift_spec_2d(jnp.asarray(spec), sx, sy,
                                             24, 24))
    got = tfourier.shift_spec_2d(torch.tensor(spec), torch.tensor(sx),
                                 torch.tensor(sy), 24, 24)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [0, 2])
def test_blob_profiles_match_reference(m):
    r = np.linspace(0, 2.5, 101)
    np.testing.assert_allclose(tbasis.kaiser_value(r, 1.9, 15.0, m),
                               jbasis.kaiser_value(r, 1.9, 15.0, m),
                               rtol=1e-12, atol=0)
    w = np.linspace(0, 1.0, 101)
    np.testing.assert_allclose(tbasis.kaiser_fourier_value(w, 1.9, 15.0, m),
                               jbasis.kaiser_fourier_value(w, 1.9, 15.0, m),
                               rtol=1e-12, atol=0)


def test_slice_tap_coords_match_reference():
    rng = np.random.default_rng(10)
    mats = np.asarray(euler_matrix(*rng.uniform(0, 360, (3, 5))), np.float32)
    keep = jrec._disk_mask(16, 0.4)
    want = jrec._slice_tap_coords(jnp.asarray(mats), 16, 40, keep=keep)
    got = trec._slice_tap_coords(torch.tensor(mats), 16, 40, 0.4)
    for g, w in zip(got, want):
        assert g.shape == (5, int(keep.sum()))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    full = trec._slice_tap_coords(torch.tensor(mats), 16, 40)
    assert full[0].shape == (5, 16 * 9)


@pytest.mark.parametrize("order", [0, 2])
def test_kb_window_matches_reference(order):
    d2 = np.linspace(0, 5.0, 257).astype(np.float32)
    want = np.asarray(jrec._kb_window(jnp.asarray(d2), 1.9, 15.0, order))
    got = trec._kb_window(torch.tensor(d2), 1.9, 15.0, order)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("interp", ["nn", "tri", "tri+kb", "kb"])
def test_tap_footprints_match_reference(interp):
    for radius in (1.9, 2.5):
        assert trec._taps(interp, radius) == jrec._taps(interp, radius)
