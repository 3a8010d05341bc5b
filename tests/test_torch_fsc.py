"""The port's host and tensor helpers of the reconstruction slice against
the reference's: fsc_3d / fsc_resolution, frc_2d, frc_dpr_curves,
frc_rfactor and the resolution_fsc program, the shift phases, the blob
profiles, the slice coordinates and the exact Kaiser-Bessel window.

Curves are held to 1e-5 absolute (FRC, random-noise FRC), 1e-5 relative
(L2 error) and 1e-3 degrees (DPR, an amplitude-weighted mean of phase
differences); the r-factor to 1e-6 relative and to the golden 0.134661
(1e-5) from the port alone. The program's rows: the same labels, the
same number of shells, the values to the same tolerances."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_golden_wavelets_frc import _gtest_volumes
from test_torch_common import rel_err
from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu.core.geometry import euler_matrix
from xmipp3_tpu.ops import basis as jbasis
from xmipp3_tpu.ops import fourier as jfourier
from xmipp3_tpu.ops import fsc as jfsc
from xmipp3_tpu.ops import reconstruct as jrec
from xmipp3_tpu_torch.ops import basis as tbasis
from xmipp3_tpu_torch.ops import fourier as tfourier
from xmipp3_tpu_torch.ops import fsc as tfsc
from xmipp3_tpu_torch.ops import reconstruct as trec
from xmipp3_tpu_torch.core.image import save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.programs import get_program

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


@pytest.mark.parametrize("nbins", [None, 7])
def test_frc_2d_matches_reference(nbins):
    rng = np.random.default_rng(17)
    a = rng.standard_normal((40, 40)).astype(np.float32)
    b = (a + 0.7 * rng.standard_normal(a.shape)).astype(np.float32)
    jf, jc = jfsc.frc_2d(a, b, nbins=nbins)
    tf, tc = tfsc.frc_2d(a, b, nbins=nbins, device="cpu")
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-7)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)


def _hold_curves(got, want):
    assert set(got) == set(want)
    for k in ("freq", "freq_dig"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    for k in ("frc", "frc_noise"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["error_l2"], want["error_l2"], rtol=1e-5,
                               atol=1e-6 * np.abs(want["error_l2"]).max())
    np.testing.assert_allclose(got["dpr"], want["dpr"], rtol=0, atol=1e-3)


@pytest.mark.parametrize("do_dpr", [False, True])
@pytest.mark.parametrize("shape", [(36, 36), (20, 20, 20)])
def test_frc_dpr_curves_match_reference(shape, do_dpr):
    rng = np.random.default_rng(18)
    a = rng.standard_normal(shape).astype(np.float32)
    b = (a + 0.6 * rng.standard_normal(shape)).astype(np.float32)
    want = jfsc.frc_dpr_curves(a, b, 1.7, do_dpr)
    got = tfsc.frc_dpr_curves(a, b, 1.7, do_dpr, device="cpu")
    assert len(got["frc"]) == shape[-1] // 2 + 1
    _hold_curves(got, want)
    assert (got["dpr"] > 0).any() == do_dpr


def test_frc_rfactor_matches_reference_and_the_golden_value():
    v1, v2 = _gtest_volumes()
    assert abs(tfsc.frc_rfactor(v1, v2, min_freq=-2.0, max_freq=1.0,
                                device="cpu") - 0.134661) < 1e-5
    rng = np.random.default_rng(19)
    a = rng.standard_normal((16, 16, 16)).astype(np.float32)
    b = (a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
    for lo, hi in ((-2.0, 1.0), (0.1, 0.4)):
        assert tfsc.frc_rfactor(a, b, lo, hi, device="cpu") == \
            pytest.approx(float(jfsc.frc_rfactor(a, b, lo, hi)), rel=1e-6)


def _frc_rows(fn):
    md = MetaData(str(fn))
    return [md.getRow(i) for i in md]


def _hold_frc_files(got, want):
    g, w = _frc_rows(got), _frc_rows(want)
    assert len(g) == len(w) and set(g[0]) == set(w[0])
    tol = {"resolutionFRC": 1e-5, "resolutionFRCRandomNoise": 1e-5,
           "resolutionDPR": 1e-3}
    for k in w[0]:
        a = np.array([r[k] for r in g], float)
        b = np.array([r[k] for r in w], float)
        if k in tol:
            np.testing.assert_allclose(a, b, rtol=0, atol=tol[k], err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=k)
    rg, rw = (MetaData(f"rfactor@{f}").getColumn("resolutionRfactor")[0]
              for f in (got, want))
    assert rg == pytest.approx(rw, rel=1e-5, abs=1e-7)


@pytest.fixture(scope="module")
def fsc_inputs(tmp_path_factory):
    """tests/test_flag_surface_r3.py:157-196's inputs: a set of six noisy
    copies of an image (with poses, for the geometry on read) and two
    noisy copies of a volume."""
    d = tmp_path_factory.mktemp("fsc")
    rng = np.random.default_rng(5)
    n, m = 12, 16
    base = rng.standard_normal((m, n)).astype(np.float32)
    imgs = base[None] + 0.1 * rng.standard_normal((6, m, n)).astype(
        np.float32)
    save_image(str(d / "set.stk"), imgs)
    MetaData.fromRows([
        {"image": f"{i + 1:06d}@{d}/set.stk", "itemId": i + 1,
         "anglePsi": 10.0 * i, "shiftX": 0.5 * i, "shiftY": -0.25 * i,
         "flip": i % 2} for i in range(6)]).write(str(d / "set.xmd"))
    vol = rng.standard_normal((n, n, n)).astype(np.float32)
    save_image(str(d / "v1.vol"), vol)
    save_image(str(d / "v2.vol"), (vol + 0.05 * rng.standard_normal(
        vol.shape)).astype(np.float32))
    return d


FSC_FLAGS = {
    "set_dpr": "--set_of_images {d}/set.xmd --oroot {o}/half -s 2.0 "
               "--do_dpr",
    "set_no_geo": "--set_of_images {d}/set.xmd --oroot {o}/half -s 2.0 "
                  "--dont_apply_geo --threshold 0.5",
    "pair_rfactor": "--ref {d}/v1.vol -i {d}/v2.vol -o {o}/v.frc -s 1.0 "
                    "--do_rfactor --max_sam 4.0",
    "pair_band": "--ref {d}/v1.vol -i {d}/v2.vol -o {o}/v.frc -s 1.5 "
                 "--do_rfactor --do_dpr --min_sam 8.0 --max_sam 3.5",
}


@pytest.mark.parametrize("case", list(FSC_FLAGS))
def test_resolution_fsc_matches_the_reference_program(fsc_inputs, tmp_path,
                                                      case):
    outs = {}
    for side, prog, dev in (("ref", jax_program, []),
                            ("port", get_program, ["--device", "cpu"])):
        o = tmp_path / side
        o.mkdir()
        args = FSC_FLAGS[case].format(d=fsc_inputs, o=o).split() + dev
        program = prog("resolution_fsc")
        assert program.run_with_args(args + ["-v", "0"]) == 0
        outs[side] = (o / ("v.frc" if "pair" in case else "half.frc"),
                      program.resolution)
    _hold_frc_files(outs["port"][0], outs["ref"][0])
    assert outs["port"][1] == pytest.approx(outs["ref"][1], rel=1e-4)
