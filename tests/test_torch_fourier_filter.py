"""ops/fourier_filter.py of the port against the reference package on the
CPU: every mask generator (through FourierFilter, with its Å -> digital
conversion), the 3-D wedge and cone masks, the fused 2-D and 3-D mask
application, and sparsify.

Tolerances: masks <= 1e-5 * max (the port's masks are the reference's
numpy code; the CTF masks go through each package's float32 CTF), filtered
images <= 1e-5 * max. sparsify keeps the coefficients at or above each
image's k-th smallest magnitude. Conjugate coefficients share their
magnitude up to roundoff, so where the threshold is one of a pair whose
partner ranks just below it, float roundoff decides whether the partner
is kept: the port is held to a float64 numpy evaluation and to the
reference on the images without such a tie (the next smaller magnitude
more than 1e-4 relative below the threshold), 1e-5 * max.
"""
import numpy as np
import pytest
import torch

from test_torch_common import rel_err
from xmipp3_tpu.ops import fourier_filter as jff
from xmipp3_tpu_torch.core.image import save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.ops import fourier_filter as ff
from xmipp3_tpu_torch.ops.ctf import CTFDescription

torch.set_num_threads(1)
CPU = dict(device="cpu")
H, W = 32, 30


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ffilter")
    CTFDescription(sampling_rate=2.0, voltage=300, Cs=2.7, Q0=0.1,
                   defocusU=12000, defocusV=12800,
                   azimuthal_angle=30.0).write(str(d / "m.ctfparam"))
    freq = np.linspace(0, 0.25, 17)
    MetaData.fromRows({"resolutionFreq": float(f),
                       "resolutionFRC": float(np.exp(-20 * f))}
                      for f in freq).write(str(d / "fsc.xmd"))
    full = np.random.default_rng(3).uniform(0, 1, (H, W)).astype(np.float32)
    save_image(str(d / "filt.spi"), full)
    return d


FILTERS = [
    ("low_pass", ["0.2"], None), ("low_pass", ["8", "0.05"], 2.0),
    ("high_pass", ["0.1"], None), ("high_pass", ["10"], 2.0),
    ("band_pass", ["0.1", "0.3", "0.03"], None),
    ("stop_band", ["0.1", "0.3"], None),
    ("stop_lowbandx", ["0.05"], None), ("stop_lowbandy", ["0.05", "0.04"],
                                        None),
    ("gaussian", ["0.1"], None), ("real_gaussian", ["1.5"], None),
    ("bfactor", ["50"], 2.0), ("ctf", ["{d}/m.ctfparam"], None),
    ("ctfpos", ["{d}/m.ctfparam"], 1.5),
    ("ctfinv", ["{d}/m.ctfparam", "0.1"], None),
    ("ctfposinv", ["{d}/m.ctfparam"], None),
    ("ctfdef", ["300", "2.7", "0.1", "15000"], 2.0),
    ("ctfdefastig", ["200", "2.0", "0.07", "9000", "11000", "40"], 1.5),
    ("fsc", ["{d}/fsc.xmd"], 2.0), ("binary_file", ["{d}/filt.spi"], None)]


@pytest.mark.parametrize("kind,args,sampling", FILTERS,
                         ids=[f"{k}-{i}" for i, (k, _, _) in
                              enumerate(FILTERS)])
def test_filter_masks_and_application(files, kind, args, sampling):
    args = [a.format(d=files) for a in args]
    ours = ff.FourierFilter(kind, args, sampling=sampling)
    theirs = jff.FourierFilter(kind, args, sampling=sampling)
    m, want_m = ours.mask_2d(H, W), theirs.mask_2d(H, W)
    assert m.shape == want_m.shape == (H, W // 2 + 1)
    assert rel_err(m, want_m) <= 1e-5
    imgs = np.random.default_rng(5).standard_normal((4, H, W)).astype(
        np.float32)
    got = ours.apply(imgs, **CPU)
    assert got.device.type == "cpu"
    assert rel_err(got, np.asarray(theirs.apply(imgs))) <= 1e-5
    assert rel_err(ours.apply(torch.as_tensor(imgs[0])),
                   np.asarray(theirs.apply(imgs[0]))) <= 1e-5


def test_digital_conversion():
    f = ff.FourierFilter("low_pass", ["8"], sampling=2.0)
    assert f._digital(8.0) == 0.25 and f._digital(0.3) == 0.3
    assert ff.FourierFilter("low_pass", ["0.3"])._digital(8.0) == 8.0
    with pytest.raises(ValueError, match="unknown filter type"):
        ff.FourierFilter("nope", []).mask_2d(8, 8)


@pytest.mark.parametrize("mode", ["ctf", "ctfpos", "ctfinv", "ctfposinv"])
def test_ctf_mask(mode):
    from xmipp3_tpu.ops.ctf import CTFDescription as JCTF
    kw = dict(sampling_rate=1.5, voltage=200, Cs=2.0, Q0=0.07,
              defocusU=9000, defocusV=9900, azimuthal_angle=70.0)
    got = ff.ctf_mask(H, W, CTFDescription(**kw), mode, 0.2)
    want = jff.ctf_mask(H, W, JCTF(**kw), mode, 0.2)
    assert rel_err(got, want) <= 1e-5


def test_mask_generators_direct():
    for got, want in (
            (ff.raised_cosine_low(np.linspace(0, 0.6, 50), 0.2, 0.1),
             jff.raised_cosine_low(np.linspace(0, 0.6, 50), 0.2, 0.1)),
            (ff.fsc_profile_mask(H, W, [0, 0.2, 0.5], [1, 0.5, 0.1]),
             jff.fsc_profile_mask(H, W, [0, 0.2, 0.5], [1, 0.5, 0.1]))):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dims", [(12, 14, 16), (9, 10, 11)])
def test_wedge_cone_masks_and_3d_application(dims):
    for got, want in (
            (ff.wedge_mask_3d(*dims, -60, 60), jff.wedge_mask_3d(*dims, -60,
                                                                  60)),
            (ff.wedge_mask_3d(*dims, -45, 30, 10, 20, 30),
             jff.wedge_mask_3d(*dims, -45, 30, 10, 20, 30)),
            (ff.cone_mask_3d(*dims, 30), jff.cone_mask_3d(*dims, 30))):
        np.testing.assert_array_equal(got, want)
    vol = np.random.default_rng(6).standard_normal(dims).astype(np.float32)
    mask = jff.wedge_mask_3d(*dims, -60, 60)
    assert rel_err(ff.apply_fourier_mask_3d(vol, mask, **CPU),
                   np.asarray(jff.apply_fourier_mask_3d(vol, mask))) <= 1e-5


def test_apply_fourier_mask_2d_large():
    """Above 256 px the reference takes its FFT path, not the table one."""
    imgs = np.random.default_rng(7).standard_normal((2, 260, 258)).astype(
        np.float32)
    mask = ff.low_pass_mask(260, 258, 0.2)
    assert rel_err(ff.apply_fourier_mask_2d(imgs, mask, **CPU),
                   np.asarray(jff.apply_fourier_mask_2d(imgs, mask))) <= 1e-5


def _sparsify64(x, p):
    s = np.fft.fft2(x.astype(np.float64))
    m = np.abs(s).reshape(len(x), -1)
    k = int(m.shape[1] * p)
    srt = np.sort(m, 1)
    t = srt[:, k]
    out = np.real(np.fft.ifft2(np.where(np.abs(s) >= t[:, None, None], s, 0)))
    return out, srt[:, k] - srt[:, k - 1] > 1e-4 * t


@pytest.mark.parametrize("p", [0.5, 0.9, 0.975])
def test_sparsify(p):
    x = np.random.default_rng(8).standard_normal((10, H, W)).astype(
        np.float32)
    got = ff.sparsify(x, p, **CPU).numpy()
    want64, clear = _sparsify64(x, p)
    assert clear.sum() >= 3
    assert rel_err(got[clear], want64[clear]) <= 1e-5
    want = np.asarray(jff.sparsify(x, p))
    assert rel_err(got[clear], want[clear]) <= 1e-5
    first = int(np.argmax(clear))
    assert rel_err(ff.sparsify(x[first], p, **CPU), want64[first]) <= 1e-5
    via = ff.FourierFilter("sparsify", [str(p)]).apply(x, **CPU)
    np.testing.assert_array_equal(via.numpy(), got)
