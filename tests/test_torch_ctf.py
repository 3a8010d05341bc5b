"""The port's CTF model (xmipp3_tpu_torch.ops.ctf) against the reference's
on the CPU, and the golden CTF values from the port alone.

Held to (measured agreement in brackets, N=64 grids):
- CTF values (pure_at, generate_2d, damping_2d, ctf_pure_batched):
  2e-5 absolute [<= 3e-6]. Both packages evaluate float32 sin/cos of
  arguments up to ~80 rad with different libraries, so agreement is
  absolute, about an ulp of the argument, not relative.
- argument_at: 1e-6 relative to the largest |chi| [~1e-7]; noise_at and
  the Bessel polynomial: 1e-6 relative.
- Filtered images (apply_ctf, wiener_filter_2d): 1e-5 * max [~1e-6].
  phase_flip: the sign tables equal wherever |c| > 1e-5, and the images
  within 1e-4 * max — a sample at a zero crossing may take the other sign
  in the other package, and changes the image by up to 2 * its
  coefficient [no such sample on these grids: ~1e-6].
- gridding_ctf_factors at the default minCTF (0.01): no sample with
  ||c| - minCTF| > 1e-5 takes the other branch; the data factors agree to
  1e-3 relative there (1/c amplifies the CTF's absolute error by 1/c);
  the weight factors to 2e-5 absolute.
- The golden values of tests/test_golden_ctf.py, from the port alone:
  7121.4971 (rel 1e-5), 7.6852355 (rel 1e-6), 13.921659 (abs 1e-5), and
  the phase-flip delta statistics (abs 1e-4).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from xmipp3_tpu.ops import ctf as J
from xmipp3_tpu_torch.ops import ctf as T

torch.set_num_threads(1)

# tests/test_golden_ctf.py:15-38, one set with every envelope term and the
# noise background, and one with a phase plate
SETS = {
    "golden_a": dict(sampling_rate=2.1, voltage=300, defocusU=5000,
                     defocusV=10000, azimuthal_angle=-45, Cs=2, Q0=0.1),
    "golden_b": dict(sampling_rate=2.1, voltage=300, defocusU=10000,
                     defocusV=10000, azimuthal_angle=45, Cs=2, Q0=0.1),
    "golden_c": dict(sampling_rate=2, voltage=300, defocusU=6000,
                     defocusV=7500, azimuthal_angle=45, Cs=2, Q0=0.1),
    "golden_d": dict(sampling_rate=2, voltage=300, defocusU=10000,
                     defocusV=5400, azimuthal_angle=45, Cs=2, Q0=0.1),
    "envelope": dict(sampling_rate=1.5, voltage=200, defocusU=18000,
                     defocusV=14000, azimuthal_angle=35.0, Cs=2.0, Ca=2.0,
                     espr=0.8, ispr=1.2, alpha=0.1, DeltaF=40.0,
                     DeltaR=3.0, Q0=0.1, K=1.2, envR0=0.02, envR1=0.1,
                     envR2=0.3, base_line=0.1, gaussian_K=2.0, sigmaU=30.0,
                     sigmaV=40.0, cU=0.05, cV=0.07, gaussian_angle=20.0,
                     sqrt_K=1.5, sqU=4.0, sqV=5.0, sqrt_angle=10.0,
                     gaussian_K2=0.5, sigmaU2=20.0, sigmaV2=25.0, cU2=0.1,
                     cV2=0.12, gaussian_angle2=70.0, bgR1=0.3, bgR2=0.2,
                     bgR3=0.1),
    "vpp": dict(sampling_rate=1.0, voltage=300, defocusU=20000,
                defocusV=19000, azimuthal_angle=120.0, Cs=2.7, Q0=0.07,
                phase_shift=1.2, VPP_radius=0.005),
}
CTF_ATOL = 2e-5


def _pair(name, **over):
    kw = dict(SETS[name], **over)
    return J.CTFDescription(**kw), T.CTFDescription(**kw)


def _freqs(seed=0, fmax=0.5):
    """Random digital frequencies on a 64 x 64 array (the shape of the
    centred grids: the reference compiles each op once per shape), with
    the origin and two axis points among them."""
    rng = np.random.default_rng(seed)
    fx, fy = rng.uniform(-fmax, fmax, (2, 64, 64)).astype(np.float32)
    fx[0, :3] = [0.0, 0.0, 0.2]
    fy[0, :3] = [0.0, 0.3, 0.0]
    return fx, fy


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("damped", [True, False])
@pytest.mark.parametrize("name", list(SETS))
def test_pure_at_matches_reference(name, damped):
    j, t = _pair(name)
    fx, fy = _freqs()
    fx, fy = fx / j.sampling_rate, fy / j.sampling_rate
    want = np.asarray(j.pure_at(fx, fy, damped=damped))
    got = t.pure_at(fx, fy, damped=damped, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=CTF_ATOL)


@pytest.mark.parametrize("damped", [True, False])
@pytest.mark.parametrize("layout", ["rfft", "centred"])
@pytest.mark.parametrize("name", list(SETS))
def test_generate_2d_matches_reference(name, layout, damped):
    j, t = _pair(name)
    rf = layout == "rfft"
    for h, w in ((64, 64),) + (((48, 63),) if name == "golden_d" else ()):
        want = np.asarray(j.generate_2d(h, w, rfft_layout=rf, damped=damped))
        got = _np(t.generate_2d(h, w, rfft_layout=rf, damped=damped,
                                device="cpu"))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=CTF_ATOL)
    if rf:  # the self-conjugate columns are symmetric: real filters stay real
        m = _np(t.generate_2d(64, 64, device="cpu"))
        for col in (0, -1):
            np.testing.assert_array_equal(
                m[1:, col], m[1:, col][::-1])


@pytest.mark.parametrize("name", ["envelope", "vpp", "golden_d"])
def test_damping_argument_noise_match_reference(name):
    j, t = _pair(name)
    for rf in (True, False):
        np.testing.assert_allclose(
            _np(t.damping_2d(64, 64, rfft_layout=rf, device="cpu")),
            np.asarray(j.damping_2d(64, 64, rfft_layout=rf)), rtol=0,
            atol=CTF_ATOL)
    fx, fy = _freqs(1)
    fx, fy = fx / j.sampling_rate, fy / j.sampling_rate
    want = np.asarray(j.argument_at(fx, fy))
    np.testing.assert_allclose(_np(t.argument_at(fx, fy, device="cpu")),
                               want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    want = np.asarray(j.noise_at(fx, fy))
    np.testing.assert_allclose(_np(t.noise_at(fx, fy, device="cpu")), want,
                               rtol=1e-6, atol=1e-6 * np.abs(want).max())
    assert t.first_zero_freq(device="cpu") == pytest.approx(
        j.first_zero_freq(), rel=1e-6)


def test_bessel_j0_and_sinc_match_reference():
    """The Abramowitz-Stegun polynomial, copied for parity (not
    torch.special.bessel_j0), on both branches; and torch.sinc, like
    jnp.sinc, is the normalised sin(pi x) / (pi x)."""
    x = np.concatenate([np.linspace(0, 60, 6001), -np.linspace(0, 20, 51),
                        [7.999999, 8.0, 8.000001]]).astype(np.float32)
    want = np.asarray(J._bessel_j0(jnp.asarray(x)))
    got = _np(T._bessel_j0(torch.tensor(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    s = np.array([0.0, 0.25, 0.5, 1.0, 1.5, 3.7], np.float32)
    np.testing.assert_allclose(_np(torch.sinc(torch.tensor(s))),
                               np.asarray(jnp.sinc(s)), atol=1e-7)
    assert float(torch.sinc(torch.tensor(0.5))) == pytest.approx(2 / np.pi)


# -- the golden values (tests/test_golden_ctf.py), from the port alone -------

def test_golden_error_between_2ctfs():
    c1 = T.CTFDescription(**SETS["golden_a"])
    c2 = T.CTFDescription(**SETS["golden_b"])
    err = T.error_between_2ctfs(c1, c2, 256, 0.05, 0.25, device="cpu")
    assert err == pytest.approx(7121.4971, rel=1e-5)


def test_golden_error_max_freq_ctfs():
    c = T.CTFDescription(**SETS["golden_c"])
    assert T.error_max_freq_ctfs(c, np.pi / 2) == pytest.approx(7.6852355,
                                                                rel=1e-6)


def test_golden_error_max_freq_ctfs_2d():
    c1 = T.CTFDescription(**SETS["golden_d"])
    c2 = T.CTFDescription(sampling_rate=2, voltage=300, defocusU=5000,
                          defocusV=5000, azimuthal_angle=45, Cs=2, Q0=0.1)
    res = T.error_max_freq_ctfs_2d(c1, c2, 256, np.pi / 2, device="cpu")
    assert res == pytest.approx(13.921659080780355, abs=1e-5)


def test_golden_phase_flip_delta_stats():
    c = T.CTFDescription(sampling_rate=1, voltage=300, defocusU=20000,
                         defocusV=20000, Cs=2, Q0=0.1, K=1.0)
    img = np.zeros((256, 256), np.float32)
    img[128, 128] = 1.0
    out = _np(T.phase_flip(img[None], c, device="cpu"))[0]
    assert out.std() == pytest.approx(0.003906, abs=1e-4)
    assert out.max() == pytest.approx(0.017565, abs=1e-4)
    shown = T.generate_image_with_2ctfs(c, c, 64, device="cpu")
    np.testing.assert_allclose(shown, J.generate_image_with_2ctfs(
        J.CTFDescription(**dataclasses.asdict(c)),
        J.CTFDescription(**dataclasses.asdict(c)), 64), atol=CTF_ATOL)


# -- batched application ------------------------------------------------------

def _imgs(seed=3, B=2, H=64, W=64):
    return np.random.default_rng(seed).standard_normal((B, H, W)) \
        .astype(np.float32)


@pytest.mark.parametrize("absPhase", [False, True])
def test_apply_ctf_matches_reference(absPhase):
    j, t = _pair("envelope")
    x = _imgs()
    want = np.asarray(J.apply_ctf(x, j, absPhase=absPhase))
    got = _np(T.apply_ctf(x, t, absPhase=absPhase, device="cpu"))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    single = _np(T.apply_ctf(x[0], t, absPhase=absPhase, device="cpu"))
    np.testing.assert_allclose(single, got[0], atol=1e-6)


@pytest.mark.parametrize("name", ["golden_a", "vpp", "envelope"])
def test_phase_flip_matches_reference(name):
    j, t = _pair(name)
    x = _imgs(4)
    c = np.asarray(j.generate_2d(64, 64, damped=False))
    sign_j = np.where(np.sign(c) == 0, 1.0, np.sign(c))
    ct = _np(t.generate_2d(64, 64, damped=False, device="cpu"))
    sign_t = np.where(np.sign(ct) == 0, 1.0, np.sign(ct))
    away = np.abs(c) > 1e-5
    np.testing.assert_array_equal(sign_t[away], sign_j[away])
    want = np.asarray(J.phase_flip(x, j))
    got = _np(T.phase_flip(x, t, device="cpu"))
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    # the planted change: flipping a CTF-modulated image leaves |CTF|
    np.testing.assert_allclose(
        _np(T.phase_flip(T.apply_ctf(x, t, device="cpu"), t)),
        _np(T.apply_ctf(x, t, absPhase=True, device="cpu")), atol=1e-5)


WIENER = {"pad1": dict(pad=1.0), "pad2": dict(pad=2.0),
          "wc_neg": dict(wiener_constant=-1.0, pad=2.0),
          "isotropic": dict(isIsotropic=True, pad=1.0),
          "flipped": dict(phase_flipped=True, pad=2.0),
          "envelope": dict(correct_envelope=True, wiener_constant=0.05)}


@pytest.mark.parametrize("case", list(WIENER))
def test_wiener_filter_2d_matches_reference(case):
    j, t = _pair("golden_d")
    x = _imgs(5)
    want = np.asarray(J.wiener_filter_2d(x, j, **WIENER[case]))
    got = _np(T.wiener_filter_2d(x, t, device="cpu", **WIENER[case]))
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_per_row_ctfs_equal_the_single_form():
    """generate_2d_rows gives each description's generate_2d bit for bit,
    so the batched per-row filters equal the one-image-at-a-time ones."""
    ctfs = [T.CTFDescription(**SETS[n]) for n in ("golden_a", "vpp",
                                                  "envelope", "golden_c")]
    for rf in (True, False):
        for damped in (True, False):
            rows = T.generate_2d_rows(ctfs, 32, 32, rf, damped, "cpu")
            for k, c in enumerate(ctfs):
                torch.testing.assert_close(
                    rows[k], c.generate_2d(32, 32, rf, damped, "cpu"),
                    rtol=0, atol=0)
    x = _imgs(6, len(ctfs), 32, 32)
    for op, kw in ((T.phase_flip, {}), (T.apply_ctf, {}),
                   (T.wiener_filter_2d, dict(wiener_constant=-1, pad=2))):
        batched = _np(op(x, ctfs, device="cpu", **kw))
        for k, c in enumerate(ctfs):
            np.testing.assert_allclose(
                batched[k], _np(op(x[k], c, device="cpu", **kw)), rtol=0,
                atol=1e-6 * np.abs(batched[k]).max())
    with pytest.raises(ValueError, match="descriptions"):
        T.phase_flip(x, ctfs[:2], device="cpu")


# -- parameter carriage, batched CTFs and the gridding factors ---------------

def _descs(pkg):
    return [pkg.CTFDescription(**SETS[n]) for n in SETS]


def test_ctf_params_arrays_from_descriptions_and_rows():
    rows = [{lbl: getattr(d, attr) for attr, lbl in
             T.CTFDescription._MD_MAP.items()} for d in _descs(T)]
    rows[0] = {k: v for k, v in rows[0].items() if k != "ctfK"}  # default
    for src in (_descs, lambda pkg: rows):
        want = J.ctf_params_arrays(src(J))
        got = T.ctf_params_arrays(src(T))
        assert list(got) == list(J.CTF_PURE_FIELDS) == list(want)
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k])


def _kept_grid(N=64, Ts=2.0):
    fy = np.fft.fftfreq(N).astype(np.float32)[:, None]
    fx = np.fft.rfftfreq(N).astype(np.float32)[None, :]
    keep = np.sqrt(fx ** 2 + fy ** 2) <= 0.5
    FX = np.broadcast_to(fx, keep.shape)[keep] / np.float32(Ts)
    FY = np.broadcast_to(fy, keep.shape)[keep] / np.float32(Ts)
    return FX, FY


@pytest.mark.parametrize("damped", [True, False])
def test_ctf_pure_batched_matches_reference(damped):
    p = J.ctf_params_arrays(_descs(J))
    FX, FY = _kept_grid()
    want = np.asarray(J.ctf_pure_batched(FX, FY, p, damped=damped))
    got = _np(T.ctf_pure_batched(FX, FY, p, damped=damped, device="cpu"))
    assert got.shape == want.shape == (len(SETS), FX.size)
    np.testing.assert_allclose(got, want, rtol=0, atol=CTF_ATOL)


@pytest.mark.parametrize("phase_flipped", [False, True])
@pytest.mark.parametrize("min_ctf", [0.01, 0.1])
def test_gridding_ctf_factors_match_reference(min_ctf, phase_flipped):
    """Compare the CTF values first, then the factors away from the
    threshold band ||c| - minCTF| <= 1e-5: there no sample may take the
    other branch of 1/c against sgn(c)."""
    p = J.ctf_params_arrays(_descs(J))
    FX, FY = _kept_grid()
    cj = np.asarray(J.ctf_pure_batched(FX, FY, p))
    ct = T.ctf_pure_batched(FX, FY, p, device="cpu")
    np.testing.assert_allclose(_np(ct), cj, rtol=0, atol=CTF_ATOL)
    dj, wj = (np.asarray(a) for a in
              J.gridding_ctf_factors(cj, min_ctf, phase_flipped))
    dt, wt = (_np(a) for a in
              T.gridding_ctf_factors(ct, min_ctf, phase_flipped))
    away = np.abs(np.abs(cj) - min_ctf) > 1e-5
    assert away.mean() > 0.99
    branch_j = np.abs(cj) < min_ctf
    branch_t = _np(ct.abs() < min_ctf)
    assert int((branch_j != branch_t)[away].sum()) == 0
    assert (np.abs(dt - dj)[away] <= 1e-3 * np.abs(dj)[away]).all()
    assert (np.abs(wt - wj)[away] <= CTF_ATOL).all()
    # the branches themselves, on values both packages hold exactly
    c = np.array([0.8, -0.5, 0.005, -0.003, np.nan, 0.0], np.float32)
    for got, want in zip(T.gridding_ctf_factors(c, 0.01, phase_flipped,
                                                device="cpu"),
                         J.gridding_ctf_factors(c, 0.01, phase_flipped)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_ctfparam_files_read_back_in_the_other_package(tmp_path, writer):
    kw = SETS["envelope"]
    fn = str(tmp_path / "m.ctfparam")
    (T if writer == "port" else J).CTFDescription(**kw).write(fn)
    reader = J if writer == "port" else T
    back = reader.CTFDescription.from_metadata(fn)
    defaults = {f.name: f.default for f in dataclasses.fields(
        T.CTFDescription)}
    for attr in T.CTFDescription._MD_MAP:      # the fields a file carries
        assert getattr(back, attr) == pytest.approx(
            float(kw.get(attr, defaults[attr])), rel=1e-9), attr
