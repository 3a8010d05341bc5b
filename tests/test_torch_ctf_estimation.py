"""The port's staged CTF estimator (models/ctf_estimation.py) against the
reference package on the CPU, on the reference's synthetic PSDs
(tests/test_ctf_flag_surface.py's recipe at n=128, 2 A/px, defocus
12,000 / 10,500 A at 40 degrees): the whole fit and each estimator flag of
that file's surface
(--fastDefocus, --noDefocus, --radial_noise, --model_simplification,
--bootstrapFit, --refine_amplitude_contrast), the 1-D variant, the plane
fit and the lockstep batch. Each fit runs once per package (module
fixtures) and several tests read it; the lockstep batch runs the fast
stages. The whole fit from --fastDefocus's seeds runs through the program
(tests/test_torch_cli_ctf_estimate.py); here its initialiser alone.

Held to: every fitted defocus within 1 % of the reference's, and within
the reference's own limits of the truth (2 % and 5 degrees for the whole
fit, 5 % for the constrained ones, 10 % for the fast initialiser alone,
15 % for every bootstrap sample); the structural properties of each flag
exactly (tied noise parameters, removed terms, a kept initial defocus);
the plane fit exactly (float64 least squares on the host in both).
"""
import numpy as np
import pytest
import torch

from test_torch_common import synthetic_psd
from xmipp3_tpu.models import ctf_estimation as jce
from xmipp3_tpu_torch.models import ctf_estimation as ce

torch.set_num_threads(1)
N, TS = 128, 2.0
TRUTH = (12000.0, 10500.0, 40.0)
ARGS = (TS, 300, 2.7, 0.07)


def _close(got, want, tol=0.01):
    return abs(got - want) <= tol * abs(want)


def _both(psd, q0=0.07, **kw):
    """(port estimator, reference estimator), each after estimate()."""
    out = []
    for mod, extra in ((ce, dict(device="cpu")), (jce, {})):
        est = mod.CTFEstimator(psd, TS, 300, 2.7, q0, **kw, **extra)
        est.ctf = est.estimate()
        out.append(est)
    return out


@pytest.fixture(scope="module")
def psd():
    return synthetic_psd(N, TS, *TRUTH)


@pytest.fixture(scope="module")
def whole(psd):
    return _both(psd[0])


def test_whole_fit_matches_the_reference_and_the_truth(psd, whole):
    true = psd[1]
    port, ref = (e.ctf for e in whole)
    for attr in ("defocusU", "defocusV"):
        assert _close(getattr(port, attr), getattr(ref, attr)), attr
        assert _close(getattr(port, attr), getattr(true, attr), 0.02), attr
    d = abs(port.azimuthal_angle - true.azimuthal_angle)
    assert min(d, 180 - d) < 5.0
    d = abs(port.azimuthal_angle - ref.azimuthal_angle)
    assert min(d, 180 - d) < 1.0
    assert port.defocusU >= port.defocusV
    assert 0 <= port.azimuthal_angle < 180
    assert port.base_line >= 0 and port.sqrt_K >= 0 and port.gaussian_K >= 0
    assert abs(whole[0].final_fitness - whole[1].final_fitness) <= 1e-3


@pytest.fixture(scope="module")
def flags(psd):
    """Each estimator flag of the reference's flag surface, fitted by both
    packages."""
    p = psd[0]
    return {
        "noDefocus": _both(p, no_defocus=True,
                           initial_defocus=(16000.0, 16000.0, 0.0),
                           fast=True),
        "radial_noise": _both(p, radial_noise=True),
        "model_simplification": _both(p, model_simplification=2),
        "refine_amplitude_contrast": _both(p, q0=0.05, fast=True,
                                           refine_Q0=True),
        "bootstrapFit": _both(p, fast=True),
    }


@pytest.mark.parametrize("flag,truth_tol", [
    ("noDefocus", None), ("radial_noise", 0.05),
    ("model_simplification", 0.05), ("refine_amplitude_contrast", 0.05),
    ("bootstrapFit", 0.05)])
def test_flag_fit_matches_the_reference(psd, flags, flag, truth_tol):
    port, ref = flags[flag]
    for attr in ("defocusU", "defocusV"):
        assert _close(getattr(port.ctf, attr), getattr(ref.ctf, attr)), \
            (flag, attr, getattr(port.ctf, attr), getattr(ref.ctf, attr))
        if truth_tol:
            assert _close(getattr(port.ctf, attr), getattr(psd[1], attr),
                          truth_tol), (flag, attr)


def test_flag_structure_is_the_reference_s(flags):
    ctf = flags["noDefocus"][0].ctf
    assert ctf.defocusU == 16000.0 and ctf.defocusV == 16000.0
    ctf = flags["radial_noise"][0].ctf
    assert ctf.sqU == ctf.sqV and ctf.sigmaU == ctf.sigmaV \
        and ctf.cU == ctf.cV
    ctf = flags["model_simplification"][0].ctf
    assert ctf.gaussian_K2 == 0.0 and ctf.DeltaF == 0.0 and ctf.DeltaR == 0.0
    port, ref = flags["refine_amplitude_contrast"]
    assert 0.005 <= port.consts[3] <= 0.6
    assert abs(port.consts[3] - ref.consts[3]) <= 1e-6


def test_fast_defocus_initialiser_matches_the_reference(psd):
    """The ring demodulation alone (reference estimate_defoci_Zernike
    role): seeds within 10 % of the truth, the refined winner within 1 %
    of the reference's."""
    got = []
    for mod, extra in ((ce, dict(device="cpu")), (jce, {})):
        est = mod.CTFEstimator(psd[0], TS, 300, 2.7, 0.07,
                               fast_defocus=(2.0, 10), **extra)
        est.fit_background()
        est.fit_gaussian1()
        assert est.fast_defocus_zernike()
        got.append(0.5 * (est.params[0] + est.params[1]))
    true_avg = 0.5 * (psd[1].defocusU + psd[1].defocusV)
    assert _close(got[0], true_avg, 0.10)
    assert _close(got[0], got[1])


def test_bootstrap_samples_match_the_reference(psd, flags):
    port, ref = flags["bootstrapFit"]
    got = port.bootstrap_fit(4, seed=1)
    want = ref.bootstrap_fit(4, seed=1)
    assert got.shape == (4, 3)
    assert np.all(np.abs(got[:, 0] - psd[1].defocusU) / psd[1].defocusU
                  < 0.15)
    assert np.all(np.abs(got[:, :2] - want[:, :2]) <= 0.01 * want[:, :2])


def test_1d_variant_matches_the_reference():
    p, _ = synthetic_psd(N, TS, 11000.0, 11000.0, 0.0)
    got = ce.estimate_ctf_1d(p, *ARGS, device="cpu")
    want = jce.estimate_ctf_1d(p, *ARGS)
    assert got.defocusU == got.defocusV
    assert _close(got.defocusU, 11000.0, 0.05)
    assert _close(got.defocusU, want.defocusU)


def test_defocus_plane_fit_is_exact():
    rng = np.random.default_rng(0)
    xs = rng.uniform(0, 4000, 20)
    ys = rng.uniform(0, 4000, 20)
    v = 15000.0 + 0.5 * xs - 0.25 * ys
    got = ce.fit_defocus_plane(xs, ys, v)
    assert np.array_equal(got, jce.fit_defocus_plane(xs, ys, v))
    assert abs(got[0] - 15000) < 1e-6 * 15000
    assert abs(got[1] - 0.5) < 1e-8 and abs(got[2] + 0.25) < 1e-8


def test_lockstep_batch_matches_the_reference():
    truths = [(12000.0, 10500.0, 30.0), (9000.0, 8200.0, 120.0)]
    psds = [synthetic_psd(N, TS, u, v, a, seed=3 + k)[0]
            for k, (u, v, a) in enumerate(truths)]
    got = ce.estimate_ctf_batch(psds, *ARGS, fast=True, device="cpu")
    want = jce.estimate_ctf_batch(psds, *ARGS, fast=True)
    for g, w, (u, v, _) in zip(got, want, truths):
        assert _close(g.defocusU, w.defocusU) and \
            _close(g.defocusV, w.defocusV)
        assert _close(g.defocusU, u, 0.02) and _close(g.defocusV, v, 0.02)
