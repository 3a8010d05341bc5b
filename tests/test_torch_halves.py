"""Every function of the port's ops/halves_restoration.py against the
reference package's, on the CPU, on two noisy half maps of the 8-blob
phantom (N=32) and a mask.

Tolerances, relative to the max of the reference's output: the FFT-based
steps 1e-5 (float32 FFTs of both packages); the empirical CDF equal (the
same sorted values, the same searchsorted); the sigma cost 1e-5 relative
and the Powell fit 1e-3 (each a scipy Powell over float32 costs);
filter_bank 5e-5 for each weight function (a sum of up to 20 band
images, each an inverse FFT; read 1.6e-5).
"""
import numpy as np
import pytest
import torch

from test_torch_common import rel_err
from test_torch_project import phantom8
from xmipp3_tpu.ops import halves_restoration as jhr
from xmipp3_tpu_torch.ops import halves_restoration as thr

torch.set_num_threads(1)

N = 32
SHAPE = (N, N, N)


@pytest.fixture(scope="module")
def halves():
    rng = np.random.default_rng(3)
    v = phantom8(N)
    h1, h2 = (v + 0.2 * rng.standard_normal(v.shape).astype(np.float32)
              for _ in range(2))
    mask = np.zeros_like(v)
    mask[4:28, 4:28, 4:28] = 1
    t = lambda a: torch.as_tensor(a)
    return dict(h1=h1, h2=h2, mask=mask, r2=thr.make_r2(SHAPE),
                t1=t(h1), t2=t(h2), tm=t(mask), tr2=t(thr.make_r2(SHAPE)))


def test_r2_and_ecdf(halves):
    np.testing.assert_array_equal(thr.make_r2(SHAPE), jhr.make_r2(SHAPE))
    vals = np.sort(halves["h1"].ravel())
    q = halves["h2"][:4]
    want = np.asarray(jhr.ecdf_prob(vals, 20000, q))
    got = thr.ecdf_prob(torch.as_tensor(vals), 20000, torch.as_tensor(q))
    np.testing.assert_array_equal(got.numpy(), want)


def test_estimate_s_and_significance(halves):
    h = halves
    sj, cj, nj = jhr.estimate_s(h["h1"], h["h2"], h["mask"], h["r2"], SHAPE)
    st, ct, nt = thr.estimate_s(h["t1"], h["t2"], h["tm"], h["tr2"], SHAPE)
    assert rel_err(st, np.asarray(sj)) <= 1e-5 and int(nt) == int(nj)
    fin = np.isfinite(np.asarray(cj))
    assert rel_err(ct.numpy()[fin], np.asarray(cj)[fin]) <= 1e-5
    want = jhr.significance_real_space(h["h1"], sj, cj, nj)
    got = thr.significance_real_space(h["t1"], torch.tensor(
        np.asarray(sj)), torch.tensor(np.asarray(cj)), int(nj))
    assert rel_err(got, np.asarray(want)) <= 1e-5


def test_sigma_fit_deconvolution_and_convolution(halves):
    h = halves
    sj, _, _ = jhr.estimate_s(h["h1"], h["h2"], h["mask"], h["r2"], SHAPE)
    fj = jhr.forward_ffts(sj, h["h1"], h["h2"], SHAPE)
    ft = thr.forward_ffts(torch.tensor(np.asarray(sj)), h["t1"], h["t2"],
                          SHAPE)
    for a, b in zip(ft, fj):
        assert rel_err(a, np.asarray(b)) <= 1e-5
    sig = np.array([0.3, 0.25], np.float32)
    cj = float(jhr.sigma_cost(*fj, h["r2"], sig))
    ct = float(thr.sigma_cost(*ft, h["tr2"], torch.as_tensor(sig)))
    assert abs(ct - cj) <= 1e-5 * abs(cj)
    pj = jhr.optimize_sigma(*fj, h["r2"], 0.2, 0.2)
    pt = thr.optimize_sigma(*ft, h["tr2"], 0.2, 0.2)
    assert np.abs(np.array(pt) - pj).max() <= 1e-3
    dj = jhr.deconvolve_s(*fj, h["r2"], 0.001, pj[0], pj[1], SHAPE)
    dt = thr.deconvolve_s(*ft, h["tr2"], 0.001, pj[0], pj[1], SHAPE)
    for a, b in zip(dt, dj):
        assert rel_err(a, np.asarray(b)) <= 1e-5
    want = jhr.convolve_s(dj[0], h["r2"], 0.5 * sum(pj), SHAPE)
    got = thr.convolve_s(dt[0], h["tr2"], 0.5 * sum(pj), SHAPE)
    assert rel_err(got, np.asarray(want)) <= 1e-5


@pytest.mark.parametrize("fun,step,overlap,power",
                         [(0, 0.05, 0.5, 1.0), (1, 0.1, 0.25, 3.0),
                          (2, 0.08, 0.5, 2.0)])
def test_filter_bank(halves, fun, step, overlap, power):
    h = halves
    want = jhr.filter_bank(h["h1"], h["h2"], h["r2"], SHAPE, step, overlap,
                           fun, power)
    got = thr.filter_bank(h["t1"], h["t2"], h["tr2"], SHAPE, step, overlap,
                          fun, power)
    for a, b in zip(got, want):
        assert rel_err(a, np.asarray(b)) <= 5e-5


def test_evaluate_difference(halves):
    h = halves
    want = jhr.evaluate_difference(h["h1"], h["h2"], h["mask"], 1.5)
    got = thr.evaluate_difference(h["t1"], h["t2"], h["tm"], 1.5)
    for a, b in zip(got, want):
        assert rel_err(a, np.asarray(b)) <= 1e-5
