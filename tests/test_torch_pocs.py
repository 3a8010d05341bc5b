"""The port's ops/pocs.py against the reference package's, on the CPU, on
the 8-blob phantom at N=32 and a copy of it with one blob removed, a
grey-level change and noise (numpy draws).

Tolerances, relative to the max of the reference's output:
- the operators (mask, nonnegative, min/max, Fourier amplitude and phase,
  extract_phase) 1e-6 (single float32 operations, float32 FFT inputs);
- the radial averages and their quotient 1e-5 (float32 ring sums in
  another order: the port's index_add_ against the reference's scatter
  add); rings with no voxel are 0 in both;
- volume_adjust, with and without --radavg, with a mask and with a
  low-pass cut, and subtract_adjusted: 1e-4 (five iterations of four
  float32 FFTs each; read up to 1.6e-5), but the direct amplitudes after
  a low-pass cut 5e-3 (read 2.6e-3): there the amplitude projection
  divides by the low-passed spectrum's roundoff beyond the cut (above its
  1e-10 guard) and scales it up to V1's amplitudes, so the phases it
  keeps are each package's FFT roundoff. The first iteration, before any
  cut reaches the amplitudes, agrees to 1e-5 (read 2.5e-6).
"""
import numpy as np
import pytest
import torch

from test_torch_project import BLOBS8
from xmipp3_tpu.ops import pocs as jp
from xmipp3_tpu_torch.ops import pocs as tp

torch.set_num_threads(1)

N = 32


def blobs_volume(n, blobs):
    """Gaussian blobs (cz, cy, cx, sigma, amplitude), their centres made
    for n=48 and scaled to n, as test_torch_project.phantom8 makes them."""
    sc = n / 48
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) - n // 2
    vol = np.zeros((n, n, n), np.float32)
    for cz, cy, cx, s, a in blobs:
        r2 = (z - cz * sc) ** 2 + (y - cy * sc) ** 2 + (x - cx * sc) ** 2
        vol += a * np.exp(-r2 / (2 * s ** 2))
    return vol


def rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    if np.iscomplexobj(want):
        got, want = got.astype(np.complex128), want.astype(np.complex128)
    else:
        got, want = got.astype(np.float64), want.astype(np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def vols():
    rng = np.random.default_rng(11)
    v1 = blobs_volume(N, BLOBS8)
    v2 = 1.3 * blobs_volume(N, BLOBS8[:-1]) + 0.1 \
        + 0.05 * rng.standard_normal(v1.shape).astype(np.float32)
    zz, yy, xx = np.mgrid[:N, :N, :N] - N // 2
    mask = ((zz ** 2 + yy ** 2 + xx ** 2) < (0.45 * N) ** 2).astype(
        np.float32)
    return v1.astype(np.float32), v2.astype(np.float32), mask


def test_operators(vols):
    v1, v2, mask = vols
    t = torch.as_tensor
    assert rel(tp.pocs_mask(t(v2), t(mask)), jp.pocs_mask(v2, mask)) == 0
    assert rel(tp.pocs_nonnegative(t(v2 - 0.2)),
               jp.pocs_nonnegative(v2 - 0.2)) == 0
    lo, hi = t(np.float32(0.1)), t(np.float32(0.6))
    assert rel(tp.pocs_min_max(t(v2), lo, hi),
               jp.pocs_min_max(v2, 0.1, 0.6)) == 0
    F1 = np.fft.rfftn(v1).astype(np.complex64)
    F2 = np.fft.rfftn(v2).astype(np.complex64)
    F2[0, 0, 3] = 0.0
    mag1 = np.abs(F1)
    for lam in (1.0, 0.5):
        assert rel(tp.pocs_fourier_amplitude(t(mag1), t(F2), lam),
                   jp.pocs_fourier_amplitude(mag1, F2, lam)) <= 1e-6
    ph = tp.extract_phase(t(F2))
    assert rel(ph, jp.extract_phase(F2)) <= 1e-6
    assert ph[0, 0, 3] == 1
    assert rel(tp.pocs_fourier_phase(ph, t(F1)),
               jp.pocs_fourier_phase(np.asarray(jp.extract_phase(F2)),
                                     F1)) <= 1e-6


def test_radial_averages_and_quotient(vols):
    v1, v2, _ = vols
    shape = v1.shape
    m1 = np.abs(np.fft.rfftn(v1)).astype(np.float32)
    m2 = np.abs(np.fft.rfftn(v2)).astype(np.float32)
    want = np.asarray(jp.radial_average_octant(m1, shape))
    got = tp.radial_average_octant(torch.as_tensor(m1), shape).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert rel(got[ok], want[ok]) <= 1e-5
    q = tp.compute_rad_quotient(torch.as_tensor(m1), torch.as_tensor(m2),
                                shape)
    qj = np.asarray(jp.compute_rad_quotient(m1, m2, shape))
    assert rel(q, qj) <= 1e-5
    assert (q.numpy()[~ok] == 0).all()
    F = np.fft.rfftn(v2).astype(np.complex64)
    assert rel(tp.pocs_fourier_amplitude_radavg(torch.as_tensor(F), 0.7, q,
                                                shape),
               jp.pocs_fourier_amplitude_radavg(F, 0.7, qj, shape)) <= 1e-5


@pytest.mark.parametrize("radavg,use_mask,cut", [
    (True, False, 0.0), (False, False, 0.0), (True, True, 0.0),
    (False, True, 0.25)])
def test_volume_adjust_matches_the_reference(vols, radavg, use_mask, cut):
    v1, v2, mask = vols
    m = mask if use_mask else None
    want = np.asarray(jp.volume_adjust(v1, v2, mask=m, iters=5, lam=0.9,
                                       radavg=radavg, cut_freq=cut))
    got = tp.volume_adjust(v1, v2, mask=m, iters=5, lam=0.9, radavg=radavg,
                           cut_freq=cut, device="cpu")
    assert got.shape == want.shape and got.dtype == torch.float32
    assert rel(got, want) <= (5e-3 if cut and not radavg else 1e-4)
    one = tp.volume_adjust(v1, v2, mask=m, iters=1, lam=0.9, radavg=radavg,
                           cut_freq=cut, device="cpu")
    assert rel(one, jp.volume_adjust(v1, v2, mask=m, iters=1, lam=0.9,
                                     radavg=radavg, cut_freq=cut)) <= 1e-5


@pytest.mark.parametrize("cut", [0.0, 0.2])
def test_subtract_adjusted_matches_the_reference(vols, cut):
    v1, v2, mask = vols
    adj = np.array(jp.volume_adjust(v1, v2, iters=3))
    want = np.asarray(jp.subtract_adjusted(v1, adj, mask, cut))
    got = tp.subtract_adjusted(torch.as_tensor(v1), torch.as_tensor(adj),
                               mask, cut)
    assert rel(got, want) <= 1e-5
