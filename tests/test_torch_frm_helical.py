"""Fast rotational matching (ops/frm.py) and the helical symmetry search
(ops/helical.py) of the port against the reference package's, on the
CPU, on seeded blob volumes (N=24-32).

Tolerances:
- the shell SH coefficients and the SO(3) correlation grid 1e-6 of their
  max (the same float32 samples and complex64 products; the grid in
  complex128), and the same grid argmax;
- frm_align_volumes: the unpolished matrix equal; the polished one within
  2e-3 of the reference's (the compass search's late rounds compare costs
  that differ in roundoff), and a planted rotation recovered within 1.5
  degrees by both;
- symmetrize_helical 1e-6 of the max; the (rot, z) correlation map 1e-4
  absolute (masked float32 sums of 14k voxels; read 5.2e-5) with the same
  argmax cell; helical_correlation 1e-4 (read 2.2e-5); the map
  equal whatever the chunk of candidates.
"""
import numpy as np
import pytest
import torch

from test_torch_common import rel_err
from xmipp3_tpu.ops import frm as jfrm
from xmipp3_tpu.ops import helical as jhel
from xmipp3_tpu.ops.geo import apply_affine_3d
from xmipp3_tpu_torch.ops import frm as tfrm
from xmipp3_tpu_torch.ops import helical as thel

torch.set_num_threads(1)

N = 32
BLOBS = [((0, 0, 0), 3, 1), ((5, -3, 2), 2, .8), ((-4, 4, -3), 2.5, .6),
         ((2, 6, -5), 1.8, .9), ((-6, -2, 5), 1.5, .7)]


def _blobs(n=N):
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) - n // 2
    v = np.zeros((n, n, n), np.float32)
    for c, s, a in BLOBS:
        v += a * np.exp(-((x - c[0]) ** 2 + (y - c[1]) ** 2
                          + (z - c[2]) ** 2) / (2 * s * s))
    return v


@pytest.fixture(scope="module")
def planted():
    v = _blobs()
    R = jfrm._zyz_active(0.7, 1.1, 2.3)
    v2 = np.asarray(apply_affine_3d(v, np.linalg.inv(R)[None]))[0]
    return v, v2, R


def test_shell_coefficients_and_so3_grid_match_the_reference(planted):
    v, v2, _ = planted
    radii = np.arange(2.0, N // 2 - 1, 1.0)
    fj, gj = (jfrm._shell_coeffs(a, 12, radii) for a in (v, v2))
    ft, gt = (tfrm._shell_coeffs(a, 12, radii, device="cpu") for a in
              (v, v2))
    assert rel_err(ft, fj) <= 1e-6 and rel_err(gt, gj) <= 1e-6
    Cj, bj = jfrm.so3_correlation(fj, gj, 12, 32, 64, radii ** 2)
    Ct, bt = tfrm.so3_correlation(ft, gt, 12, 32, 64, radii ** 2)
    assert Ct.dtype == torch.float64 and np.array_equal(bt, bj)
    assert rel_err(Ct, Cj) <= 1e-6
    assert int(torch.argmax(Ct)) == int(np.argmax(Cj))


def test_frm_recovers_a_planted_rotation(planted):
    v, v2, R = planted
    kw = dict(L=12, n_beta=32, n_ang=64)
    M0j = jfrm.frm_align_volumes(v, v2, refine=False, **kw)
    M0t = tfrm.frm_align_volumes(v, v2, refine=False, device="cpu", **kw)
    np.testing.assert_array_equal(M0t, M0j)
    Mj = jfrm.frm_align_volumes(v, v2, **kw)
    Mt = tfrm.frm_align_volumes(v, v2, device="cpu", **kw)
    assert Mt.dtype == np.float32 and np.abs(Mt - Mj).max() <= 2e-3
    for M in (Mj, Mt):
        cos = np.clip((np.trace(M.T @ R) - 1) / 2, -1, 1)
        assert np.degrees(np.arccos(cos)) <= 1.5


def _helix(n, rise, twist):
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) - n // 2
    v = np.zeros((n, n, n), np.float32)
    for k in range(-10, 11):
        a = np.deg2rad(twist * k)
        v += np.exp(-((x - 6 * np.cos(a)) ** 2 + (y - 6 * np.sin(a)) ** 2
                      + (z - rise * k) ** 2) / (2 * 1.5 ** 2))
    return v


@pytest.mark.parametrize("kw", [dict(), dict(cn=2, dihedral=True,
                                             height_fraction=0.8)])
def test_symmetrize_helical_matches_the_reference(kw):
    v = _helix(24, 3.0, 40.0)
    want = np.asarray(jhel.symmetrize_helical(v, 3.2, 37.0, **kw))
    got = thel.symmetrize_helical(v, 3.2, 37.0, device="cpu", **kw)
    assert rel_err(got, want) <= 1e-6


def test_helical_grid_and_its_argmax_match_the_reference():
    v = _helix(24, 3.0, 40.0)
    mask = (np.random.default_rng(0).uniform(size=v.shape) > 0.2) \
        .astype(np.float32)
    zs, rs = np.arange(2.0, 4.01, 0.5), np.arange(30.0, 50.1, 5.0)
    want = jhel.helical_correlation_grid(v, zs, rs, mask=mask)
    got = thel.helical_correlation_grid(v, zs, rs, mask=mask, device="cpu")
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-4
    assert int(torch.argmax(got)) == int(np.argmax(want))
    assert np.unravel_index(int(torch.argmax(got)), got.shape) == (2, 2)
    chunked = thel.helical_correlation_grid(v, zs, rs, mask=mask, chunk=3,
                                            device="cpu")
    assert rel_err(chunked, got) <= 1e-7
    one = thel.helical_correlation(v, 3.0, 40.0, mask=mask, device="cpu")
    assert abs(float(one) - float(jhel.helical_correlation(
        v, 3.0, 40.0, mask=mask))) <= 1e-4
