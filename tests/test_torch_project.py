"""ops/project.py and core/sampling.py of the port against the reference
package on the CPU.

Tolerances: the prepared Fourier volume and the projections <= 1e-4 * max
(two float32 FFT libraries); the slice gather on one shared Fourier volume
<= 1e-5 * max at generic orientations. At orientations that put slice
samples exactly on the cube's lattice (rot, tilt multiples of 90 deg) the
reference's compiled CPU build takes the floor and the fraction of a
coordinate from two differently rounded evaluations and misplaces a tap; run
without compilation it agrees with the port there, which is what the test
of the sampled gallery holds it to."""
import numpy as np
import pytest
import torch

import jax
from test_torch_common import rel_err
from xmipp3_tpu.core import sampling as jsampling
from xmipp3_tpu.ops import project as jproject
from xmipp3_tpu_torch.core import sampling
from xmipp3_tpu_torch.core.geometry import euler_matrix
from xmipp3_tpu_torch.ops import project

torch.set_num_threads(1)
N = 32

BLOBS8 = [(0, 0, 0, 3.0, 1.0), (6, -4, 5, 2.0, 0.8), (-5, 5, -3, 2.5, 0.6),
          (3, 6, -6, 1.8, 0.9), (-8, -7, 2, 1.5, 1.1), (9, 3, -2, 1.6, 0.7),
          (-2, -9, -8, 2.2, 0.95), (7, 8, 7, 1.4, 1.2)]


def phantom8(n=N, scale=None):
    """The 8-blob phantom of tests/test_match.py (made for n=48), its
    centres scaled to n."""
    scale = n / 48 if scale is None else scale
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) - n // 2
    vol = np.zeros((n, n, n), np.float32)
    for cz, cy, cx, s, a in BLOBS8:
        vol += a * np.exp(-((z - cz * scale) ** 2 + (y - cy * scale) ** 2
                            + (x - cx * scale) ** 2) / (2 * s ** 2))
    return vol


def _random_angles(seed, B):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 360, B).astype(np.float32),
            np.degrees(np.arccos(rng.uniform(-1, 1, B))).astype(np.float32),
            rng.uniform(0, 360, B).astype(np.float32))


@pytest.mark.parametrize("pad", [2.0, 1.5])
def test_prepare_and_project_at_random_orientations(pad):
    vol = phantom8()
    jvf, jpad = jproject.prepare_fourier_volume(vol, pad)
    tvf, tpad = project.prepare_fourier_volume(vol, pad, device="cpu")
    assert tpad == jpad and tvf.dtype == torch.complex64
    assert rel_err(tvf, np.asarray(jvf)) <= 1e-4
    rot, tilt, psi = _random_angles(0, 24)
    shifts = np.random.default_rng(1).uniform(-3, 3, (24, 2)).astype(np.float32)
    jp = jproject.FourierProjector(vol, pad)
    tp = project.FourierProjector(vol, pad, device="cpu")
    for sh in (None, shifts):
        want = np.asarray(jp.project_euler(rot, tilt, psi, sh))
        got = tp.project_euler(rot, tilt, psi, sh)
        assert got.shape == (24, N, N) and got.dtype == torch.float32
        assert rel_err(got, want) <= 1e-4


def test_slices_from_one_shared_fourier_volume():
    vol = phantom8()
    jp = jproject.FourierProjector(vol)
    tp = project.FourierProjector.from_jax_state(np.array(jp.vf), N,
                                                 jp.pad_n, device="cpu")
    assert (tp.N, tp.pad_n) == (N, 64)
    mats = np.asarray(euler_matrix(*_random_angles(2, 16)), np.float32)
    want = np.asarray(jproject.extract_central_slices(jp.vf, mats, N))
    got = project.extract_central_slices(tp.vf, mats, N)
    assert got.shape == (16, N, N // 2 + 1)
    assert rel_err(got, want) <= 1e-5
    assert rel_err(project.slices_to_projections(got, N),
                   np.asarray(jproject.slices_to_projections(want, N))) <= 1e-4
    with pytest.raises(ValueError, match="expected"):
        project.FourierProjector.from_jax_state(np.asarray(jp.vf)[:-1], N, 64,
                                                device="cpu")


def test_sampled_gallery_with_lattice_orientations():
    vol = phantom8()
    a = jsampling.Sampling(15.0, "c1").angles.astype(np.float32)
    zero = np.zeros(len(a), np.float32)
    jp = jproject.FourierProjector(vol)
    tp = project.FourierProjector.from_jax_state(np.array(jp.vf), N, jp.pad_n,
                                                 device="cpu")
    mats = np.asarray(euler_matrix(a[:, 0], a[:, 1], zero), np.float32)
    got = project.extract_central_slices(tp.vf, mats, N).numpy()
    compiled = np.asarray(jproject.extract_central_slices(jp.vf, mats, N))
    peak = np.abs(compiled).max()
    err = np.abs(got - compiled).max(axis=(1, 2)) / peak
    lattice = err > 1e-5
    assert 0 < lattice.mean() <= 0.1
    with jax.disable_jit():
        eager = np.asarray(jproject.extract_central_slices(
            jp.vf, mats[lattice], N))
    assert np.abs(got[lattice] - eager).max() / peak <= 1e-5
    # in real space the misplaced taps weigh little: the galleries agree
    want = np.asarray(jp.project_euler(a[:, 0], a[:, 1], zero))
    assert rel_err(tp.project_euler(a[:, 0], a[:, 1], zero), want) <= 2e-4


@pytest.mark.parametrize("rate,sym,tilts", [
    (15.0, "c1", (0.0, 180.0)), (10.0, "c4", (0.0, 180.0)),
    (20.0, "d2", (0.0, 180.0)), (12.0, "c1", (30.0, 120.0)),
    (15.0, "i1", (0.0, 180.0))])
def test_sampling_is_the_reference_copy(rate, sym, tilts):
    want = jsampling.Sampling(rate, sym, tilts)
    got = sampling.Sampling(rate, sym, tilts)
    np.testing.assert_array_equal(got.angles, want.angles)
    d = sampling.directions_from_angles(got.angles[:, :2])
    np.testing.assert_array_equal(
        d, jsampling.directions_from_angles(want.angles[:, :2]))
    from xmipp3_tpu.core.sym import SymList as JSym
    from xmipp3_tpu_torch.core.sym import SymList
    q = got.angles[::3, :2]
    a = sampling.compute_neighbors(q, got.angles[:, :2], 2 * rate,
                                   SymList(sym))
    b = jsampling.compute_neighbors(q, want.angles[:, :2], 2 * rate,
                                    JSym(sym))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
