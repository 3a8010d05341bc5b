"""K4's wrapper on the CPU (where it takes its plain version) against the
reference's cross-spectrum, as XLA einsum and as the Pallas kernel in
interpret mode; and the two correlation functions of ops/match.py that run
through it, against the reference's.

Tolerances: the cross-spectrum sums 13 float32 products per output, in an
order that differs between the packages: <= 1e-5 * max. The correlation
peaks add an inverse FFT and a normalization: <= 1e-4; psi <= 0.01 deg
wherever the curve's winner leads its runner-up by more than 1e-3 (a closer
race may be decided by roundoff)."""
import numpy as np
import pytest
import torch

import chip_smoke
import jax.numpy as jnp
from test_torch_common import rel_err
from xmipp3_tpu.ops import match as jmatch
from xmipp3_tpu.ops.pallas_cross import (cross_spectrum_pallas,
                                         cross_spectrum_xla)
from xmipp3_tpu_torch.ops import cross, match

torch.set_num_threads(1)


def _spectra(seed, B=32, R=8, nr=13, K=16):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s)
                     + 1j * rng.standard_normal(s)).astype(np.complex64)
    w = np.linspace(0.5, 1.5, nr).astype(np.float32)
    return mk(B, nr, K), mk(R, nr, K), w


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("mirror", [False, True])
def test_cross_spectrum_matches_the_reference(reference, mirror):
    fi, fr, w = _spectra(0)
    if reference == "xla":
        ref = lambda f: cross_spectrum_xla(jnp.asarray(f), jnp.asarray(fr),
                                           jnp.asarray(w))
    else:
        ref = lambda f: cross_spectrum_pallas(
            jnp.asarray(f), jnp.asarray(fr), jnp.asarray(w), tile_b=32,
            interpret=True)
    before = cross.launches
    got = cross.cross_spectrum(*_t(fi, fr, w), mirror=mirror)
    assert cross.launches == before          # CPU tensors: the plain version
    if mirror:
        got, got_m = got
        # the mirrored images' ring FFTs are the conjugates
        assert rel_err(got_m, np.asarray(ref(fi.conj()))) <= 1e-5
    assert got.dtype == torch.complex64 and got.shape == (32, 8, 16)
    assert rel_err(got, np.asarray(ref(fi))) <= 1e-5


@pytest.mark.parametrize("shape", [(1, 31, 1, 64), (1, 31, 40, 33),
                                   (35, 9, 33, 64)])
def test_cross_spectrum_matches_the_reference_at_ragged_tiles(shape):
    """Sizes off the kernel's 32 x 32 x 4 tile and 8-ring stages (one
    image, one reference, an odd k, nr = 9), through the wrapper's plain
    version, against the reference's XLA einsum."""
    B, nr, R, K = shape
    fi, fr, w = _spectra(7, B=B, R=R, nr=nr, K=K)
    got, got_m = cross.cross_spectrum(*_t(fi, fr, w), mirror=True)
    ref = lambda f: np.asarray(cross_spectrum_xla(
        jnp.asarray(f), jnp.asarray(fr), jnp.asarray(w)))
    assert got.shape == got_m.shape == (B, R, K)
    assert rel_err(got, ref(fi)) <= 1e-5
    assert rel_err(got_m, ref(fi.conj())) <= 1e-5


def test_l2_to_shared_bytes_of_a_tile():
    """8 nr k (B ceil(R / TR) + R ceil(B / TB)): at the matching run's
    shapes 2.523 GB for the first design's 8 x 16 tile, 0.842 GB for the
    32 x 32 one."""
    shape = (512, 31, 1652, 64)
    assert chip_smoke.l2_to_shared_bytes(*shape, 8, 16) == 15872 * 158976
    assert chip_smoke.l2_to_shared_bytes(*shape, 32, 32) == 15872 * 53056
    assert chip_smoke.l2_to_shared_bytes(1, 1, 1, 1, 32, 32) == 16


def test_cross_spectrum_rejects_what_the_kernel_does_not_take():
    fi, fr, w = _t(*_spectra(1))
    with pytest.raises(TypeError, match="complex64"):
        cross.cross_spectrum(fi.to(torch.complex128), fr, w)
    with pytest.raises(ValueError, match="contiguous"):
        cross.cross_spectrum(fi.transpose(0, 1).contiguous().transpose(0, 1),
                             fr, w)
    with pytest.raises(ValueError, match=r"\(B, nr, k\)"):
        cross.cross_spectrum(fi, fr[:, :5], w)
    with pytest.raises(ValueError, match="elements"):
        cross.cross_spectrum(fi, fr, w[:5])


@pytest.mark.parametrize("ring_weights", [False, True])
def test_rotational_corr_matrix_matches_the_reference(ring_weights):
    fi, fr, _ = _spectra(2, B=6, R=9, nr=7, K=17)
    rw = np.linspace(1.0, 0.3, 7).astype(np.float32) if ring_weights else None
    ref = np.asarray(jmatch.rotational_corr_matrix(
        jnp.asarray(fr), jnp.asarray(fi), 2,
        None if rw is None else jnp.asarray(rw)))
    got = match.rotational_corr_matrix(
        *_t(fr, fi), 2, None if rw is None else torch.as_tensor(rw))
    assert got.shape == ref.shape == (6, 9, 32)
    assert np.abs(got.numpy() - ref).max() <= 1e-4


@pytest.mark.parametrize("psi_mask", [None, 32, 254])
def test_best_rotation_matrix_matches_the_reference(psi_mask):
    fi, fr, _ = _spectra(3, B=10, R=12, nr=9, K=17)
    allow = None
    if psi_mask:
        allow = (np.random.default_rng(4).uniform(size=(10, psi_mask)) < 0.6
                 ).astype(np.float32)
    ref = [np.asarray(v) for v in jmatch.best_rotation_matrix(
        jnp.asarray(fr), jnp.asarray(fi), 2,
        None if allow is None else jnp.asarray(allow))]
    got = [v.numpy() for v in match.best_rotation_matrix(
        *_t(fr, fi), 2, None if allow is None else torch.as_tensor(allow))]
    # the margin of each curve's winner over its runner-up, from the curves
    curves = np.asarray(jmatch.rotational_corr_matrix(jnp.asarray(fr),
                                                      jnp.asarray(fi), 2))
    if allow is not None:
        src = np.round(np.arange(32) * (psi_mask / 32)).astype(int) % psi_mask
        curves = np.where(allow[:, src][:, None, :] > 0, curves, -1e30)
    top2 = np.sort(curves, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-3
    assert clear.mean() > 0.5
    for k in (1, 3):                                   # peak, peak_m
        assert np.abs(got[k] - ref[k]).max() <= 1e-4
    dpsi = np.abs((got[0] - ref[0] + 180) % 360 - 180)
    assert dpsi[clear].max() <= 0.01
