"""models/nma.py of the port against the reference package's, on the CPU,
on the same seeded inputs (the two-cluster model of 24 atoms of the
reference's tests/test_nma_validation.py, at N=24).

Tolerances:
- elastic_network_modes, write_modes/read_mode and displacement_field:
  equal (the same host numpy, cKDTree and eigh);
- warp_volume_field: 1e-5 of the max (float32 trilinear taps of the same
  field; read 6e-8), its gradient in the field against jax.grad of a
  weighted sum 1e-4 of the max (read 2e-7);
- fit_mode_amplitudes by Adam (40 steps): the amplitudes 1e-3 of their
  max (read 1.3e-6) and the NCC 1e-5; by COBYQA (the trust path): the
  NCC 1e-5 (read 4.2e-6) and the amplitudes 5e-2 of their max (read
  1.8e-2: both runs stop at COBYQA's own tolerance in a valley whose NCC
  changes by 4e-6 over that distance, where the float32 objective's
  roundoff decides the path).
"""
import numpy as np
import pytest
import torch

from xmipp3_tpu.models import nma as jn
from xmipp3_tpu_torch.core.pdb import AtomicModel, rasterize
from xmipp3_tpu_torch.models import nma as tn

torch.set_num_threads(1)

N = 24


def two_blob_model():
    """Two rigid clusters connected weakly: the lowest mode separates
    them."""
    rng = np.random.default_rng(0)
    c1 = rng.normal(0, 1.2, (12, 3)) + [-5.0, 0, 0]
    c2 = rng.normal(0, 1.2, (12, 3)) + [5.0, 0, 0]
    coords = np.vstack([c1, c2])
    return AtomicModel(coords, ["C"] * 24, np.zeros(24, np.float32),
                       np.ones(24, np.float32))


@pytest.fixture(scope="module")
def model_modes():
    model = two_blob_model()
    modes, evals = tn.elastic_network_modes(model.coords, n_modes=3)
    return model, modes, evals


def test_modes_and_mode_files_equal_the_reference(model_modes, tmp_path):
    model, modes, evals = model_modes
    want = jn.elastic_network_modes(model.coords, n_modes=3)
    np.testing.assert_array_equal(modes, want[0])
    np.testing.assert_array_equal(evals, want[1])
    for cutoff in (4.0, 12.0):
        np.testing.assert_array_equal(
            tn.elastic_network_modes(model.coords, 2, cutoff)[0],
            jn.elastic_network_modes(model.coords, 2, cutoff)[0])
    files = tn.write_modes(str(tmp_path / "m"), modes)
    assert files == [str(tmp_path / f"m_mode{i:03d}.mod") for i in (1, 2, 3)]
    np.testing.assert_array_equal(tn.read_mode(files[1]),
                                  jn.read_mode(files[1]))
    np.testing.assert_array_equal(
        tn.displacement_field(model.coords, modes, [2.0, -1.0, 0.5], N, 1.2),
        jn.displacement_field(model.coords, modes, [2.0, -1.0, 0.5], N, 1.2))


def test_warp_and_its_gradient_equal_the_reference(model_modes):
    import jax
    import jax.numpy as jnp
    model, modes, _ = model_modes
    vol = rasterize(model, N, 1.0, sigma_a=1.5, center=False)
    field = tn.displacement_field(model.coords, modes, [3.0, -2.0, 1.0], N)
    want = np.asarray(jn.warp_volume_field(jnp.asarray(vol),
                                           jnp.asarray(field)))
    got = tn.warp_volume_field(vol, field, device="cpu").numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    W = np.random.default_rng(1).standard_normal(vol.shape).astype(
        np.float32)
    gj = np.asarray(jax.grad(lambda f: (jn.warp_volume_field(
        jnp.asarray(vol), f) * W).sum())(jnp.asarray(field)))
    ft = torch.tensor(field, requires_grad=True)
    (tn.warp_volume_field(torch.as_tensor(vol), ft)
     * torch.as_tensor(W)).sum().backward()
    assert np.abs(ft.grad.numpy() - gj).max() <= 1e-4 * np.abs(gj).max()


@pytest.mark.parametrize("optimizer", ["adam", "trust"])
def test_fit_mode_amplitudes_matches_the_reference(model_modes, optimizer):
    model, modes, _ = model_modes
    modes = modes[:2]
    vol_ref = rasterize(model, N, 1.0, sigma_a=1.5, center=False)
    moved = AtomicModel(model.coords + 3.0 * modes[0], model.elements,
                        model.bfactors, model.occupancies)
    vol_t = rasterize(moved, N, 1.0, sigma_a=1.5, center=False)
    kw = dict(n_steps=40) if optimizer == "adam" else dict(n_steps=8)
    aj, nj = jn.fit_mode_amplitudes(vol_ref, vol_t, model.coords, modes,
                                    optimizer=optimizer, **kw)
    at, nt = tn.fit_mode_amplitudes(vol_ref, vol_t, model.coords, modes,
                                    optimizer=optimizer, device="cpu", **kw)
    tol_a, tol_n = (1e-3, 1e-5) if optimizer == "adam" else (5e-2, 1e-5)
    assert np.abs(at - aj).max() <= tol_a * np.abs(aj).max()
    assert abs(nt - nj) <= tol_n
    assert abs(at[0]) > abs(at[1])
