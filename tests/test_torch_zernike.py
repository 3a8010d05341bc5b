"""ops/zernike.py of the port against the reference package's, on the CPU,
on the same seeded inputs (the 8-blob phantom at N=24, L1=3, L2=2: 13
basis functions).

Tolerances:
- the host functions (radial polynomials, real harmonics, the basis grid,
  the strain analysis, the RMS deformation, the 2-D PolyZernikes): 1e-6
  absolute (the same numpy and scipy; read 0);
- deform_volume, single and batched (B, 3, K): 1e-5 of the max (float32
  products of the same basis and coefficients; read 1.6e-7);
- its gradient in the coefficients against jax.grad of the same weighted
  sum: 1e-4 of the max (float32 sums of 13,824 voxels' terms; read
  2.8e-6);
- fit_deformation, 20 Adam steps with --sigma levels 0 and 1.5 and the
  deformation penalty: the coefficients 1e-3 of their max (read 4.2e-4:
  Adam's normalised steps carry the losses' float32 roundoff) and the
  NCC 1e-4 absolute.
"""
import numpy as np
import pytest
import torch

from test_torch_project import phantom8
from xmipp3_tpu.ops import zernike as jz
from xmipp3_tpu_torch.ops import zernike as tz

torch.set_num_threads(1)

N = 24


@pytest.fixture(scope="module")
def setup():
    vol = phantom8(N)
    basis = tz.zernike_basis_grid(N, 3, 2)
    rng = np.random.default_rng(0)
    c = (rng.standard_normal((4, 3, basis.shape[0])) * 0.8).astype(
        np.float32)
    return vol, basis, c


def test_host_basis_equals_the_reference():
    r = np.linspace(0, 1, 17)
    th, ph = np.meshgrid(np.linspace(0, np.pi, 9), np.linspace(-3, 3, 7))
    for n in range(5):
        for l in range(n % 2, n + 1, 2):
            np.testing.assert_allclose(tz.zernike_radial(n, l, r),
                                       jz.zernike_radial(n, l, r), atol=1e-6)
            for m in range(-l, l + 1):
                np.testing.assert_allclose(tz.real_sph_harm(l, m, th, ph),
                                           jz.real_sph_harm(l, m, th, ph),
                                           atol=1e-6)
    assert tz.zernike_indices(4, 3) == jz.zernike_indices(4, 3)
    for radius in (None, 9.0):
        np.testing.assert_allclose(
            tz.zernike_basis_grid(N, 3, 2, radius),
            jz.zernike_basis_grid(N, 3, 2, radius), atol=1e-6)


def test_polyzernikes_equal_the_reference():
    rng = np.random.default_rng(1)
    coef = np.zeros(10)
    coef[[1, 4, 7]] = rng.standard_normal(3)
    roi = np.hypot(*np.mgrid[-8:8, -8:8]) < 7
    img = tz.zernike2d_pols(coef, (16, 16), roi)
    np.testing.assert_allclose(img, jz.zernike2d_pols(coef, (16, 16), roi),
                               atol=1e-6)
    w = rng.uniform(0.5, 1.5, (16, 16))
    np.testing.assert_allclose(tz.zernike2d_fit(img, coef != 0, w, roi),
                               jz.zernike2d_fit(img, coef != 0, w, roi),
                               atol=1e-6)
    for nz in range(12):
        np.testing.assert_array_equal(tz.zernike2d_cart_matrix(nz),
                                      jz.zernike2d_cart_matrix(nz))


def test_deform_volume_single_and_batched(setup):
    import jax.numpy as jnp
    vol, basis, c = setup
    batched = tz.deform_volume(vol, basis, c, device="cpu").numpy()
    for i in range(len(c)):
        want = np.asarray(jz.deform_volume(jnp.asarray(vol),
                                           jnp.asarray(basis),
                                           jnp.asarray(c[i])))
        got = tz.deform_volume(vol, basis, c[i], device="cpu").numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        assert np.abs(batched[i] - want).max() <= 1e-5 * np.abs(want).max()


def test_deform_volume_gradient_equals_jax_grad(setup):
    import jax
    import jax.numpy as jnp
    vol, basis, c = setup
    W = np.random.default_rng(2).standard_normal(vol.shape).astype(
        np.float32)
    want = np.asarray(jax.grad(lambda cc: (jz.deform_volume(
        jnp.asarray(vol), jnp.asarray(basis), cc) * W).sum())(
        jnp.asarray(c[0])))
    ct = torch.tensor(c[0], requires_grad=True)
    (tz.deform_volume(torch.as_tensor(vol), torch.as_tensor(basis), ct)
     * torch.as_tensor(W)).sum().backward()
    assert np.abs(ct.grad.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_fit_deformation_matches_the_reference(setup):
    vol, basis, c = setup
    target = tz.deform_volume(vol, basis, c[0], device="cpu").numpy()
    kw = dict(n_steps=20, lam=0.01, sigmas=[0, 1.5])
    cj, dj, nj = jz.fit_deformation(vol, target, 3, 2, **kw)
    ct, dt, nt = tz.fit_deformation(vol, target, 3, 2, device="cpu", **kw)
    assert np.abs(ct - cj).max() <= 1e-3 * np.abs(cj).max()
    assert abs(nt - nj) <= 1e-4
    assert nt > np.corrcoef(vol.ravel(), target.ravel())[0, 1]


def test_strain_and_amplitude_equal_the_reference(setup):
    vol, basis, c = setup
    for got, want in zip(tz.strain_rotation_volumes(basis, c[1]),
                         jz.strain_rotation_volumes(basis, c[1])):
        np.testing.assert_allclose(got, want, atol=1e-6)
    assert tz.deformation_amplitude(basis, c[1]) == pytest.approx(
        jz.deformation_amplitude(basis, c[1]), abs=1e-6)
