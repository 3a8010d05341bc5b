"""ops/forward_zernike.py of the port against the reference package's, on
the CPU, on the same seeded inputs (the 8-blob phantom at N=24, its
voxels above 1e-3 of the max: 5,516 voxels, 13 basis functions; 3
particles).

Tolerances:
- masked_voxel_basis and the two blob footprints: equal (the same host
  numpy);
- the splats, bilinear and projected-KB into 24^2 images, trilinear and
  3-D KB into 24^3 volumes: 1e-5 of the max (float32 scatter-adds of the
  same taps; read 9e-7);
- their gradients in the coefficients and the angles against jax.grad of
  the same weighted sum: 1e-3 of the max for the KB footprints (float32
  sums of the 25 or 27 taps' table slopes over 5,516 voxels; read 6.1e-5)
  and 1e-4 for the bilinear and trilinear splats (read 1.5e-6);
- fit_forward_zernike_batch against the reference's vmapped fit, 10 Adam
  steps, bilinear, with and without the CTF model and defocus deltas:
  the coefficients 1e-3 of their max (read 5.2e-5), the pose deltas 1e-3
  of their max (read 1.2e-4 of the defocus deltas' 298 A), the
  correlations 1e-5 absolute and the deformation 1e-5; the pairs mode
  (M=2), 6 steps: the same (read 5.1e-6);
- fit_forward_zernike_subtomos_batch (wedge mask, isotropic CTF, defocus
  deltas, 8 steps): the coefficients 1e-3 of their max (read 4.6e-5),
  the deltas 1e-3 of their max (read 7e-6 of the defocus deltas), the
  correlations 1e-5.
"""
import numpy as np
import pytest
import torch

from test_torch_project import phantom8
from xmipp3_tpu.ops import forward_zernike as jfz
from xmipp3_tpu_torch.ops import forward_zernike as tfz
from xmipp3_tpu_torch.ops.fourier_filter import wedge_mask_3d

torch.set_num_threads(1)

N, B = 24, 3
CTF = (0.0197 * np.pi, 1e5, 0.997, 0.07, 2.0)


@pytest.fixture(scope="module")
def cloud():
    vol = phantom8(N)
    pos, vals, Z = tfz.masked_voxel_basis(vol, 3, 2,
                                          value_threshold=vol.max() * 1e-3)
    rng = np.random.default_rng(0)
    K = Z.shape[0]
    c = (rng.standard_normal((B, 3, K)) * 0.5).astype(np.float32)
    rot = rng.uniform(0, 360, B).astype(np.float32)
    tilt = rng.uniform(20, 160, B).astype(np.float32)
    psi = rng.uniform(0, 360, B).astype(np.float32)
    return vol, pos, vals, Z, c, (rot, tilt, psi), rng


def _j(*a):
    import jax.numpy as jnp
    return [None if x is None else jnp.asarray(x) for x in a]


def _hold(want, got, tols):
    for w, g, tol in zip(want, got, tols):
        w, g = np.asarray(w), g.numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol(w), (np.abs(g - w).max(),
                                               np.abs(w).max())


def test_host_selection_and_footprints_equal_the_reference(cloud):
    vol = cloud[0]
    for kw in ({}, {"rmax": 9, "rdef": 11, "step": 2},
               {"mask": vol > 0.1 * vol.max()}):
        for got, want in zip(tfz.masked_voxel_basis(vol, 3, 2, **kw),
                             jfz.masked_voxel_basis(vol, 3, 2, **kw)):
            np.testing.assert_array_equal(got, want)
    for r in (1.0, 1.5, 2.5):
        for f in ("blob_splat_profile", "blob_splat_profile_3d"):
            got, want = getattr(tfz, f)(r), getattr(jfz, f)(r)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("blob", [None, 1.5])
def test_splats_and_their_gradients(cloud, dim, blob):
    import jax
    vol, pos, vals, Z, c, _, rng = cloud
    name = "forward_splat_project" if dim == 2 else "forward_splat_volume"
    prof_of = tfz.blob_splat_profile if dim == 2 \
        else tfz.blob_splat_profile_3d
    prof, nt = (None, 0) if blob is None else prof_of(blob)
    W = rng.standard_normal((N,) * dim).astype(np.float32)
    ang = np.array([30.0, 60.0, 10.0], np.float32)
    c0 = c[0] * 0.6

    def lj(cc, a):
        img, d2 = getattr(jfz, name)(*_j(pos, vals, Z), cc, a[0], a[1], a[2],
                                     N, blob_profile=_j(prof)[0], n_taps=nt)
        return (img * W).sum() + d2, img

    (_, img_j), (gc, ga) = (lj(*_j(c0, ang)),
                            jax.grad(lambda *a: lj(*a)[0], argnums=(0, 1))(
                                *_j(c0, ang)))
    ct = torch.tensor(c0, requires_grad=True)
    at = torch.tensor(ang, requires_grad=True)
    img, d2 = getattr(tfz, name)(pos, vals, Z, ct, at[0], at[1], at[2], N,
                                 blob_profile=prof, n_taps=nt, device="cpu")
    ((img * torch.as_tensor(W)).sum() + d2).backward()
    img_j = np.asarray(img_j)
    assert np.abs(img.detach().numpy() - img_j).max() \
        <= 1e-5 * np.abs(img_j).max()
    tol = 1e-3 if blob else 1e-4
    for got, want in ((ct.grad, gc), (at.grad, ga)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()


def _views(cloud, noise=0.05):
    vol, pos, vals, Z, c, (rot, tilt, psi), rng = cloud
    imgs = tfz.forward_splat_project(pos, vals, Z, c, rot, tilt, psi, N,
                                     device="cpu")[0].numpy()
    return imgs + noise * rng.standard_normal(imgs.shape).astype(np.float32)


@pytest.mark.parametrize("ctf", [False, True])
def test_batch_fit_matches_the_vmapped_reference(cloud, ctf):
    vol, pos, vals, Z, c, (rot, tilt, psi), _ = cloud
    imgs = _views(cloud)
    yy, xx = np.mgrid[0:N, 0:N] - N // 2
    mask = ((yy * yy + xx * xx) <= (N / 2) ** 2).astype(np.float32)
    c0 = np.zeros_like(c)
    dU = np.full(B, 15000.0, np.float32)
    kw = {} if not ctf else dict(use_ctf=True, opt_defocus=True,
                                 ctf_consts=CTF)
    arrays = {} if not ctf else dict(defU=dU, defV=dU * 0.98,
                                     defAng=np.full(B, 30.0, np.float32))
    want = jfz.fit_forward_zernike_batch(
        *_j(pos, vals, Z, imgs, rot, tilt, psi, c0), 0.01, N, 10,
        img_mask=_j(mask)[0], **kw,
        **{k: _j(v)[0] for k, v in arrays.items()})
    got = tfz.fit_forward_zernike_batch(pos, vals, Z, imgs, rot, tilt, psi,
                                        c0, 0.01, N, 10, img_mask=mask,
                                        device="cpu", **kw, **arrays)
    rel = lambda t: lambda w: t * np.abs(w).max()
    _hold(want, got, [rel(1e-3), rel(1e-3), lambda w: 1e-5,
                      lambda w: 1e-5])


def test_pairs_mode(cloud):
    vol, pos, vals, Z, c, (rot, tilt, psi), _ = cloud
    imgs = _views(cloud)
    imgs2 = np.ascontiguousarray(np.stack([imgs, imgs[:, ::-1]], 1))
    rot2 = np.stack([rot, rot + 5], 1)
    tilt2, psi2 = np.stack([tilt, tilt], 1), np.stack([psi, psi], 1)
    c0 = np.zeros_like(c)
    want = jfz.fit_forward_zernike_batch(
        *_j(pos, vals, Z, imgs2, rot2, tilt2, psi2, c0), 0.01, N, 6)
    got = tfz.fit_forward_zernike_batch(pos, vals, Z, imgs2, rot2, tilt2,
                                        psi2, c0, 0.01, N, 6, device="cpu")
    rel = lambda w: 1e-3 * np.abs(w).max()
    _hold(want, got, [rel, rel, lambda w: 1e-5, lambda w: 1e-5])


def test_subtomogram_fit_matches_the_reference(cloud):
    vol, pos, vals, Z, c, (rot, tilt, psi), _ = cloud
    sm = wedge_mask_3d(N, N, N, -60, 60)
    subs = tfz.forward_splat_volume(pos, vals, Z, c, rot, tilt, psi, N,
                                    device="cpu")[0].numpy()
    subs = np.fft.irfftn(np.fft.rfftn(subs, axes=(1, 2, 3)) * sm,
                         (N, N, N), axes=(1, 2, 3)).astype(np.float32)
    zz, yy, xx = np.mgrid[0:N, 0:N, 0:N] - N // 2
    vm = ((zz * zz + yy * yy + xx * xx) <= (N / 2) ** 2).astype(np.float32)
    dU = np.full(B, 15000.0, np.float32)
    c0 = np.zeros_like(c)
    kw = dict(use_ctf=True, ctf_consts=CTF, opt_defocus=True)
    want = jfz.fit_forward_zernike_subtomos_batch(
        *_j(pos, vals, Z, subs, rot, tilt, psi, c0), 0.01, N, 8,
        spec_mask=_j(sm)[0], vol_mask=_j(vm)[0], defU=_j(dU)[0],
        defV=_j(dU)[0], **kw)
    got = tfz.fit_forward_zernike_subtomos_batch(
        pos, vals, Z, subs, rot, tilt, psi, c0, 0.01, N, 8, spec_mask=sm,
        vol_mask=vm, defU=dU, defV=dU, device="cpu", **kw)
    rel = lambda w: 1e-3 * np.abs(w).max()
    _hold(want, got, [rel, rel, lambda w: 1e-5, lambda w: 1e-5])
