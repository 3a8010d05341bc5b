"""ops/align.py and ops/features.center_translationally of the port against
the reference package on the CPU (N=48, B<=16).

Inputs: an asymmetric Gaussian-blob image, warped by seeded poses (psi
uniform, kept 5 degrees away from 45 + k*90, where the Fourier rotation's
quadrant is a roundoff tie, ROADMAP §3; shifts of +-3 px; half mirrored)
with a little noise. Held to: psi 0.1 degree (wrapped), shifts 0.02 px,
correlations 1e-4, flags and winner indices equal, aligned images
1e-4 * max. The per-pair form (one reference per image, image_align
--pspc) is held to the reference's vmap over pairs.
"""
import numpy as np
import pytest
import torch

import jax
from xmipp3_tpu.ops import align as jalign
from xmipp3_tpu.ops import features as jfeat
from xmipp3_tpu.ops import geo as jgeo
from xmipp3_tpu_torch.ops import align, features

torch.set_num_threads(1)
CPU = dict(device="cpu")
N = 48
BLOBS = [(0, 0, 4, 1.0), (6, -5, 2.5, 0.8), (-7, 3, 3, 0.6), (4, 8, 2, 0.9),
         (-3, -9, 2, 1.1)]


def _ref():
    y, x = np.mgrid[0:N, 0:N].astype(np.float32) - N // 2
    return sum(a * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * s * s))
               for cy, cx, s, a in BLOBS).astype(np.float32)


def _views(B, seed, mirror=True, psi_max=180.0):
    """The reference warped by seeded poses (psi in +-psi_max), half
    mirrored, with a little noise."""
    rng = np.random.default_rng(seed)
    psi = rng.uniform(-psi_max, psi_max, 4 * B)
    off = np.abs((psi - 45) % 90 - 45)
    psi = psi[np.abs(off - 45) > 5][:B].astype(np.float32)
    sx, sy = rng.uniform(-3, 3, (2, B)).astype(np.float32)
    flip = (rng.uniform(size=B) < 0.5) if mirror else None
    A = np.asarray(jgeo.alignment_matrices_2d(psi, sx, sy, flip))
    imgs = np.asarray(jgeo.apply_affine_2d(
        np.broadcast_to(_ref(), (B, N, N)), A, order=3))
    return imgs + 0.05 * rng.standard_normal(imgs.shape).astype(np.float32)


def _check(got, want, names):
    for g, w, name in zip(got, want, names):
        g = g.numpy().astype(np.float64)
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        if name == "psi":
            assert np.abs((g - w + 180) % 360 - 180).max() <= 0.1, name
        elif name in ("sx", "sy"):
            assert np.abs(g - w).max() <= 0.02, name
        elif name == "corr":
            assert np.abs(g - w).max() <= 1e-4, name
        elif name == "aligned":
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), name
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_rotation_from_fourier_mag():
    imgs = _views(12, 1, mirror=False)
    want = jalign.rotation_from_fourier_mag(_ref(), imgs)
    got = align.rotation_from_fourier_mag(_ref(), imgs, **CPU)
    assert np.abs((got[0].numpy() - np.asarray(want[0]) + 180) % 360
                  - 180).max() <= 0.1
    assert np.abs(got[1].numpy() - np.asarray(want[1])).max() <= 1e-4 * \
        np.abs(np.asarray(want[1])).max()


@pytest.mark.parametrize("order", [1, 3])
def test_iterative_align(order):
    imgs = _views(12, 2, mirror=False)
    want = jalign.iterative_align(_ref(), imgs, n_iters=3, max_shift=6,
                                  order=order)
    got = align.iterative_align(_ref(), imgs, n_iters=3, max_shift=6,
                                order=order, **CPU)
    _check(got, want, ("psi", "sx", "sy", "corr", "aligned"))
    assert (got[3] > 0.9).all()


def test_align_considering_mirrors():
    imgs = _views(16, 3)
    want = jalign.align_considering_mirrors(_ref(), imgs, n_iters=3,
                                            max_shift=6)
    got = align.align_considering_mirrors(_ref(), imgs, n_iters=3,
                                          max_shift=6, **CPU)
    _check(got, want, ("psi", "sx", "sy", "flip", "corr", "aligned"))
    assert got[3].any() and not got[3].all()


@pytest.mark.parametrize("mirror", [False, True])
def test_per_pair_references(mirror):
    imgs = _views(16, 4)
    refs, movs = imgs[::2], imgs[1::2]
    if mirror:
        one = lambda r, m: jalign.align_considering_mirrors(
            r, m[None], n_iters=3, max_shift=6)
        names = ("psi", "sx", "sy", "flip", "corr", "aligned")
        got = align.align_considering_mirrors(refs, movs, n_iters=3,
                                              max_shift=6, **CPU)
    else:
        one = lambda r, m: jalign.iterative_align(r, m[None], n_iters=3,
                                                  max_shift=6)
        names = ("psi", "sx", "sy", "corr", "aligned")
        got = align.iterative_align(refs, movs, n_iters=3, max_shift=6,
                                    **CPU)
    want = [np.asarray(v)[:, 0] for v in jax.vmap(one)(refs, movs)]
    _check(got, want, names)


def test_multireference_align():
    imgs = _views(10, 5, mirror=False)
    refs = np.stack([_ref(), _ref()[::-1].copy(), np.roll(_ref(), 5, 1)])
    want = jalign.multireference_align(refs, imgs, max_shift=6)
    got = align.multireference_align(refs, imgs, max_shift=6, **CPU)
    _check([got[k] for k in ("ref_idx", "psi", "sx", "sy", "corr")],
           [want[k] for k in ("ref_idx", "psi", "sx", "sy", "corr")],
           ("ref_idx", "psi", "sx", "sy", "corr"))
    assert np.abs(got["corr_matrix"].numpy()
                  - np.asarray(want["corr_matrix"])).max() <= 1e-4


@pytest.mark.parametrize("order", [1, 3])
def test_center_translationally(order):
    """On noisy views: on a noiseless blob image the correlation with a
    mirror can hold two equal peaks, which roundoff then picks between."""
    imgs = _views(6, 6)
    want = np.asarray(jfeat.center_translationally(imgs, order=order))
    got = features.center_translationally(imgs, order=order, **CPU)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
