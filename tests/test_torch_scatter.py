"""The port's three gridding kernels (K1 scatter_add_3ch, K2 tri_scatter,
K3 kb_scatter_3ch) through their plain versions on the CPU, against the
reference package on the same numpy inputs (each CUDA kernel against its
plain version is in test_torch_kernels.py).

On the CPU the reference's Pallas kernels are reached through their XLA
paths: scatter_add_3ch is `.at[].add`, kb uses the exact-Bessel tap
expansion (kb_fastpath_ok is False off the TPU) and tri the 8-tap
expansion (the packed mode is TPU-only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import particle_batch, rel_err
from xmipp3_tpu.core.geometry import euler_matrix
from xmipp3_tpu.ops import reconstruct as jrec
from xmipp3_tpu.ops.pallas_scatter import scatter_add_3ch as jax_scatter3
from xmipp3_tpu.ops.pallas_scatter_kb import _window_poly as jax_window_poly
from xmipp3_tpu_torch.ops import reconstruct as trec
from xmipp3_tpu_torch.ops import scatter, scatter_kb, scatter_tri

torch.set_num_threads(1)

N, P, C = 32, 64, 8


def test_k1_plain_matches_reference_scatter():
    rng = np.random.default_rng(1)
    S, M = P ** 3, 200_000
    idx = rng.integers(0, S, M).astype(np.int32)
    idx[:5000] = idx[0]                              # heavy duplicates
    vals = rng.standard_normal((3, M)).astype(np.float32)
    base = rng.standard_normal((3, S)).astype(np.float32)
    want = [np.asarray(a) for a in jax_scatter3(
        *map(jnp.asarray, base), jnp.asarray(idx), *map(jnp.asarray, vals))]
    got = scatter.scatter_add_3ch(*(torch.tensor(b) for b in base),
                                  torch.tensor(idx),
                                  *(torch.tensor(v) for v in vals))
    for g, w in zip(got, want):
        assert rel_err(g, w) <= 1e-5


def _backproject_both(interp, seed=0, blob=None):
    b = particle_batch(seed, C, N)
    mats = np.asarray(euler_matrix(b["rot"], b["tilt"], b["psi"]), np.float32)
    args = (b["imgs"], mats, b["sx"], b["sy"], b["w"], P)
    kw = dict(interp=interp)
    if blob is not None:
        kw["blob"] = blob
    z = np.zeros((P, P, P), np.float32)
    want = [np.asarray(a) for a in jrec.backproject_chunk(z, z, z, *args,
                                                          **kw)]
    cubes = [torch.zeros((P, P, P)) for _ in range(3)]
    got = trec.backproject_chunk(*cubes, *args, **kw)
    assert all(g is c for g, c in zip(got, cubes)), "updates in place"
    return got, want


@pytest.mark.parametrize("interp,tol", [("tri", 1e-4), ("tri+kb", 1e-4),
                                        ("nn", 1e-4)])
def test_backproject_tri_and_nn_match_reference(interp, tol):
    got, want = _backproject_both(interp)
    for g, w in zip(got, want):
        assert rel_err(g, w) <= tol


def test_backproject_kb_matches_reference_exact_bessel():
    """K3's plain version (polynomial window, whole-sample drop at the
    Nyquist edge) against the reference's exact-Bessel tap path, to the
    bound the TPU kernel was held to."""
    got, want = _backproject_both("kb")
    for g, w in zip(got, want):
        assert rel_err(g, w) <= 5e-3


def test_backproject_kb_wide_blob_takes_tap_expansion():
    """kb with a blob radius above 2 goes through K1 with the exact window,
    as the reference's generic path does."""
    got, want = _backproject_both("kb", seed=2, blob=(2.5, 0, 10.0))
    for g, w in zip(got, want):
        assert rel_err(g, w) <= 1e-4


@pytest.mark.parametrize("blob", [(1.9, 15.0, 0), (2.0, 10.4, 2)])
def test_window_poly_matches_reference(blob):
    ours = scatter_kb._window_poly(*blob)
    theirs = jax_window_poly(*blob)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-12)


def test_kb_plain_drops_samples_outside_the_cube():
    """A sample whose floor lies outside [0, P) on any axis adds nothing;
    one inside adds its window sum to the weight channel."""
    P_ = 8
    zi = torch.tensor([3.5, -0.5, 3.5, 7.5])
    yi = torch.tensor([3.5, 3.5, 8.25, 7.5])
    xi = torch.tensor([3.5, 3.5, 3.5, 7.5])
    ones = torch.ones(4)
    cubes = [torch.zeros(P_ ** 3) for _ in range(3)]
    scatter_kb.kb_scatter_3ch(*cubes, zi, yi, xi, ones, ones, ones, P=P_,
                              radius=1.9, alpha=15.0, order=0)
    only = [torch.zeros(P_ ** 3) for _ in range(3)]
    for k in (0, 3):
        scatter_kb.kb_scatter_3ch(*only, zi[k:k + 1], yi[k:k + 1],
                                  xi[k:k + 1], ones[:1], ones[:1], ones[:1],
                                  P=P_, radius=1.9, alpha=15.0, order=0)
    torch.testing.assert_close(cubes[2], only[2])
    assert float(cubes[2].sum()) > 0


def test_tri_plain_masks_each_corner_per_axis():
    """A sample at the upper edge spreads only onto the corners inside the
    cube (reference reconstruct.py:254-256), with trilinear weights."""
    P_ = 4
    cubes = [torch.zeros(P_ ** 3) for _ in range(3)]
    one = torch.ones(1)
    scatter_tri.tri_scatter(*cubes, torch.tensor([1.25]), torch.tensor([3.5]),
                            torch.tensor([2.0]), one, 2 * one, one, P=P_)
    w = cubes[2].reshape(P_, P_, P_)
    assert float(w.sum()) == pytest.approx(0.5)     # y+1 = 4 is outside
    assert float(w[1, 3, 2]) == pytest.approx(0.75 * 0.5)
    assert float(w[2, 3, 2]) == pytest.approx(0.25 * 0.5)
    torch.testing.assert_close(cubes[1], 2 * cubes[0])


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "size"])
def test_wrappers_reject_bad_operands(bad):
    cubes = [torch.zeros(P ** 3) for _ in range(3)]
    idx = torch.zeros(10, dtype=torch.int32)
    vals = [torch.ones(10) for _ in range(3)]
    if bad == "dtype":
        idx = idx.long()
    elif bad == "contiguous":
        vals[0] = torch.ones(20)[::2]
    else:
        cubes[1] = torch.zeros(P ** 3 - 1)
    with pytest.raises((TypeError, ValueError)):
        scatter.scatter_add_3ch(*cubes, idx, *vals)
    coords = [torch.ones(10) for _ in range(3)]
    if bad == "dtype":
        coords[0] = coords[0].double()
    with pytest.raises((TypeError, ValueError)):
        scatter_tri.tri_scatter(*cubes, *coords, *vals, P=P)
    with pytest.raises((TypeError, ValueError)):
        scatter_kb.kb_scatter_3ch(*cubes, *coords, *vals, P=P, radius=1.9,
                                  alpha=15.0, order=0)


def test_kb_wrapper_rejects_radius_beyond_its_footprint():
    cubes = [torch.zeros(P ** 3) for _ in range(3)]
    v = torch.ones(4)
    with pytest.raises(ValueError, match="radius"):
        scatter_kb.kb_scatter_3ch(*cubes, v, v, v, v, v, v, P=P, radius=2.5,
                                  alpha=10.0, order=0)


def test_unpack_packed_cube_round_trips_reference_pack():
    from xmipp3_tpu.ops.pallas_scatter_tri import packed_cube_pack
    P_ = 64
    cubes3 = np.random.default_rng(3).standard_normal(
        (3, P_, P_, P_)).astype(np.float32)
    packed = np.asarray(packed_cube_pack(cubes3, P_))
    np.testing.assert_array_equal(scatter_tri.unpack_packed_cube(packed, P_),
                                  cubes3)


def test_k5_streams_match_the_reference_fallback():
    """K5's wrapper on the CPU (per-stream index_add_) against the
    reference's scatter_add_3ch_streams off the TPU, on sorted streams with
    out-of-range indices that carry zeros; <= 1e-5 * max (float32 sums of
    duplicates in another order)."""
    from xmipp3_tpu.ops.pallas_scatter import scatter_add_3ch_streams as jref
    rng = np.random.default_rng(7)
    S, ns, M = 40_000, 8, 30_000
    idx = np.sort(rng.integers(-50, S + 50, (ns, M)), axis=1).astype(np.int32)
    idx[:, 1000:3000] = idx[:, 1000:1001]            # heavy duplicates
    vals = rng.standard_normal((ns, 3, M)).astype(np.float32)
    vals *= ((idx >= 0) & (idx < S))[:, None, :]
    base = rng.standard_normal((3, S)).astype(np.float32)
    want = [np.asarray(a) for a in jref(
        *map(jnp.asarray, base), [jnp.asarray(i) for i in idx],
        [tuple(jnp.asarray(c) for c in v) for v in vals], use_pallas=False)]
    cubes = [torch.tensor(b) for b in base]
    args = (torch.tensor(idx), torch.tensor(vals))
    before = scatter.streams_launches
    got = scatter.scatter_add_3ch_streams(*cubes, *args)
    assert scatter.streams_launches == before   # CPU tensors: plain version
    for g, c, w in zip(got, cubes, want):
        assert g is c                            # in place
        assert rel_err(g, w) <= 1e-5


def test_k5_rejects_what_the_kernel_does_not_take():
    c = [torch.zeros(10) for _ in range(3)]
    idx = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(ns, 3, M\)"):
        scatter.scatter_add_3ch_streams(*c, idx, torch.zeros(2, 4))
    with pytest.raises(TypeError, match="int32"):
        scatter.scatter_add_3ch_streams(*c, idx.long(), torch.zeros(2, 3, 4))
