"""The port's four scatter kernels (K1 scatter_add_3ch, K2 tri_scatter,
K3 kb_scatter_3ch, K5 scatter_add_3ch_streams) through their plain versions
on the CPU, against the reference package on the same numpy inputs (each
CUDA kernel against its plain version is in test_torch_kernels.py); and
what can be checked of the kernels' build without a compiler: that every
wrapper's binding matches its C source, and that a header edit rebuilds.

On the CPU the reference's Pallas kernels are reached through their XLA
paths: scatter_add_3ch is `.at[].add`, kb uses the exact-Bessel tap
expansion (kb_fastpath_ok is False off the TPU) and tri the 8-tap
expansion (the packed mode is TPU-only).
"""
import ctypes
import importlib
import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (K1_CASES, KB_EDGE_P, KB_SLABS, SCATTER_CASES,
                               TRI_EDGE_P, kb_edge_samples, kb_slab_samples,
                               particle_batch, rel_err, scatter_case,
                               tensor_at_offset, tri_edge_samples)
from xmipp3_tpu.core.geometry import euler_matrix
from xmipp3_tpu.ops import reconstruct as jrec
from xmipp3_tpu.ops.pallas_scatter import scatter_add_3ch as jax_scatter3
from xmipp3_tpu.ops.pallas_scatter import \
    scatter_add_3ch_streams as jax_scatter3_streams
from xmipp3_tpu.ops.pallas_scatter_kb import _window_poly as jax_window_poly
from xmipp3_tpu_torch.ops import _cuda_build as cb
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
    """kb with a blob radius above 2 goes through the tap expansion with
    the exact window, one stream per tap into K5 (on the CPU its plain
    version), and agrees with the reference's generic path."""
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


def test_kb_plain_at_the_cube_edges_matches_a_numpy_gridding():
    """K3's contract on samples at every floor x (so at every residue of a
    row's start mod 4) and at the cube's faces (kb_edge_samples): 4^3 taps
    at -1..2 from the floor, the reference's polynomial window clamped at 0
    and zero beyond r^2, a sample with its floor outside the cube dropped
    whole, a tap outside it skipped. The wrapper's plain version (what the
    CPU runs) against numpy in float64: <= 1e-5 * max."""
    samples = kb_edge_samples()
    want, used = _kb_numpy(samples)
    assert used == samples[0].size - 6
    cubes = [torch.zeros(KB_EDGE_P ** 3) for _ in range(3)]
    got = scatter_kb.kb_scatter_3ch(*cubes, *map(torch.as_tensor, samples),
                                    P=KB_EDGE_P, **KB)
    for g, w in zip(got, want):
        assert rel_err(g, w.reshape(-1)) <= 1e-5


KB = dict(radius=1.9, alpha=15.0, order=0)


def _kb_numpy(samples, z_lo=0, zdim=KB_EDGE_P):
    """K3's contract in float64 numpy: the gridding of the samples into the
    slab [z_lo, z_lo + zdim) of a KB_EDGE_P cube (the full cube by
    default); returns (3, zdim, P, P) and the count of samples not dropped."""
    zi, yi, xi, v0, v1, v2 = samples
    P_ = KB_EDGE_P
    poly = np.asarray(jax_window_poly(KB["radius"], KB["alpha"],
                                      KB["order"]))
    want = np.zeros((3, zdim, P_, P_))
    used = 0
    for s in range(zi.size):
        at = np.array([zi[s], yi[s], xi[s]], np.float64)
        f = np.floor(at).astype(int)
        if ((f < 0) | (f >= P_)).any():
            continue
        used += 1
        for d in itertools.product(range(-1, 3), repeat=3):
            j = f + d
            d2 = float(((np.array(d) - (at - f)) ** 2).sum())
            if ((j < 0) | (j >= P_)).any() or d2 > KB["radius"] ** 2 \
                    or not z_lo <= j[0] < z_lo + zdim:
                continue
            wt = max(np.polyval(poly, d2), 0.0)
            want[:, j[0] - z_lo, j[1], j[2]] += wt * np.array(
                [v0[s], v1[s], v2[s]])
    return want, used


@pytest.mark.parametrize("z_lo,zdim", KB_SLABS)
def test_kb_plain_slab_mode_matches_a_numpy_gridding(z_lo, zdim):
    """K3's kz-slab contract on samples with floors on both sides of both
    slab faces (kb_slab_samples): the whole-sample drop tests the absolute
    floor against [0, P), a tap is kept where its absolute plane lies in
    the slab, at the slab's row; the wrapper's plain version against numpy
    in float64, <= 1e-5 * max."""
    samples = kb_slab_samples(z_lo, zdim)
    want, _ = _kb_numpy(samples, z_lo, zdim)
    assert np.abs(want).max() > 0
    cubes = [torch.zeros(zdim * KB_EDGE_P ** 2) for _ in range(3)]
    got = scatter_kb.kb_scatter_3ch(*cubes, *map(torch.as_tensor, samples),
                                    P=KB_EDGE_P, zdim=zdim, z_lo=z_lo, **KB)
    for g, w in zip(got, want):
        assert rel_err(g, w.reshape(-1)) <= 1e-5


def test_kb_wrapper_checks_the_slab():
    """A slab must lie in the cube, and each operand must hold zdim * P * P
    elements."""
    v = torch.zeros(4)
    slab = lambda n: [torch.zeros(n) for _ in range(3)]
    with pytest.raises(ValueError, match="does not lie in a cube"):
        scatter_kb.kb_scatter_3ch(*slab(4 * 64), v, v, v, v, v, v, P=8,
                                  zdim=4, z_lo=5, **KB)
    with pytest.raises(ValueError, match="expected 256"):
        scatter_kb.kb_scatter_3ch(*slab(8 ** 3), v, v, v, v, v, v, P=8,
                                  zdim=4, z_lo=4, **KB)


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


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_tri_plain_at_the_cube_edges_matches_the_reference_taps(offset):
    """K2's contract on tri_edge_samples (floors at every residue of x
    mod 4 and at -1 and P - 1 on each axis, fractions of exactly 0, samples
    with no corner inside): the wrapper's plain version (what the CPU runs),
    into cubes that start 0-3 floats past an allocation, against the
    reference's XLA path on the same samples, its 8-tap expansion with the
    per-axis mask (xmipp3_tpu/ops/reconstruct.py:236-268) into its
    scatter_add_3ch. The same float32 products summed in another
    order: <= 1e-6 * max."""
    zi, yi, xi, v0, v1, v2 = tri_edge_samples()
    P_ = TRI_EDGE_P
    at = [jnp.asarray(a) for a in (zi, yi, xi)]
    lo = [jnp.floor(a).astype(jnp.int32) for a in at]
    fz, fy, fx = (a - f for a, f in zip(at, lo))
    idx, vals = [], []
    for dz, dy, dx in jrec._taps("tri"):
        w = (jnp.where(dz, fz, 1 - fz) * jnp.where(dy, fy, 1 - fy)
             * jnp.where(dx, fx, 1 - fx))
        zj, yj, xj = (f + d for f, d in zip(lo, (dz, dy, dx)))
        inside = ((zj >= 0) & (zj < P_) & (yj >= 0) & (yj < P_) & (xj >= 0)
                  & (xj < P_))
        w = jnp.where(inside, w, 0.0)
        idx.append((jnp.clip(zj, 0, P_ - 1) * P_ + jnp.clip(yj, 0, P_ - 1))
                   * P_ + jnp.clip(xj, 0, P_ - 1))
        vals.append([w * v for v in (v0, v1, v2)])
    zero = jnp.zeros(P_ ** 3, jnp.float32)
    want = jax_scatter3(zero, zero, zero, jnp.concatenate(idx),
                        *(jnp.concatenate([v[k] for v in vals])
                          for k in range(3)))
    cubes = [tensor_at_offset(np.zeros(P_ ** 3, np.float32), offset)
             for _ in range(3)]
    got = scatter_tri.tri_scatter(
        *cubes, *map(torch.as_tensor, (zi, yi, xi, v0, v1, v2)), P=P_)
    for g, c, w in zip(got, cubes, want):
        assert g is c
        assert rel_err(g, np.asarray(w)) <= 1e-6


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


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("kind,M,ns", K1_CASES)
def test_k1_matches_the_reference_on_ragged_streams(kind, M, ns, misaligned):
    """K1's wrapper on the CPU against the reference's scatter_add_3ch on
    ragged stream lengths, duplicates and (x, x+1) neighbours, the operands
    also as slices that start 4 bytes into a buffer; <= 1e-6 * max (the
    same sums, float32 order differs)."""
    base, idx, vals = scatter_case(kind, M, ns)
    want = [np.asarray(a) for a in jax_scatter3(
        *map(jnp.asarray, base), jnp.asarray(idx[0]),
        *map(jnp.asarray, vals[0]))]
    at = lambda a: tensor_at_offset(a, int(misaligned))
    got = scatter.scatter_add_3ch(*map(at, base), at(idx[0]),
                                  *map(at, vals[0]))
    for g, w in zip(got, want):
        assert rel_err(g, w) <= 1e-6


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("kind,M,ns", SCATTER_CASES)
def test_k5_matches_the_reference_on_ragged_streams(kind, M, ns, misaligned):
    """K5's wrapper on the CPU against the reference's fallback off the TPU
    on 1, 3 and 8 ragged streams, with out-of-range indices that carry
    zeros; <= 1e-6 * max (the same sums, float32 order differs)."""
    base, idx, vals = scatter_case(kind, M, ns)
    want = [np.asarray(a) for a in jax_scatter3_streams(
        *map(jnp.asarray, base), [jnp.asarray(i) for i in idx],
        [tuple(jnp.asarray(c) for c in v) for v in vals], use_pallas=False)]
    at = lambda a: tensor_at_offset(a, int(misaligned))
    got = scatter.scatter_add_3ch_streams(*map(at, base), at(idx), at(vals))
    for g, w in zip(got, want):
        assert rel_err(g, w) <= 1e-6


def test_tap_streams_clip_and_mask_each_tap():
    """expand_tap_streams (for K5): per tap the flat index clipped into the
    cube and the values times the weight, zero where the voxel lies outside
    on any axis; expand_taps (for K1) is the same, tap-major and flat."""
    rng = np.random.default_rng(5)
    P_, M = 8, 500
    z0, y0, x0 = (rng.integers(-2, P_ + 2, M).astype(np.int32)
                  for _ in range(3))
    v = rng.standard_normal((3, M)).astype(np.float32)
    frac = rng.uniform(0, 1, M).astype(np.float32)
    weight = lambda dz, dy, dx: torch.tensor(frac) + dz + 2 * dy + 4 * dx
    args = (*map(torch.tensor, (z0, y0, x0)), scatter_tri.TRI_TAPS, weight,
            *map(torch.tensor, v), P_)
    idx_s, v_s = scatter.expand_tap_streams(*args)
    assert idx_s.dtype == torch.int32 and idx_s.shape == (8, M)
    assert v_s.shape == (8, 3, M) and v_s.is_contiguous()
    for t, (dz, dy, dx) in enumerate(scatter_tri.TRI_TAPS):
        zj, yj, xj = z0 + dz, y0 + dy, x0 + dx
        inside = np.all([(a >= 0) & (a < P_) for a in (zj, yj, xj)], axis=0)
        flat = (np.clip(zj, 0, P_ - 1) * P_ + np.clip(yj, 0, P_ - 1)) * P_ \
            + np.clip(xj, 0, P_ - 1)
        np.testing.assert_array_equal(idx_s[t].numpy(), flat)
        want = np.where(inside, frac + dz + 2 * dy + 4 * dx, 0) * v
        np.testing.assert_allclose(v_s[t].numpy(), want, rtol=1e-6, atol=0)
    idx, *u = scatter.expand_taps(*args)
    assert all(a.is_contiguous() for a in (idx, *u))
    torch.testing.assert_close(idx, idx_s.reshape(-1), rtol=0, atol=0)
    for k in range(3):
        torch.testing.assert_close(u[k], v_s[:, k].reshape(-1), rtol=0,
                                   atol=0)


@pytest.mark.parametrize("streams", [False, True])
def test_wrappers_reject_accumulators_beyond_int32(streams):
    """S >= 2**31 cannot be addressed by the int32 indices: refused before
    anything else is looked at (meta tensors carry the size, no memory)."""
    big = [torch.empty(2 ** 31, device="meta") for _ in range(3)]
    idx = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        if streams:
            scatter.scatter_add_3ch_streams(*big, idx, torch.zeros(2, 3, 4))
        else:
            scatter.scatter_add_3ch(*big, idx[0], *torch.zeros(3, 4))


_C_TYPES = {"int64_t": ctypes.c_int64, "int": ctypes.c_int,
            "float": ctypes.c_float, "double": ctypes.c_double}
_BINDINGS = sorted(
    (mod, *m.groups())
    for mod in ("scatter", "scatter_tri", "scatter_kb", "cross")
    for m in re.finditer(
        r'cb\.bind\(\s*"(\w+)",\s*"(\w+)",\s*(\w+)\s*\)',
        (cb.CSRC.parent / "ops" / f"{mod}.py").read_text()))


def test_every_wrapper_binding_is_found():
    assert {b[2] for b in _BINDINGS} == {
        "xm_scatter_add_3ch", "xm_scatter_add_3ch_streams", "xm_tri_scatter",
        "xm_kb_scatter", "xm_cross_spectrum"}


@pytest.mark.parametrize("mod,name,symbol,argtypes", _BINDINGS)
def test_wrapper_binds_an_extern_c_function_of_its_source(mod, name, symbol,
                                                          argtypes):
    """Each cb.bind(name, symbol, argtypes) of a wrapper names an
    extern "C" int function of csrc/<name>.cu whose parameters match
    argtypes one by one (a pointer is c_void_p): nothing compiles without
    nvcc, and this catches a wrapper and a source that drifted apart."""
    source = (cb.CSRC / f"{name}.cu").read_text()
    decl = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", source)
    assert decl, f"no extern \"C\" int {symbol}(...) in csrc/{name}.cu"
    params = [" ".join(p.split()) for p in decl.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in p
            else _C_TYPES[p.replace("const ", "").split()[0]] for p in params]
    got = getattr(importlib.import_module(f"xmipp3_tpu_torch.ops.{mod}"),
                  argtypes)
    assert list(got) == want, (params, got)


def test_build_target_changes_with_a_header(tmp_path, monkeypatch):
    """A library's name hashes its source and every csrc/*.cuh, so an
    edited header rebuilds the sources that include it."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(cb, "CSRC", tmp_path)
    first = cb._target("k")[1]
    assert cb._target("k")[1] == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = cb._target("k")[1]
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert cb._target("k")[1] not in (first, second)
