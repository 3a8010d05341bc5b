"""On a card only: each CUDA kernel of the port against its plain version,
and the whole reconstruction and the matching program on the card against
the same on the CPU.

This file imports neither jax nor the reference package, so that it also
runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(`--noconftest` skips tests/conftest.py, which sets up jax for the other
test files). Without a card every test here skips.
"""
import numpy as np
import pytest
import torch

from test_torch_common import (K1_CASES, SCATTER_CASES, phantom_batch,
                               rel_err, require_cuda, scatter_case,
                               tensor_at_offset)
from xmipp3_tpu_torch.core.geometry import euler_matrix
from xmipp3_tpu_torch.ops import reconstruct as trec
from xmipp3_tpu_torch.ops import cross, scatter, scatter_kb, scatter_tri

KB = dict(radius=1.9, alpha=15.0, order=0)
KERNELS = ["scatter_add_3ch", "tri_scatter", "kb_scatter_3ch"]


def _card_samples(seed=0, N=64, P=128):
    """Slice samples of 64 random poses at N, P and three value streams."""
    b = phantom_batch(seed, 64, N)
    mats = torch.as_tensor(euler_matrix(b["rot"], b["tilt"], b["psi"]),
                           device="cuda")
    coords = [a.reshape(-1).contiguous()
              for a in trec._slice_tap_coords(mats, N, P, 0.5)]
    rng = np.random.default_rng(seed)
    vals = [torch.as_tensor(rng.standard_normal(coords[0].numel()).astype(
        np.float32), device="cuda") for _ in range(3)]
    return coords, vals, P


def _kernel_and_plain(kernel, coords, vals, P):
    """(module, fn(cubes) launching the kernel, fn(cubes) of its plain
    version) on the same inputs."""
    zi, yi, xi = coords
    if kernel == "scatter_add_3ch":
        z0, y0, x0 = (torch.round(a).to(torch.int32) for a in coords)
        stream = scatter.expand_taps(z0, y0, x0, [(0, 0, 0)],
                                     lambda *_: torch.ones_like(zi), *vals, P)
        return (scatter, lambda c: scatter.scatter_add_3ch(*c, *stream),
                lambda c: scatter.scatter_add_3ch_plain(*c, *stream))
    if kernel == "tri_scatter":
        return (scatter_tri,
                lambda c: scatter_tri.tri_scatter(*c, *coords, *vals, P=P),
                lambda c: scatter_tri.tri_scatter_plain(*c, *coords, *vals,
                                                        P=P))
    return (scatter_kb,
            lambda c: scatter_kb.kb_scatter_3ch(*c, *coords, *vals, P=P, **KB),
            lambda c: scatter_kb.kb_scatter_plain(*c, *coords, *vals, P=P,
                                                  **KB))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
def test_cuda_kernel_matches_plain(kernel):
    require_cuda()
    coords, vals, P = _card_samples()
    mod, run, plain = _kernel_and_plain(kernel, coords, vals, P)
    ck = [torch.zeros(P ** 3, device="cuda") for _ in range(3)]
    cp = [torch.zeros(P ** 3, device="cuda") for _ in range(3)]
    before = mod.launches
    run(ck)
    plain(cp)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    for a, b in zip(ck, cp):
        assert rel_err(a, b) <= 1e-4      # atomics add in another order


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
def test_cuda_wrappers_reject_operands_off_the_card(kernel):
    """A cube on the card with samples on the host raises: the wrapper
    neither copies nor falls back to the plain version."""
    require_cuda()
    coords, vals, P = _card_samples()
    mod, run, _ = _kernel_and_plain(kernel, coords, vals, P)
    before = mod.launches
    cubes = [torch.zeros(P ** 3, device="cuda") for _ in range(2)]
    with pytest.raises(ValueError, match="on"):
        run(cubes + [torch.zeros(P ** 3)])
    assert mod.launches == before


@pytest.mark.cuda
def test_profiler_trace_shows_the_kernel_on_the_card(tmp_path):
    """`--trace` (core/timing.trace) records the card's activity: the
    exported Chrome trace names the CUDA kernel that ran inside it."""
    require_cuda()
    from xmipp3_tpu_torch.core import timing
    coords, vals, P = _card_samples()
    _, run, _ = _kernel_and_plain("kb_scatter_3ch", coords, vals, P)
    cubes = [torch.zeros(P ** 3, device="cuda") for _ in range(3)]
    with timing.trace(str(tmp_path)):
        run(cubes)
        torch.cuda.synchronize()
    assert "kb_scatter_kernel" in (tmp_path / "trace.json").read_text()


@pytest.mark.cuda
@pytest.mark.parametrize("interp,tol",[("kb", 1e-4), ("tri+kb", 1e-4),
                                        ("nn", 1e-4)])
def test_reconstruct_on_the_card_matches_the_cpu(interp, tol):
    """The whole slice (FFTs, shift phases, disk compaction, the kernel,
    finalize) on the card against the same code on the CPU, where the
    kernels' plain versions run."""
    require_cuda()
    b = phantom_batch(31, 32, 32)
    args = (b["imgs"], b["rot"], b["tilt"], b["psi"])
    kw = dict(sx=b["sx"], sy=b["sy"], weights=b["w"], flip=b["flip"],
              sym="c4", interp=interp, batch=16)
    got = trec.reconstruct_fourier(*args, **kw, device="cuda")
    want = trec.reconstruct_fourier(*args, **kw, device="cpu")
    assert got.is_cuda and got.shape == (32, 32, 32)
    assert rel_err(got, want) <= tol


def _ring_spectra(B, nr, R, K, seed=5):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.as_tensor(
        (rng.standard_normal(s) + 1j * rng.standard_normal(s)).astype(
            np.complex64), device="cuda")
    w = torch.as_tensor(rng.uniform(0.1, 1.0, nr).astype(np.float32),
                        device="cuda")
    return mk(B, nr, K), mk(R, nr, K), w


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 31, 200, 64), (5, 3, 7, 9),
                                   (33, 17, 50, 70)])
@pytest.mark.parametrize("mirror", [False, True])
def test_cross_spectrum_kernel_matches_plain(shape, mirror):
    """K4 at the main path's ring and harmonic counts and at ragged sizes
    that exercise every edge mask; <= 1e-5 * max (fixed summation order,
    no atomics)."""
    require_cuda()
    fi, fr, w = _ring_spectra(*shape)
    before = cross.launches
    got = cross.cross_spectrum(fi, fr, w, mirror=mirror)
    torch.cuda.synchronize()
    assert cross.launches == before + 1
    want = cross.cross_spectrum_plain(fi, fr, w, mirror=mirror)
    for g, p in zip(got if mirror else [got], want if mirror else [want]):
        assert g.shape == (shape[0], shape[2], shape[3])
        assert rel_err(g, p) <= 1e-5


@pytest.mark.cuda
def test_streams_kernel_matches_plain():
    """K5 on the 8 trilinear tap streams of a batch; <= 1e-4 * max (the
    atomics add in another order)."""
    require_cuda()
    coords, vals, P = _card_samples()
    idx, u0, u1, u2 = scatter_tri.tri_expand(*coords, *vals, P)
    idx = idx.view(8, -1)
    v = torch.stack([u.view(8, -1) for u in (u0, u1, u2)], dim=1).contiguous()
    ck = [torch.zeros(P ** 3, device="cuda") for _ in range(3)]
    cp = [torch.zeros(P ** 3, device="cuda") for _ in range(3)]
    before = scatter.streams_launches
    scatter.scatter_add_3ch_streams(*ck, idx, v)
    scatter.scatter_add_3ch_streams_plain(*cp, idx, v)
    torch.cuda.synchronize()
    assert scatter.streams_launches == before + 1
    for a, b in zip(ck, cp):
        assert rel_err(a, b) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("kind,M,ns", K1_CASES)
def test_k1_kernel_matches_plain_on_ragged_streams(kind, M, ns, misaligned):
    """K1 on stream lengths around the warp and block sizes, every update
    on one voxel (the warp-aggregated add), (x, x+1) neighbours, S no
    multiple of 8, and operands that start 4 bytes into a buffer;
    <= 1e-4 * max (the atomics add in another order)."""
    require_cuda()
    base, idx, vals = scatter_case(kind, M, ns)
    at = lambda a: tensor_at_offset(a, int(misaligned), "cuda")
    stream = (at(idx[0]), *map(at, vals[0]))
    before = scatter.launches
    got = scatter.scatter_add_3ch(*map(at, base), *stream)
    want = scatter.scatter_add_3ch_plain(*map(at, base), *stream)
    torch.cuda.synchronize()
    assert scatter.launches == before + 1
    for g, w in zip(got, want):
        assert rel_err(g, w) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("kind,M,ns", SCATTER_CASES)
def test_k5_kernel_matches_plain_on_ragged_streams(kind, M, ns, misaligned):
    """K5 on 1, 3 and 8 streams (the chunk of 8, the pair loop and the odd
    stream left over), (x, x+1) neighbours in streams (2t, 2t+1) at even
    and odd x with the accumulators on and off an 8-byte boundary (both
    sides of the float2 atomic's alignment branch), contention on one
    voxel and out-of-range indices, which are skipped; <= 1e-4 * max."""
    require_cuda()
    base, idx, vals = scatter_case(kind, M, ns)
    at = lambda a: tensor_at_offset(a, int(misaligned), "cuda")
    streams = (at(idx), at(vals))
    before = scatter.streams_launches
    got = scatter.scatter_add_3ch_streams(*map(at, base), *streams)
    want = scatter.scatter_add_3ch_streams_plain(*map(at, base), *streams)
    torch.cuda.synchronize()
    assert scatter.streams_launches == before + 1
    for g, w in zip(got, want):
        assert rel_err(g, w) <= 1e-4


@pytest.mark.cuda
def test_k5_skips_out_of_range_indices_whatever_they_carry():
    """An index outside [0, S) is dropped by the kernel itself, not merely
    harmless because its value is zero."""
    require_cuda()
    base, idx, vals = scatter_case("out_of_range", 1025, 3)
    vals = np.random.default_rng(3).standard_normal(vals.shape).astype(
        np.float32)
    inside = ((idx >= 0) & (idx < base.shape[1]))[:, None, :]
    cubes = [torch.tensor(b, device="cuda") for b in base]
    got = scatter.scatter_add_3ch_streams(
        *cubes, torch.tensor(idx, device="cuda"),
        torch.tensor(vals, device="cuda"))
    want = scatter.scatter_add_3ch_streams_plain(
        *(torch.tensor(b, device="cuda") for b in base),
        torch.tensor(idx, device="cuda"),
        torch.tensor(vals * inside, device="cuda"))
    for g, w in zip(got, want):
        assert rel_err(g, w) <= 1e-4


@pytest.mark.cuda
def test_wide_blob_on_the_card_goes_through_the_streams_kernel():
    """A blob wider than K3's footprint takes the tap expansion and K5, one
    launch a batch; the volume agrees with the CPU's."""
    require_cuda()
    b = phantom_batch(32, 32, 32)
    args = (b["imgs"], b["rot"], b["tilt"], b["psi"])
    kw = dict(sx=b["sx"], sy=b["sy"], weights=b["w"], flip=b["flip"],
              interp="kb", blob=(2.5, 0, 10.0), batch=16)
    before = scatter.streams_launches
    got = trec.reconstruct_fourier(*args, **kw, device="cuda")
    assert scatter.streams_launches == before + 2
    want = trec.reconstruct_fourier(*args, **kw, device="cpu")
    assert rel_err(got, want) <= 1e-4


@pytest.mark.cuda
def test_cross_and_streams_wrappers_reject_operands_off_the_card():
    require_cuda()
    fi, fr, w = _ring_spectra(4, 3, 5, 8)
    before = cross.launches, scatter.streams_launches
    with pytest.raises(ValueError, match="on"):
        cross.cross_spectrum(fi, fr.cpu(), w)
    with pytest.raises(ValueError, match="on"):
        cross.cross_spectrum(fi.cpu(), fr.cpu(), w)
    c = [torch.zeros(10, device="cuda") for _ in range(3)]
    with pytest.raises(ValueError, match="on"):
        scatter.scatter_add_3ch_streams(
            *c, torch.zeros((2, 4), dtype=torch.int32),
            torch.zeros((2, 3, 4), device="cuda"))
    assert (cross.launches, scatter.streams_launches) == before


@pytest.mark.cuda
def test_matching_program_on_the_card_matches_the_cpu(tmp_path):
    """Gallery and matching programs on the card against --device cpu:
    the same gallery to 1e-4 * max; the same reference and flip (the exact
    antipodal-mirror tie counted as the same direction) for >= 98 % of the
    particles and, on the same rows, psi <= 0.5 deg and shifts <= 0.05 px."""
    require_cuda()
    from xmipp3_tpu_torch.core.image import Image, save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    from xmipp3_tpu_torch.core.sampling import directions_from_angles
    from xmipp3_tpu_torch.ops.geo import apply_alignment_2d
    from xmipp3_tpu_torch.programs import get_program
    N, B = 32, 48
    z, y, x = np.mgrid[0:N, 0:N, 0:N].astype(np.float32) - N // 2
    vol = sum(a * np.exp(-((z - cz) ** 2 + (y - cy) ** 2 + (x - cx) ** 2)
                         / (2 * s ** 2))
              for cz, cy, cx, s, a in [(0, 0, 0, 3.0, 1.0), (4, -3, 3, 2.0, .8),
                                       (-3, 3, -2, 2.5, .6), (2, 4, -4, 1.8, .9),
                                       (-5, -5, 1, 1.5, 1.1)])
    save_image(str(tmp_path / "v.vol"), vol.astype(np.float32))
    for dev in ("cpu", "cuda"):
        assert get_program("angular_project_library").run_with_args(
            ["-i", str(tmp_path / "v.vol"), "-o", str(tmp_path / dev),
             "--sampling_rate", "15", "--device", dev]) == 0
    refs = np.squeeze(Image(str(tmp_path / "cpu.stk")).data)
    assert rel_err(np.squeeze(Image(str(tmp_path / "cuda.stk")).data),
                   refs) <= 1e-4
    rng = np.random.default_rng(9)
    idx = rng.integers(0, len(refs), B)
    imgs = apply_alignment_2d(
        refs[idx], rng.uniform(-180, 180, B).astype(np.float32),
        rng.uniform(-3, 3, B).astype(np.float32),
        rng.uniform(-3, 3, B).astype(np.float32), device="cpu").numpy()
    imgs += 0.1 * refs.std() * rng.standard_normal(imgs.shape).astype(
        np.float32)
    save_image(str(tmp_path / "p.mrcs"), imgs)
    MetaData.fromRows({"image": f"{i + 1}@{tmp_path}/p.mrcs"}
                      for i in range(B)).write(str(tmp_path / "p.xmd"))
    rows = {}
    for dev in ("cpu", "cuda"):
        before = cross.launches
        assert get_program("angular_projection_matching").run_with_args(
            ["-i", str(tmp_path / "p.xmd"), "-o", str(tmp_path / f"{dev}.xmd"),
             "--ref", str(tmp_path / "cpu"), "--max_shift", "4", "--batch",
             "32", "--device", dev]) == 0
        # 13 trial shifts x 2 batches on the card, none on the CPU
        assert cross.launches - before == (26 if dev == "cuda" else 0)
        md = MetaData(str(tmp_path / f"{dev}.xmd"))
        rows[dev] = [md.getRow(i) for i in md]
    col = lambda dev, k: np.array([float(r[k]) for r in rows[dev]])
    gal = MetaData(str(tmp_path / "cpu.doc"))
    d = directions_from_angles(np.array(
        [[gal.getRow(i)["angleRot"], gal.getRow(i)["angleTilt"]]
         for i in gal], float))
    ref_c, ref_g = (col(dev, "ref").astype(int) - 1 for dev in ("cpu", "cuda"))
    flips = col("cpu", "flip") != col("cuda", "flip")
    same = (ref_c == ref_g) & ~flips
    tie = ~same & flips & ((d[ref_c] * d[ref_g]).sum(-1) < -0.9999)
    assert (same | tie).mean() >= 0.98 and same.mean() >= 0.8
    dpsi = np.abs((col("cpu", "anglePsi") - col("cuda", "anglePsi") + 180)
                  % 360 - 180)
    assert dpsi[same].max() <= 0.5
    for k in ("shiftX", "shiftY"):
        assert np.abs(col("cpu", k) - col("cuda", k))[same].max() <= 0.05
