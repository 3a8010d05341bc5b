"""On a card only: each CUDA kernel of the port against its plain version,
and the whole reconstruction (plain and --useCTF), phase flipping, the
matching program, the 2-D path (the order-3 B-spline warp, alignment
and the Fourier filter), CTF estimation (the fitness, a whole staged
fit, the periodogram against numpy, and compass rounds that never wait
for the host) and the movie and MonoRes path (phantom frames, global and
local alignment with the warp, the float64 gain estimate, MonoRes and
FSO), 2-D classification (ML2D and CL2D), and ART, SIRT, WBP and the
significance weights on the card against the same on the CPU; K2 also at
the sample count of an ART block of 1,000 views; K4 at the shape of
multireference_aligneability, and the phantom, the real-space projector,
the continuous refinement and the aligneability scores on the card
against the same on the CPU, and the continuous refinement's step loop
without a host sync; K3 and K2 at the shapes of the two first splits, the
analysis ops (features, TV, FRM, helical map, filter bank, LTSA) on the
card against the CPU, the first splits' launches on the card, and the
Zernike3D and NMA warps, the splats and a batched forward fit on the card
against the CPU, and the binding's per-image CUDA graphs (projectVolume,
readApplyGeo, image_align) against the same calls on the CPU; and the
program's spans (core/timing.py) timing the card without a synchronise.

This file imports neither jax nor the reference package, so that it also
runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(`--noconftest` skips tests/conftest.py, which sets up jax for the other
test files). Without a card every test here skips.
"""
import numpy as np
import pytest
import torch

from test_torch_common import (K1_CASES, KB_EDGE_P, KB_SLABS, SCATTER_CASES,
                               TRI_EDGE_P, kb_edge_samples, kb_slab_samples,
                               phantom_batch, rel_err, require_cuda,
                               scatter_case, synthetic_psd, tensor_at_offset,
                               tri_edge_samples)
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
def test_spans_time_the_card_without_a_synchronise():
    """With timing on, the program's spans (core/timing.py) take the card's
    time from CUDA events on the stream: nothing inside a span synchronises
    (torch.cuda's sync debug mode raises on a synchronise), take_timing
    resolves the events, and a span that only queues a long product reads
    more device than host time. A span inside a CUDA graph's capture
    records no events."""
    require_cuda()
    from xmipp3_tpu_torch.core import timing
    n = 4096
    a = torch.randn(n, n, device="cuda")
    (a @ a).sum().item()
    timing.take_timing()
    timing.enable_timing(True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            with timing.timed_phase("mm"):
                with timing.timed_phase("mm.inner"):
                    a @ a
                timing.count("mm.flop", 2 * n ** 3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        timing.enable_timing(False)
    took = timing.take_timing()
    assert took["device:mm"][1] == took["device:mm.inner"][1] == 3
    assert took["device:mm"][0] >= took["device:mm.inner"][0] > 0
    assert took["device:mm"][0] > took["mm"][0]
    assert took["count:mm.flop"] == (3 * 2 * n ** 3, 3)
    # a span inside a CUDA graph's capture records no events; the replay
    # gives the product
    b = a[:64, :64].clone()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        b @ b
    torch.cuda.current_stream().wait_stream(side)
    timing.enable_timing(True)
    try:
        with torch.cuda.graph(graph):
            with timing.timed_phase("captured"):
                out = b @ b
    finally:
        timing.enable_timing(False)
    graph.replay()
    took = timing.take_timing()
    assert took["captured"][1] == 1 and "device:captured" not in took
    assert torch.allclose(out, b @ b)


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


def _ctf_descs(count):
    from xmipp3_tpu_torch.ops.ctf import CTFDescription
    return [CTFDescription(sampling_rate=2.0, voltage=300, Cs=2.7, Q0=0.1,
                           defocusU=8000 + 12000 * k / count,
                           defocusV=8300 + 12000 * k / count,
                           azimuthal_angle=180.0 * k / count)
            for k in range(count)]


@pytest.mark.cuda
@pytest.mark.parametrize("interp,counter", [
    ("kb", (scatter_kb, "launches")), ("tri+kb", (scatter_tri, "launches")),
    ("nn", (scatter, "launches"))])
def test_usectf_reconstruct_on_the_card_matches_the_cpu(interp, counter):
    """--useCTF: the CTF table and the CTF-weighted streams through the
    kernel on the card against the same on the CPU (minCTF 0.1: 1/c
    amplifies the card's and the host's sin roundoff by up to 1/minCTF^2),
    phase flipped or not."""
    require_cuda()
    from xmipp3_tpu_torch.ops.ctf import ctf_params_arrays
    b = phantom_batch(33, 32, 32)
    args = (b["imgs"], b["rot"], b["tilt"], b["psi"])
    for flipped in (False, True):
        kw = dict(sx=b["sx"], sy=b["sy"], weights=b["w"], flip=b["flip"],
                  interp=interp, batch=16,
                  ctfp=ctf_params_arrays(_ctf_descs(32)), sampling=2.0,
                  min_ctf=0.1, phase_flipped=flipped)
        mod, name = counter
        setattr(mod, name, 0)
        got = trec.reconstruct_fourier(*args, **kw, device="cuda")
        assert getattr(mod, name) == 2
        want = trec.reconstruct_fourier(*args, **kw, device="cpu")
        assert got.is_cuda and got.shape == (32, 32, 32)
        assert rel_err(got, want) <= 1e-4


@pytest.mark.cuda
def test_phase_flip_on_the_card_matches_the_cpu():
    """Per-row CTFs in one pass and the flip on the card against the CPU:
    the sign tables equal wherever |c| > 1e-5, the images to 1e-4 * max
    (a sample at a zero crossing may take the other sign)."""
    require_cuda()
    from xmipp3_tpu_torch.ops.ctf import generate_2d_rows, phase_flip
    ctfs = _ctf_descs(16)
    imgs = np.random.default_rng(7).standard_normal((16, 64, 64)).astype(
        np.float32)
    c_gpu = generate_2d_rows(ctfs, 64, 64, damped=False, device="cuda")
    c_cpu = generate_2d_rows(ctfs, 64, 64, damped=False, device="cpu")
    away = c_cpu.abs() > 1e-5
    assert torch.equal(torch.sign(c_gpu.cpu())[away], torch.sign(c_cpu)[away])
    got = phase_flip(imgs, ctfs, device="cuda")
    want = phase_flip(imgs, ctfs, device="cpu")
    assert got.is_cuda
    assert rel_err(got, want) <= 1e-4


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
@pytest.mark.parametrize("shape", [(1, 31, 1, 64), (1, 31, 1652, 64),
                                   (70, 31, 1652, 33), (33, 9, 100, 64)])
@pytest.mark.parametrize("mirror", [False, True])
def test_cross_spectrum_kernel_at_ragged_tiles(shape, mirror):
    """K4 where B, R and nr are no multiples of its 32 x 32 tile and 8-ring
    stages (one image, one reference, the gallery's 1652 references, 9
    rings), at k = 64 and at an odd k = 33 (8-byte copies, a ragged last
    4-harmonic tile); <= 1e-5 * max."""
    require_cuda()
    fi, fr, w = _ring_spectra(*shape, seed=6)
    before = cross.launches
    got = cross.cross_spectrum(fi, fr, w, mirror=mirror)
    torch.cuda.synchronize()
    assert cross.launches == before + 1
    want = cross.cross_spectrum_plain(fi, fr, w, mirror=mirror)
    for g, p in zip(got if mirror else [got], want if mirror else [want]):
        assert g.shape == (shape[0], shape[2], shape[3])
        assert rel_err(g, p) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1024, 37])
def test_cross_spectrum_kernel_at_ml2d_shapes(B):
    """K4 at ML2D's E-step shape: 61 rings and k = 257 harmonics (the
    default polar grid's 512 angles at N=128; an odd k, so the kernel's
    8-byte staging), R = 32 (16 references and their mirrors), no mirror
    output; a whole 1024-image chunk and a ragged one; <= 1e-5 * max."""
    require_cuda()
    fi, fr, w = _ring_spectra(B, 61, 32, 257, seed=9)
    before = cross.launches
    got = cross.cross_spectrum(fi, fr, w)
    torch.cuda.synchronize()
    assert cross.launches == before + 1
    assert got.shape == (B, 32, 257)
    assert rel_err(got, cross.cross_spectrum_plain(fi, fr, w)) <= 1e-5


@pytest.mark.cuda
def test_ml2d_and_cl2d_on_the_card_match_the_cpu():
    """ML2D (with --mirror) and CL2D on the card against the same on the
    CPU at N=32: K4 launched on the card, the same classes, references
    <= 1e-3 * max and log-likelihoods <= 1e-4 relative."""
    require_cuda()
    from xmipp3_tpu_torch.models.cl2d import classify_cl2d
    from xmipp3_tpu_torch.models.ml2d import ml2d
    rng = np.random.default_rng(3)
    n = 32
    y, x = np.mgrid[0:n, 0:n].astype(np.float32) - n // 2
    protos = [np.exp(-(x ** 2 + y ** 2) / 30),
              np.exp(-((x - 6) ** 2 + y ** 2) / 18)
              + np.exp(-((x + 6) ** 2 + y ** 2) / 18),
              np.exp(-(x ** 2 / 60 + y ** 2 / 8))]
    labels = rng.integers(0, 3, 40)
    imgs = (np.stack([protos[c] for c in labels])
            + 0.15 * rng.standard_normal((40, n, n))).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        before = cross.launches
        m = ml2d(imgs, 3, n_iters=3, max_shift=2, mirror=True, device=dev)
        c = classify_cl2d(imgs, 3, n_iters=3, max_shift=2, nref0=2,
                          device=dev)
        out[dev] = (m, c, cross.launches - before)
    (mc, cc, k_cpu), (mg, cg, k_gpu) = out["cpu"], out["cuda"]
    assert k_cpu == 0 and k_gpu > 0
    assert np.array_equal(mg["assignments"], mc["assignments"])
    assert rel_err(mg["refs"], mc["refs"]) <= 1e-3
    assert np.allclose(mg["loglike"], mc["loglike"], rtol=1e-4)
    assert np.array_equal(cg["assignments"], cc["assignments"])
    assert rel_err(cg["refs"], cc["refs"]) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["f_imgs", "f_refs", "both"])
def test_cross_spectrum_kernel_takes_operands_off_16_bytes(which):
    """A complex64 operand that starts 8 bytes past a 16-byte boundary
    goes through the kernel's 8-byte copies: launched, and equal to the
    plain version; <= 1e-5 * max."""
    require_cuda()
    fi, fr, w = _ring_spectra(40, 31, 70, 64, seed=8)
    moved = lambda a: tensor_at_offset(a.cpu().numpy(), 1, "cuda")
    if which in ("f_imgs", "both"):
        fi = moved(fi)
    if which in ("f_refs", "both"):
        fr = moved(fr)
    assert (fi.data_ptr() % 16 != 0) or (fr.data_ptr() % 16 != 0)
    before = cross.launches
    got = cross.cross_spectrum(fi, fr, w, mirror=True)
    torch.cuda.synchronize()
    assert cross.launches == before + 1
    for g, p in zip(got, cross.cross_spectrum_plain(fi, fr, w, mirror=True)):
        assert rel_err(g, p) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_kb_kernel_rows_at_every_alignment_and_edge(offset):
    """K3 on samples at every floor x (rows starting at every residue mod 4,
    rows straddling x = 0 and x = P - 1, floors at P - 1) and with floors
    outside the cube (dropped), into cubes that start 0-3 floats past an
    allocation: both float4 quads, the single quad and the tap-by-tap
    fallback at the row ends; <= 1e-4 * max."""
    require_cuda()
    samples = [torch.as_tensor(a, device="cuda") for a in kb_edge_samples()]
    base = np.random.default_rng(offset).standard_normal(
        (3, KB_EDGE_P ** 3)).astype(np.float32)
    at = lambda a: tensor_at_offset(a, offset, "cuda")
    before = scatter_kb.launches
    got = scatter_kb.kb_scatter_3ch(*map(at, base), *samples, P=KB_EDGE_P,
                                    **KB)
    want = scatter_kb.kb_scatter_plain(*map(at, base), *samples,
                                       P=KB_EDGE_P, **KB)
    torch.cuda.synchronize()
    assert scatter_kb.launches == before + 1
    for g, w in zip(got, want):
        assert rel_err(g, w) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("z_lo,zdim", KB_SLABS)
def test_kb_kernel_slab_mode_at_the_slab_faces(z_lo, zdim, offset):
    """K3 in kz-slab mode against its plain version: floors at z_lo - 1 and
    z_lo + zdim - 1 (and one plane further out on each side), rows at every
    alignment, samples outside the cube dropped whole, into slabs that
    start 0-3 floats past an allocation; <= 1e-4 * max."""
    require_cuda()
    samples = [torch.as_tensor(a, device="cuda")
               for a in kb_slab_samples(z_lo, zdim)]
    base = np.random.default_rng(offset).standard_normal(
        (3, zdim * KB_EDGE_P ** 2)).astype(np.float32)
    at = lambda a: tensor_at_offset(a, offset, "cuda")
    slab = dict(P=KB_EDGE_P, zdim=zdim, z_lo=z_lo, **KB)
    before = scatter_kb.slab_launches, scatter_kb.launches
    got = scatter_kb.kb_scatter_3ch(*map(at, base), *samples, **slab)
    want = scatter_kb.kb_scatter_plain(*map(at, base), *samples, **slab)
    torch.cuda.synchronize()
    assert (scatter_kb.slab_launches, scatter_kb.launches) == (
        before[0] + 1, before[1])
    for g, w, b in zip(got, want, base):
        assert (w.cpu().numpy() != b).any()   # the slab was written
        assert rel_err(g, w) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_kb_kernel_slabs_of_one_tensor_stack_to_the_full_cube(offset):
    """The slabs [0, 5), [5, 11) and [11, 16) as views of one (3, P^3)
    allocation that starts `offset` floats in, each gridded by K3 in slab
    mode: together they equal K3 on the full cube and the plain version,
    to 1e-4 * max."""
    require_cuda()
    P = KB_EDGE_P
    samples = [torch.as_tensor(a, device="cuda")
               for a in kb_slab_samples(5, 6)]
    big = torch.zeros(3 * P ** 3 + offset, device="cuda")
    cube = big[offset:].view(3, P ** 3)
    for lo, hi in ((0, 5), (5, 11), (11, 16)):
        views = [cube[k, lo * P * P:hi * P * P] for k in range(3)]
        scatter_kb.kb_scatter_3ch(*views, *samples, P=P, zdim=hi - lo,
                                  z_lo=lo, **KB)
    full = [torch.zeros(P ** 3, device="cuda") for _ in range(3)]
    scatter_kb.kb_scatter_3ch(*full, *samples, P=P, **KB)
    plain = [torch.zeros(P ** 3, device="cuda") for _ in range(3)]
    scatter_kb.kb_scatter_plain(*plain, *samples, P=P, **KB)
    torch.cuda.synchronize()
    for k in range(3):
        assert rel_err(cube[k], full[k]) <= 1e-4
        assert rel_err(cube[k], plain[k]) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_tri_kernel_rows_at_every_alignment_and_edge(offset):
    """K2 on samples whose floors take every residue of x mod 4 and lie at
    -1 and P - 1 on each axis, with fractions of exactly 0 and samples with
    no corner inside, into cubes that start 0-3 floats past an allocation:
    a row's pair in one float4 quad at every lane, straddling two quads,
    and tap by tap at the row ends; <= 1e-4 * max."""
    require_cuda()
    samples = [torch.as_tensor(a, device="cuda") for a in tri_edge_samples()]
    base = np.random.default_rng(offset).standard_normal(
        (3, TRI_EDGE_P ** 3)).astype(np.float32)
    at = lambda a: tensor_at_offset(a, offset, "cuda")
    before = scatter_tri.launches
    got = scatter_tri.tri_scatter(*map(at, base), *samples, P=TRI_EDGE_P)
    want = scatter_tri.tri_scatter_plain(*map(at, base), *samples,
                                         P=TRI_EDGE_P)
    torch.cuda.synchronize()
    assert scatter_tri.launches == before + 1
    for g, w in zip(got, want):
        assert rel_err(g, w) <= 1e-4


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


def _blob_volume(N):
    """A volume of five Gaussian blobs whose views differ enough for
    projection matching to tell them apart."""
    z, y, x = np.mgrid[0:N, 0:N, 0:N].astype(np.float32) - N // 2
    vol = sum(a * np.exp(-((z - cz) ** 2 + (y - cy) ** 2 + (x - cx) ** 2)
                         / (2 * s ** 2))
              for cz, cy, cx, s, a in [(0, 0, 0, 3.0, 1.0), (4, -3, 3, 2.0, .8),
                                       (-3, 3, -2, 2.5, .6), (2, 4, -4, 1.8, .9),
                                       (-5, -5, 1, 1.5, 1.1)])
    return vol.astype(np.float32)


def _gallery_directions(doc):
    from xmipp3_tpu_torch.core.metadata import MetaData
    from xmipp3_tpu_torch.core.sampling import directions_from_angles
    gal = MetaData(str(doc))
    return directions_from_angles(np.array(
        [[gal.getRow(i)["angleRot"], gal.getRow(i)["angleTilt"]]
         for i in gal], float))


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
    save_image(str(tmp_path / "v.vol"), _blob_volume(N))
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


@pytest.mark.cuda
def test_mesh_paths_on_the_cards(tmp_path):
    """The mesh reconstructors and matchers on 4 ranks, each a process of
    its own on cuda:{rank % cards}: NCCL when each rank has a card of its
    own, gloo otherwise. Every volume within 1e-4 * max of the serial one
    on the card; the matchers give the serial winners (the same reference
    and flip, the exact antipodal-mirror tie counted as the same direction)
    for >= 98 % of the particles; every rank launched the path's kernel."""
    require_cuda()
    from test_torch_common import Ranks
    from xmipp3_tpu_torch.core.image import Image, save_image
    from xmipp3_tpu_torch.ops.geo import apply_alignment_2d
    from xmipp3_tpu_torch.ops.match import match_to_gallery
    from xmipp3_tpu_torch.programs import get_program
    n, N, B = 4, 32, 23
    b = phantom_batch(21, 15, N)
    f = b["flip"]
    b["imgs_f"] = np.where(f[:, None, None], b["imgs"][:, :, ::-1], b["imgs"])
    b["sx_f"] = np.where(f, -b["sx"], b["sx"]).astype(np.float32)
    save_image(str(tmp_path / "v.vol"), _blob_volume(N))
    assert get_program("angular_project_library").run_with_args(
        ["-i", str(tmp_path / "v.vol"), "-o", str(tmp_path / "g"),
         "--sampling_rate", "15", "--device", "cuda", "-v", "0"]) == 0
    refs = np.squeeze(Image(str(tmp_path / "g.stk")).data)
    rng = np.random.default_rng(9)
    mimgs = apply_alignment_2d(
        refs[rng.integers(0, len(refs), B)],
        rng.uniform(-180, 180, B).astype(np.float32),
        rng.uniform(-3, 3, B).astype(np.float32),
        rng.uniform(-3, 3, B).astype(np.float32), device="cpu").numpy()
    mimgs += 0.1 * refs.std() * rng.standard_normal(mimgs.shape).astype(
        np.float32)
    rec = dict(args=["imgs", "rot", "tilt", "psi", "sx", "sy"],
               arrays={"weights": "w", "flip": "flip"},
               kwargs={"interp": "kb", "batch": 4})
    slab = dict(rec, args=["imgs_f", "rot", "tilt", "psi", "sx_f", "sy"],
                arrays={"weights": "w"})
    match = dict(args=["refs", "mimgs"], kwargs={"max_shift": 4})
    jobs = [dict(rec, name="dp", fn="parallel_reconstruct", mesh="data"),
            dict(slab, name="slab", fn="slab_reconstruct", mesh="data"),
            dict(slab, name="slab2d", fn="slab_reconstruct_2d",
                 mesh="slab2d"),
            dict(match, name="match_dp", fn="parallel_match_full",
                 mesh="data"),
            dict(match, name="match_tp", fn="parallel_match_tp",
                 mesh="model")]
    inputs = {k: b[k] for k in ("imgs", "rot", "tilt", "psi", "sx", "sy", "w",
                                "flip", "imgs_f", "sx_f")}
    ranks = Ranks(n, jobs, tmp_path, dict(inputs, refs=refs, mimgs=mimgs),
                  device="cuda")
    want = trec.reconstruct_fourier(
        b["imgs"], b["rot"], b["tilt"], b["psi"], b["sx"], b["sy"], b["w"],
        flip=b["flip"], interp="kb", batch=4, device="cuda")
    serial = {k: v.cpu().numpy() for k, v in match_to_gallery(
        refs, mimgs, max_shift=4, device="cuda").items()}
    reports = ranks.join()
    backend = "nccl" if torch.cuda.device_count() >= n else "gloo"
    kernel = {"dp": "scatter_kb.launches", "slab": "scatter_kb.slab_launches",
              "slab2d": "scatter_kb.slab_launches",
              "match_dp": "cross.launches", "match_tp": "cross.launches"}
    for rep in reports:
        for name, got in rep["jobs"].items():
            assert "raised" not in got, (rep["rank"], name, got)
            assert got["backend"] == backend
            assert got["launches"][kernel[name]] > 0, (rep["rank"], name)
    out = lambda name: dict(np.load(tmp_path / f"out_{name}_r0.npz"))
    for name in ("dp", "slab", "slab2d"):
        assert rel_err(out(name)["vol"], want) <= 1e-4, name
    d = _gallery_directions(tmp_path / "g.doc")
    for name in ("match_dp", "match_tp"):
        got = out(name)
        flips = got["flip"] != serial["flip"]
        same = (got["ref_idx"] == serial["ref_idx"]) & ~flips
        tie = ~same & flips & (
            (d[got["ref_idx"]] * d[serial["ref_idx"]]).sum(-1) < -0.9999)
        assert (same | tie).mean() >= 0.98, name


# ---------------------------------------------------------------------------
# the 2-D path (no kernel of its own): the card against the CPU
# ---------------------------------------------------------------------------

def _blob_views(B=32, N=64, seed=7):
    """Views of an asymmetric blob image at random psi (away from the
    45 + k*90 ties), shifts and mirrors, with noise; and the image."""
    from xmipp3_tpu_torch.ops.geo import alignment_matrices_2d, apply_affine_2d
    y, x = np.mgrid[0:N, 0:N].astype(np.float32) - N // 2
    ref = sum(a * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * s * s))
              for cy, cx, s, a in [(0, 0, 5, 1.0), (8, -7, 3, 0.8),
                                   (-9, 4, 4, 0.6), (5, 11, 2.5, 0.9),
                                   (-4, -12, 2.5, 1.1)]).astype(np.float32)
    rng = np.random.default_rng(seed)
    psi = rng.uniform(-180, 180, 4 * B)
    psi = psi[np.abs(np.abs((psi - 45) % 90 - 45) - 45) > 5][:B]
    A = alignment_matrices_2d(psi.astype(np.float32),
                              *rng.uniform(-4, 4, (2, B)).astype(np.float32),
                              flip=rng.uniform(size=B) < 0.5, device="cpu")
    imgs = apply_affine_2d(np.broadcast_to(ref, (B, N, N)), A, order=3,
                           device="cpu").numpy()
    return imgs + 0.05 * rng.standard_normal(imgs.shape).astype(
        np.float32), ref


@pytest.mark.cuda
@pytest.mark.parametrize("wrap", [False, True])
def test_order3_affine_on_the_card_matches_the_cpu(wrap):
    require_cuda()
    from xmipp3_tpu_torch.ops.geo import alignment_matrices_2d, apply_affine_2d
    imgs, _ = _blob_views()
    rng = np.random.default_rng(8)
    A = alignment_matrices_2d(rng.uniform(-180, 180, 32).astype(np.float32),
                              *rng.uniform(-3, 3, (2, 32)).astype(np.float32),
                              device="cpu")
    want = apply_affine_2d(imgs, A, order=3, wrap=wrap, device="cpu")
    got = apply_affine_2d(imgs, A, order=3, wrap=wrap, device="cuda")
    assert got.is_cuda
    assert rel_err(got, want) <= 1e-5


@pytest.mark.cuda
def test_iterative_align_on_the_card_matches_the_cpu():
    require_cuda()
    from xmipp3_tpu_torch.ops.align import align_considering_mirrors
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    imgs, ref = _blob_views()
    want = align_considering_mirrors(ref, imgs, n_iters=3, max_shift=6,
                                     device="cpu")
    got = align_considering_mirrors(ref, imgs, n_iters=3, max_shift=6,
                                    device="cuda")
    assert got[0].is_cuda
    psi_g, psi_w = got[0].cpu().numpy(), want[0].numpy()
    assert np.abs((psi_g - psi_w + 180) % 360 - 180).max() <= 0.1
    for g, w in zip(got[1:3], want[1:3]):
        assert np.abs(g.cpu().numpy() - w.numpy()).max() <= 0.02
    np.testing.assert_array_equal(got[3].cpu().numpy(), want[3].numpy())
    assert np.abs(got[4].cpu().numpy() - want[4].numpy()).max() <= 1e-4


@pytest.mark.cuda
def test_fourier_mask_on_the_card_matches_the_cpu():
    require_cuda()
    from xmipp3_tpu_torch.ops.fourier_filter import (apply_fourier_mask_2d,
                                                     low_pass_mask)
    imgs, _ = _blob_views()
    mask = low_pass_mask(64, 64, 0.25)
    got = apply_fourier_mask_2d(imgs, mask, device="cuda")
    assert got.is_cuda
    assert rel_err(got, apply_fourier_mask_2d(imgs, mask,
                                              device="cpu")) <= 1e-5


def _ctf_point():
    """A realistic CTF parameter vector and 64 candidates around it."""
    from xmipp3_tpu_torch.models import ctf_estimation as ce
    p = np.zeros(ce.NPARAMS, np.float32)
    p[[ce.DEFU, ce.DEFV, ce.ANGLE, ce.LOGK]] = [17500, 14500, 40, 0.1]
    p[[ce.ESPR, ce.ALPHA, ce.DELTAF, ce.DELTAR]] = [1.0, 2e-4, 30.0, 2.0]
    p[ce.BASE:ce.SQANG + 1] = [0.1, 3.0, 12.0, 14.0, 20.0]
    p[ce.G1K:ce.G1CV + 1] = [1.5, 8000, 9000, 10, 0.02, 0.022]
    rng = np.random.default_rng(9)
    return p, (p[None] * (1 + 0.02 * rng.standard_normal(
        (64, ce.NPARAMS)))).astype(np.float32)


@pytest.mark.cuda
def test_ctf_fitness_on_the_card_matches_the_cpu():
    require_cuda()
    from xmipp3_tpu_torch.models import ctf_estimation as ce
    psd, _ = synthetic_psd(192, 1.5)
    _, P = _ctf_point()
    out = {}
    for dev in ("cpu", "cuda"):
        est = ce.CTFEstimator(psd, 1.5, device=dev)
        out[dev] = [est._cost_batch(P, use_enh=e) for e in (False, True)]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert np.abs(got - want).max() <= 1e-5


@pytest.mark.cuda
def test_ctf_estimate_on_the_card_matches_the_cpu():
    require_cuda()
    from xmipp3_tpu_torch.models import ctf_estimation as ce
    psd, true = synthetic_psd(192, 1.5)
    got = ce.CTFEstimator(psd, 1.5, device="cuda").estimate()
    want = ce.CTFEstimator(psd, 1.5, device="cpu").estimate()
    for attr in ("defocusU", "defocusV"):
        assert abs(getattr(got, attr) - getattr(want, attr)) <= \
            5e-3 * getattr(want, attr)
        assert abs(getattr(got, attr) - getattr(true, attr)) <= \
            0.02 * getattr(true, attr)


@pytest.mark.cuda
def test_ctf_compass_rounds_never_sync_on_the_card():
    """torch.cuda's sync debug mode raises on any call that waits for the
    card inside the compass rounds."""
    require_cuda()
    from xmipp3_tpu_torch.models import ctf_estimation as ce
    psd, _ = synthetic_psd(192, 1.5)
    est = ce.CTFEstimator(psd, 1.5, device="cuda")
    data = est._data(use_enh=True)
    _, P = _ctf_point()
    p = torch.as_tensor(P[:8], device="cuda")
    free = tuple(ce.STAGE_SETS["all"])
    steps = torch.as_tensor(ce.CTFEstimator._STEPS[list(free)],
                            device="cuda").expand(8, len(free)).clone()
    E, plan = ce._directions(free, "cuda"), ce._plan(free, "cuda")
    best = data.costs(p[:, None])[:, 0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        p, best = ce._compass_rounds(p, steps, best, E, data.costs, plan,
                                     ((ce.SQV, ce.SQU),), 12)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert p.is_cuda and torch.isfinite(best).all()


@pytest.mark.cuda
def test_periodogram_on_the_card_matches_numpy():
    require_cuda()
    from xmipp3_tpu_torch.ops import psd as tpsd
    mic = np.random.default_rng(10).standard_normal((700, 650)) \
        .astype(np.float32)
    got = tpsd.estimate_psd(mic, 256, 0.5, device="cuda")
    assert got.is_cuda
    tiles = tpsd.extract_tiles(mic, 256, 0.5).astype(np.float64)
    tiles -= tiles.mean(axis=(-2, -1), keepdims=True)
    tiles *= tpsd.tile_window(256).astype(np.float64)
    want = (np.abs(np.fft.rfft2(tiles)) ** 2 / 256 ** 2).mean(0)
    assert rel_err(got, want) <= 1e-4


def _drift_movie(F=6, n=256, seed=12):
    """A band-limited random scene drifting 1.3 px right and 0.7 px up a
    frame, plus noise (numpy)."""
    rng = np.random.default_rng(seed)
    f = np.sqrt(np.fft.fftfreq(n)[:, None] ** 2
                + np.fft.rfftfreq(n)[None, :] ** 2)
    spec = np.fft.rfft2(rng.standard_normal((n, n))) * (f <= 0.2)
    ky = np.fft.fftfreq(n)[:, None]
    kx = np.fft.rfftfreq(n)[None, :]
    frames = [np.fft.irfft2(spec * np.exp(-2j * np.pi * (kx * 1.3 * t
                                                         - ky * 0.7 * t)),
                            s=(n, n)) * 10
              + 0.5 * rng.standard_normal((n, n)) for t in range(F)]
    return np.stack(frames).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("avg", [1, 3])
def test_movie_alignment_on_the_card_matches_the_cpu(avg):
    require_cuda()
    from xmipp3_tpu_torch.ops import movie as tm
    torch.backends.cuda.matmul.allow_tf32 = False
    frames = _drift_movie()
    out = {}
    for dev in ("cpu", "cuda"):
        pos = tm.global_align(frames, 10, device=dev)
        out[dev] = (pos, *tm.local_align(frames, pos, patches=(3, 3),
                                         patch_size=96, max_shift_px=4,
                                         patches_avg=avg, device=dev))
    assert np.abs(out["cuda"][0] - out["cpu"][0]).max() <= 0.02
    assert np.abs(out["cuda"][1] - out["cpu"][1]).max() <= 0.02
    # the warp on one field (0.02 px of field moves a sharp scene's sum by
    # more than 1e-4 of its max), away from the frame's border: there one
    # tile covers a pixel and its window's 1e-3 floor divides the FFTs'
    # roundoff back out (7.5e-4 of the max on the H100)
    pos, field, cys, cxs = out["cpu"]
    warp = {dev: tm.warp_sum_frames_tiled(frames, field + pos[None, None],
                                          cys, cxs, tile=64, device=dev)
            for dev in ("cpu", "cuda")}
    assert warp["cuda"].is_cuda
    inner = (slice(32, -32), slice(32, -32))
    assert rel_err(warp["cuda"][inner], warp["cpu"][inner]) <= 1e-4


@pytest.mark.cuda
def test_gain_estimate_on_the_card_matches_the_cpu():
    require_cuda()
    from xmipp3_tpu_torch.ops import movie as tm
    rng = np.random.default_rng(6)
    g = (1 + 0.1 * rng.standard_normal(96))[None, :] * \
        (1 + 0.05 * rng.standard_normal(80))[:, None]
    frames = rng.poisson(30.0 * g, (4, 80, 96)).astype(np.float32)
    got = tm.estimate_gain_histogram(frames, n_iter=2, device="cuda")
    want = tm.estimate_gain_histogram(frames, n_iter=2, device="cpu")
    assert rel_err(got, want) <= 1e-6


@pytest.mark.cuda
def test_phantom_movie_on_the_card_matches_the_cpu(tmp_path):
    require_cuda()
    from xmipp3_tpu_torch.core.image import Image
    from xmipp3_tpu_torch.programs import get_program
    for dev in ("cpu", "cuda"):
        assert get_program("phantom_movie").run_with_args(
            ["-o", str(tmp_path / f"{dev}.mrcs"), "-size", "192", "160", "5",
             "--skipDose", "--seed", "3", "--device", dev, "-v", "0"]) == 0
    got, want = (Image.read_stack(str(tmp_path / f"{d}.mrcs"))
                 for d in ("cuda", "cpu"))
    assert rel_err(got, want) <= 1e-5


def _zone_halves(n=48, seed=4):
    """Two half maps of a white signal low-passed to 0.3 inside a sphere
    of radius n/3 and to 0.15 outside it, with independent noise."""
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[:n, :n, :n] - n // 2
    inner = z * z + y * y + x * x < (n / 3) ** 2
    f = np.sqrt(np.fft.fftfreq(n)[:, None, None] ** 2
                + np.fft.fftfreq(n)[None, :, None] ** 2
                + np.fft.rfftfreq(n)[None, None, :] ** 2)
    spec = np.fft.rfftn(rng.standard_normal((n, n, n)))
    lo = lambda c: np.fft.irfftn(spec * (f <= c), s=(n, n, n),
                                 axes=(0, 1, 2))
    signal = np.where(inner, lo(0.3), lo(0.15))
    return [(signal + 0.3 * rng.standard_normal(signal.shape)).astype(
        np.float32) for _ in range(2)], inner


@pytest.mark.cuda
def test_monores_and_fso_on_the_card_match_the_cpu():
    require_cuda()
    from xmipp3_tpu_torch.ops import monogenic as tmono
    (h1, h2), inner = _zone_halves()
    out = {}
    for dev in ("cpu", "cuda"):
        res, freqs, frac = tmono.local_resolution_monores(
            0.5 * (h1 + h2), inner, 1.0, noise_vol=0.5 * (h1 - h2),
            device=dev)
        out[dev] = (res.cpu().numpy(), frac,
                    tmono.fso_directional(h1, h2, 1.0, device=dev)[1])
    got, want = out["cuda"], out["cpu"]
    same = np.isclose(got[0][inner], want[0][inner], rtol=1e-6)
    assert same.mean() >= 0.999
    assert np.abs(got[1] - want[1]).max() <= 1e-3
    np.testing.assert_array_equal(got[2], want[2])



@pytest.mark.cuda
def test_tri_kernel_at_an_art_block_matches_plain():
    """K2 at the sample count of one pSART block of 1,000 views at N=128,
    P=256 (reconstruct_art --block_size 1000 grids each block's residuals
    in one call), against its plain version."""
    require_cuda()
    b = phantom_batch(3, 1000, 128)
    mats = torch.as_tensor(euler_matrix(b["rot"], b["tilt"], b["psi"]),
                           device="cuda")
    coords = [a.reshape(-1).contiguous()
              for a in trec._slice_tap_coords(mats, 128, 256, 0.5)]
    rng = np.random.default_rng(3)
    vals = [torch.as_tensor(rng.standard_normal(coords[0].numel()).astype(
        np.float32), device="cuda") for _ in range(3)]
    assert coords[0].numel() > 6_000_000
    _, run, plain = _kernel_and_plain("tri_scatter", coords, vals, 256)
    ck = [torch.zeros(256 ** 3, device="cuda") for _ in range(3)]
    cp = [torch.zeros(256 ** 3, device="cuda") for _ in range(3)]
    before = scatter_tri.launches
    run(ck)
    plain(cp)
    torch.cuda.synchronize()
    assert scatter_tri.launches == before + 1
    for a, c in zip(ck, cp):
        assert rel_err(a, c) <= 1e-4


@pytest.mark.cuda
def test_art_wbp_and_significance_on_the_card_match_the_cpu():
    """pSART (K2 a block), SIRT and the arbitrary-geometry WBP (K3) on the
    card against the same on the CPU (1e-4 of the max), and the
    significance weights of a score matrix with ties, equal."""
    require_cuda()
    from xmipp3_tpu_torch.core.sampling import (compute_sampling_points,
                                                directions_from_angles)
    from xmipp3_tpu_torch.ops import art as tart
    from xmipp3_tpu_torch.programs.align_significant import \
        significance_weights
    b = phantom_batch(9, 40, 32)
    args = (b["imgs"], b["rot"], b["tilt"], b["psi"])
    out = {}
    for dev in ("cpu", "cuda"):
        k2, k3 = scatter_tri.launches, scatter_kb.launches
        art, _ = tart.art_reconstruct(*args, mode="pSART", block_size=10,
                                      n_iters=2, positivity=True, device=dev)
        sirt, _ = tart.sirt_reconstruct(*args, n_iters=2, device=dev)
        wbp = tart.wbp_reconstruct(*args, mode="arbitrary", device=dev)
        out[dev] = [v.cpu().numpy() for v in (art, sirt, wbp)]
        if dev == "cuda":
            assert scatter_tri.launches - k2 == 8      # 4 blocks x 2
            assert scatter_kb.launches - k3 == 4       # SIRT 3, WBP 1
    for got, want in zip(out["cuda"], out["cpu"]):
        assert rel_err(got, want) <= 1e-4
    dirs = directions_from_angles(compute_sampling_points(15.0))
    cc = (np.random.default_rng(1).integers(-1, 6, (50, len(dirs))) / 6
          ).astype(np.float32)
    np.testing.assert_array_equal(
        significance_weights(cc, dirs, 20.0, device="cuda").cpu().numpy(),
        significance_weights(cc, dirs, 20.0, device="cpu").numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [512, 19])
def test_cross_spectrum_kernel_at_the_aligneability_shape(B):
    """K4 at multireference_aligneability's shape: a chunk of images (a
    whole 512-image chunk and a ragged one) against the 5-degree --sampling
    gallery (R = 1652), 61 rings and k = 257 harmonics at N=128, no
    mirror; <= 1e-5 * max."""
    require_cuda()
    fi, fr, w = _ring_spectra(B, 61, 1652, 257, seed=12)
    before = cross.launches
    got = cross.cross_spectrum(fi, fr, w)
    torch.cuda.synchronize()
    assert cross.launches == before + 1
    assert got.shape == (B, 1652, 257)
    assert rel_err(got, cross.cross_spectrum_plain(fi, fr, w)) <= 1e-5


@pytest.mark.cuda
def test_angular_slice_on_the_card_matches_the_cpu():
    """The phantom's voxelization, the real-space projector, the
    continuous refinement (autograd through the projector, 6 Adam steps)
    and the aligneability scores (K4 on the card) against the same on the
    CPU at N=32: the volume equal, projections 1e-5, refined angles 1e-2
    degrees and shifts 1e-3 px, scores 1e-4."""
    require_cuda()
    from xmipp3_tpu_torch.ops.continuous import continuous_assign_full
    from xmipp3_tpu_torch.ops.phantom import Feature, Phantom
    from xmipp3_tpu_torch.ops.project import (FourierProjector,
                                              project_real_space)
    from xmipp3_tpu_torch.programs.angular_misc import gallery_correlations
    ph = Phantom((32, 32, 32), 0.0, 1.0, [
        Feature("sph", "+", 1.0, np.array([3.0, -2.0, 1.0]), [5.0]),
        Feature("ell", "+", 0.5, np.array([-4.0, 3.0, 0.0]),
                [6.0, 3.0, 4.0, 30.0, 40.0, 10.0])])
    b = phantom_batch(4, 24, 32)
    out, k4 = {}, {}
    for dev in ("cpu", "cuda"):
        vol = ph.voxelize(dev)
        proj = project_real_space(vol, b["rot"], b["tilt"], b["psi"])
        res = continuous_assign_full(
            vol, proj, b["rot"] + 2, b["tilt"] - 2, b["psi"] + 3, n_steps=6,
            optimize_gray=True, device=dev)
        refs = FourierProjector(vol.cpu().numpy(), device=dev).project_euler(
            b["rot"][:12], b["tilt"][:12], b["psi"][:12])
        before = cross.launches
        cc = gallery_correlations(refs, proj.cpu().numpy(), chunk=10)
        k4[dev] = cross.launches - before
        out[dev] = (vol.cpu().numpy(), proj.cpu().numpy(), res, cc)
    (vc, pc, rc, cc), (vg, pg, rg, cg) = out["cpu"], out["cuda"]
    assert k4 == {"cpu": 0, "cuda": 3}
    np.testing.assert_array_equal(vg, vc)
    assert rel_err(pg, pc) <= 1e-5
    for k in ("rot", "tilt", "psi"):
        assert np.abs(rg[k] - rc[k]).max() <= 1e-2, k
    for k in ("sx", "sy"):
        assert np.abs(rg[k] - rc[k]).max() <= 1e-3, k
    assert rel_err(cg, cc) <= 1e-4


@pytest.mark.cuda
def test_continuous_step_loop_never_syncs_on_the_card():
    """A chunk's Adam steps (forward and backward through the slice
    gather, the update, the trust-region clip) queue on the card without
    one host sync: torch.cuda's sync debug mode raises on any."""
    require_cuda()
    from xmipp3_tpu_torch.ops.continuous import _adam_run, _ncc_loss
    from xmipp3_tpu_torch.ops.project import prepare_fourier_volume
    b = phantom_batch(5, 16, 32)
    vf, _ = prepare_fourier_volume(b["imgs"][0][None].repeat(32, 0),
                                   device="cuda")
    imgs = torch.as_tensor(b["imgs"], device="cuda")
    p0 = torch.as_tensor(np.stack([b["rot"], b["tilt"], b["psi"], b["sx"],
                                   b["sy"]]), device="cuda")
    lrs = torch.tensor([0.5, 0.5, 0.5, 0.2, 0.2], device="cuda")
    lo, hi = p0 - 3.0, p0 + 3.0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        p, first, last = _adam_run(
            lambda q: _ncc_loss(q, vf, imgs, 32, 0.35), p0, lrs, 4, lo, hi)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(last).all() and (p >= lo).all() and (p <= hi).all()


def _first_split_samples(C, N=128, P=256, seed=0):
    """The slice samples of C random views at N within max_freq 0.25 (the
    first splits' gridding) and three value streams, on the card."""
    b = phantom_batch(seed, C, 8)
    mats = torch.as_tensor(euler_matrix(b["rot"], b["tilt"], b["psi"]),
                           device="cuda")
    coords = [a.reshape(-1).contiguous()
              for a in trec._slice_tap_coords(mats, N, P, 0.25)]
    rng = np.random.default_rng(seed)
    vals = [torch.as_tensor(rng.standard_normal(coords[0].numel()).astype(
        np.float32), device="cuda") for _ in range(3)]
    return coords, vals, P


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,C", [("kb_scatter_3ch", 8),
                                      ("tri_scatter", 2000)])
def test_scatters_at_the_first_split_shapes(kernel, C):
    """K3 at one classify_first_split subset (8 views of 128^2 into the
    256^3 cube) and K2 at one classify_first_split3 half set (gridded as
    all 2,000 views weighted 0 or 1), each against its plain version
    (1e-4 * max)."""
    require_cuda()
    coords, vals, P = _first_split_samples(C)
    mod, run, plain = _kernel_and_plain(kernel, coords, vals, P)
    cubes = lambda: [torch.zeros((P, P, P), device="cuda") for _ in range(3)]
    got, want = cubes(), cubes()
    before = mod.launches
    run(got)
    assert mod.launches == before + 1
    plain(want)
    for g, w in zip(got, want):
        assert rel_err(g, w) <= 1e-4


@pytest.mark.cuda
def test_analysis_ops_on_the_card_match_the_cpu():
    """The feature extractors and a short SPG TV run, the SO(3) grid and the
    unpolished FRM matrix, the helical map, the halves filter bank and an
    LTSA embedding on the card against the same code on the CPU: features
    1e-4 of each one's max (LBP equal), TV 1e-3 absolute, the SO(3) grid
    1e-5 with the same argmax, the helical map 1e-4, the bank 1e-5, LTSA
    1e-6 up to sign."""
    require_cuda()
    from xmipp3_tpu_torch.models.dimred import ltsa
    from xmipp3_tpu_torch.ops import features as F
    from xmipp3_tpu_torch.ops import halves_restoration as hr
    from xmipp3_tpu_torch.ops.frm import frm_align_volumes
    from xmipp3_tpu_torch.ops.helical import helical_correlation_grid
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((6, 32, 32)).astype(np.float32)
    z, y, x = np.mgrid[0:32, 0:32, 0:32].astype(np.float32) - 16
    v = sum(a * np.exp(-((z - cz) ** 2 + (y - cy) ** 2 + (x - cx) ** 2)
                       / (2 * s * s)) for cz, cy, cx, s, a in
            ((0, 0, 0, 3, 1), (5, -3, 3, 2, .8), (-4, 4, -2, 2.5, .6),
             (2, 6, -5, 1.8, .9)))
    h1, h2 = (v + 0.2 * rng.standard_normal(v.shape).astype(np.float32)
              for _ in range(2))
    X = rng.standard_normal((60, 6))
    out = {}
    for dev in ("cpu", "cuda"):
        o = {n: getattr(F, n)(imgs, device=dev).cpu().numpy() for n in
             ("extract_entropy", "extract_granulo", "extract_histdist",
              "extract_lbp", "extract_ramp", "extract_variance",
              "extract_zernike")}
        o["tv"] = F.tv_denoise_spg(imgs, 20, device=dev).cpu().numpy()
        o["frm"] = frm_align_volumes(h1, h2, L=12, n_beta=32, n_ang=64,
                                     refine=False, device=dev)
        o["hel"] = helical_correlation_grid(v, [2.0, 3.0], [30.0, 40.0],
                                            device=dev).cpu().numpy()
        r2 = torch.as_tensor(hr.make_r2(v.shape), device=dev)
        o["bank"] = torch.stack(hr.filter_bank(
            torch.as_tensor(h1, device=dev), torch.as_tensor(h2, device=dev),
            r2, v.shape, 0.1, 0.5, 1, 3.0)).cpu().numpy()
        o["ltsa"] = ltsa(X, 2, device=dev)
        out[dev] = o
    c, g = out["cpu"], out["cuda"]
    np.testing.assert_array_equal(g["extract_lbp"], c["extract_lbp"])
    for n in [k for k in c if k.startswith("extract_")]:
        assert (np.abs(g[n] - c[n]) <= 1e-4 * np.abs(c[n]).max(axis=0)).all()
    assert np.abs(g["tv"] - c["tv"]).max() <= 1e-3
    np.testing.assert_array_equal(g["frm"], c["frm"])
    assert np.abs(g["hel"] - c["hel"]).max() <= 1e-4
    assert rel_err(g["bank"], c["bank"]) <= 1e-5
    s = np.sign((g["ltsa"] * c["ltsa"]).sum(axis=0))
    assert rel_err(g["ltsa"] * s, c["ltsa"]) <= 1e-6


@pytest.mark.cuda
def test_first_splits_launch_their_scatters_on_the_card(tmp_path):
    """classify_first_split on the card: one K3 launch for the average and
    one a subset; classify_first_split3: one K2 launch a half a sweep and
    two for the final halves. Both write finite volumes."""
    require_cuda()
    from xmipp3_tpu_torch.core.image import Image, save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    from xmipp3_tpu_torch.programs import get_program
    b = phantom_batch(6, 40, 32)
    stk = str(tmp_path / "v.mrcs")
    save_image(stk, b["imgs"])
    MetaData.fromRows({"image": f"{i + 1}@{stk}",
                       "angleRot": float(b["rot"][i]),
                       "angleTilt": float(b["tilt"][i]),
                       "anglePsi": float(b["psi"][i]), "itemId": i + 1}
                      for i in range(40)).write(str(tmp_path / "v.xmd"))
    k3 = scatter_kb.launches
    prog = get_program("classify_first_split")
    assert prog.run_with_args(["-i", str(tmp_path / "v.xmd"), "--oroot",
                               str(tmp_path / "fs"), "--Nrec", "6",
                               "-v", "0"]) == 0
    assert scatter_kb.launches - k3 == 7
    k2 = scatter_tri.launches
    prog3 = get_program("classify_first_split3")
    assert prog3.run_with_args(["-i", str(tmp_path / "v.xmd"), "--oroot",
                                str(tmp_path / "s3"), "--Niter", "1500",
                                "-v", "0"]) == 0
    assert scatter_tri.launches - k2 == 2 * prog3.sweeps_run + 2
    for f in ("fs_v1.vol", "fs_v2.vol", "s3_avg1.vol", "s3_avg2.vol"):
        assert np.isfinite(np.asarray(Image(str(tmp_path / f)).data)).all()


@pytest.mark.cuda
def test_flexibility_ops_on_the_card_match_the_cpu():
    """The Zernike3D warp (batched) and its gradient, the bilinear and KB
    splats, a short batched forward fit and the NMA warp on the card
    against the same code on the CPU: the warps and splats 1e-5 of the
    max, the gradient 1e-4 (float32 sums in another order), the fit's
    coefficients 1e-3 of their max and its correlations 1e-4 (Adam's
    normalised steps carry that roundoff)."""
    require_cuda()
    from xmipp3_tpu_torch.models.nma import warp_volume_field
    from xmipp3_tpu_torch.ops import forward_zernike as fz
    from xmipp3_tpu_torch.ops.zernike import (deform_volume,
                                              zernike_basis_grid)
    rng = np.random.default_rng(0)
    N = 32
    z, y, x = np.mgrid[0:N, 0:N, 0:N].astype(np.float32) - N // 2
    v = sum(a * np.exp(-((z - cz) ** 2 + (y - cy) ** 2 + (x - cx) ** 2)
                       / (2 * s * s)) for cz, cy, cx, s, a in
            ((0, 0, 0, 3, 1), (5, -3, 3, 2, .8), (-4, 4, -2, 2.5, .6),
             (2, 6, -5, 1.8, .9))).astype(np.float32)
    basis = zernike_basis_grid(N, 3, 2)
    c = (rng.standard_normal((4, 3, basis.shape[0])) * 0.6).astype(
        np.float32)
    pos, vals, Z = fz.masked_voxel_basis(v, 3, 2, value_threshold=1e-3)
    prof, nt = fz.blob_splat_profile(1.5)
    imgs = fz.forward_splat_project(pos, vals, Z, c[:3], [10., 50., 90.],
                                    [40., 80., 120.], [0., 30., 60.], N,
                                    device="cpu")[0].numpy()
    field = rng.normal(0, 1.0, (3, N, N, N)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        o = {"warp": deform_volume(v, basis, c, device=dev).cpu().numpy()}
        ct = torch.tensor(c[0], device=dev, requires_grad=True)
        deform_volume(torch.as_tensor(v, device=dev),
                      torch.as_tensor(basis, device=dev),
                      ct).square().sum().backward()
        o["grad"] = ct.grad.cpu().numpy()
        o["kb"] = fz.forward_splat_project(
            pos, vals, Z, c[0], 20.0, 70.0, 5.0, N, blob_profile=prof,
            n_taps=nt, device=dev)[0].cpu().numpy()
        fit = fz.fit_forward_zernike_batch(
            pos, vals, Z, imgs, [10., 50., 90.], [40., 80., 120.],
            [0., 30., 60.], np.zeros((3, 3, Z.shape[0]), np.float32), 0.01,
            N, 5, device=dev)
        o["fit_c"], o["fit_cc"] = (fit[0].cpu().numpy(),
                                   fit[2].cpu().numpy())
        o["nma"] = warp_volume_field(v, field, device=dev).cpu().numpy()
        out[dev] = o
    c_, g = out["cpu"], out["cuda"]
    for k in ("warp", "kb", "nma"):
        assert rel_err(g[k], c_[k]) <= 1e-5, k
    assert rel_err(g["grad"], c_["grad"]) <= 1e-4
    assert rel_err(g["fit_c"], c_["fit_c"]) <= 1e-3
    assert np.abs(g["fit_cc"] - c_["fit_cc"]).max() <= 1e-4



@pytest.mark.cuda
def test_binding_card_graphs_match_the_cpu(tmp_path):
    """The binding's per-image calls, which replay one CUDA graph a call on
    the card (projectVolume, readApplyGeo, image_align), against the same
    calls with device="cpu", four calls in a row so that each replay takes
    new values."""
    require_cuda()
    from xmipp3_tpu_torch.binding import xmippLib as xl
    from xmipp3_tpu_torch.core.image import save_image
    b = phantom_batch(3, 4, 48)
    z, y, x = np.mgrid[0:48, 0:48, 0:48].astype(np.float32) - 24
    vol = np.exp(-((z - 4) ** 2 + y ** 2 + (x + 6) ** 2) / 18.0) + np.exp(
        -((z + 5) ** 2 + (y - 7) ** 2 + x ** 2) / 8.0)
    card, cpu = (xl.FourierProjector(vol, device=d) for d in ("cuda", "cpu"))
    stk = str(tmp_path / "s.mrcs")
    save_image(stk, b["imgs"])
    md = xl.MetaData.fromRows(
        {"image": f"{i + 1}@{stk}", "anglePsi": float(b["psi"][i]),
         "shiftX": float(b["sx"][i]), "shiftY": float(b["sy"][i]),
         "flip": bool(b["flip"][i])} for i in range(4))
    for i, oid in enumerate(md):
        ang = (b["rot"][i], b["tilt"][i], b["psi"][i])
        assert rel_err(card.projectVolume(*ang).getData(),
                       cpu.projectVolume(*ang).getData()) <= 1e-5
        geo = [xl.Image().readApplyGeo(f"{i + 1}@{stk}", md, oid, device=d)
               .getData() for d in ("cuda", "cpu")]
        assert rel_err(*geo) <= 1e-5
        aligned = [xl.image_align(b["imgs"][0], b["imgs"][i], device=d)
                   .getData() for d in ("cuda", "cpu")]
        assert rel_err(*aligned) <= 1e-4
