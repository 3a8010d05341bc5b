"""On a card only: each CUDA kernel of the port against its plain version,
and the whole reconstruction on the card against the same on the CPU.

This file imports neither jax nor the reference package, so that it also
runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(`--noconftest` skips tests/conftest.py, which sets up jax for the other
test files). Without a card every test here skips.
"""
import numpy as np
import pytest
import torch

from test_torch_common import phantom_batch, rel_err, require_cuda
from xmipp3_tpu_torch.core.geometry import euler_matrix
from xmipp3_tpu_torch.ops import reconstruct as trec
from xmipp3_tpu_torch.ops import scatter, scatter_kb, scatter_tri

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
