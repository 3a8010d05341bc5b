"""Shared inputs for the tests of the PyTorch/CUDA port (xmipp3_tpu_torch),
and the tests of its import isolation and device selection.

The port must never import jax or the reference package, must run on the
card unless told otherwise, and must raise, never fall back to the CPU,
when no card is visible.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from xmipp3_tpu_torch.device import resolve_device

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "xmipp3_tpu_torch"


def rel_err(a, b) -> float:
    """max |a - b| / max |b| over numpy arrays or tensors, real or complex."""
    a, b = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
            for x in (a, b))
    wide = np.complex128 if np.iscomplexobj(a) or np.iscomplexobj(b) \
        else np.float64
    a, b = a.astype(wide), b.astype(wide)
    return float(np.abs(a - b).max() / np.abs(b).max())


def particle_batch(seed: int, C: int, N: int):
    """A batch of random particles with poses, shifts, weights and flips,
    made with numpy from `seed` (the same arrays go to both packages)."""
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((C, N, N)).astype(np.float32)
    rot = rng.uniform(0, 360, C).astype(np.float32)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, C))).astype(np.float32)
    psi = rng.uniform(0, 360, C).astype(np.float32)
    sx, sy = rng.uniform(-2, 2, (2, C)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, C).astype(np.float32)
    flip = rng.uniform(size=C) < 0.3
    return dict(imgs=imgs, rot=rot, tilt=tilt, psi=psi, sx=sx, sy=sy, w=w,
                flip=flip)


BLOBS = [(0.0, 0.0, 0.0, 3.0, 1.0), (4.0, -3.0, 3.0, 2.0, 0.8),
         (-3.0, 3.0, -2.0, 2.5, 0.6), (2.0, 4.0, -4.0, 1.8, 0.9)]


def phantom_batch(seed: int, C: int, N: int):
    """particle_batch with the images replaced by exact projections of a
    Gaussian-blob phantom (tests/test_project_reconstruct.py), content
    moved by (-sx, -sy). Smooth particles like these carry little power
    at the Nyquist edge, where K3 drops samples whole."""
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    b = particle_batch(seed, C, N)
    A = np.asarray(euler_matrix(b["rot"], b["tilt"], b["psi"]), np.float64)
    y, x = np.mgrid[0:N, 0:N].astype(np.float64) - N // 2
    imgs = np.zeros((C, N, N))
    for cz, cy, cx, s, a in BLOBS:
        c = np.array([cx, cy, cz])
        px = (A[:, 0] @ c - b["sx"])[:, None, None]
        py = (A[:, 1] @ c - b["sy"])[:, None, None]
        imgs += a * s * np.sqrt(2 * np.pi) * np.exp(
            -((x - px) ** 2 + (y - py) ** 2) / (2 * s ** 2))
    b["imgs"] = imgs.astype(np.float32)
    return b


# Ragged update streams for K1 (ns == 1, flattened by the caller) and K5:
# (kind, M, ns). SCATTER_S is no multiple of 8, so the accumulators' last
# 32-byte sector is partial.
SCATTER_S = 1003
SCATTER_CASES = (
    [("random", M, ns) for M in (1, 3, 255, 257, 1025) for ns in (1, 3, 8)]
    + [("one_voxel", 4097, 1), ("one_voxel", 1025, 8),
       ("pairs_even", 1024, 1), ("pairs_odd", 1024, 1),
       ("pairs_even", 1025, 2), ("pairs_odd", 1025, 2),
       ("pairs_even", 257, 8), ("pairs_odd", 257, 8),
       ("out_of_range", 1025, 3), ("out_of_range", 257, 8)])
K1_CASES = [c for c in SCATTER_CASES if c[2] == 1]


def scatter_case(kind: str, M: int, ns: int, seed: int = 11):
    """numpy inputs of a scatter: base (3, S) float32, idx (ns, M) int32,
    vals (ns, 3, M) float32. Kinds: "random" indices in [0, S);
    "one_voxel", every update on one voxel; "pairs_even" / "pairs_odd",
    (x, x+1) neighbours with x even / odd, in streams (2t, 2t+1) or, for
    one stream, in updates (2i, 2i+1); "out_of_range", indices in
    [-50, S+50) whose values are zero outside [0, S)."""
    rng = np.random.default_rng(seed)
    S = SCATTER_S
    base = rng.standard_normal((3, S)).astype(np.float32)
    vals = rng.standard_normal((ns, 3, M)).astype(np.float32)
    if kind == "random":
        idx = rng.integers(0, S, (ns, M))
    elif kind == "one_voxel":
        idx = np.full((ns, M), 77)
    elif kind == "out_of_range":
        idx = rng.integers(-50, S + 50, (ns, M))
        vals *= ((idx >= 0) & (idx < S))[:, None, :]
    else:
        x = 2 * rng.integers(0, (S - 2) // 2, (ns, M)) + (kind == "pairs_odd")
        if ns == 1:
            x[0, 1::2] = x[0, :M - 1:2] + 1
        else:
            x[1::2] = x[0:2 * (ns // 2):2] + 1
        idx = x
    return base, idx.astype(np.int32), vals


KB_EDGE_P = 16


def kb_edge_samples(seed: int = 13, P: int = KB_EDGE_P):
    """numpy samples (zi, yi, xi, v0, v1, v2) for K3's row edges: four
    samples at every floor x0 in [0, P) (so x0 - 1 takes every residue mod
    4, and rows straddle x = 0 and x = P - 1), y and z anywhere in [0, P)
    with floors at 0 and P - 1 among them, and six samples whose floor lies
    outside the cube on one axis (dropped whole)."""
    rng = np.random.default_rng(seed)
    x = np.repeat(np.arange(P), 4) + rng.uniform(0, 1, 4 * P)
    y = rng.uniform(0, P, 4 * P)
    z = rng.uniform(0, P, 4 * P)
    y[:P] = rng.uniform(0, 1, P)                  # floor 0
    z[P:2 * P] = P - 1 + rng.uniform(0, 1, P)     # floor P - 1
    out = np.array([[-0.3, 5.5, 5.5], [P + 0.1, 5.5, 5.5], [5.5, -1e-3, 5.5],
                    [5.5, P + 0.5, 5.5], [5.5, 5.5, -2.0], [5.5, 5.5, P]])
    xi, yi, zi = (np.concatenate([a, out[:, k]]) for k, a in
                  enumerate((x, y, z)))
    vals = rng.standard_normal((3, xi.size))
    return [a.astype(np.float32) for a in (zi, yi, xi, *vals)]


TRI_EDGE_P = 16


def tri_edge_samples(seed: int = 17, P: int = TRI_EDGE_P):
    """numpy samples (zi, yi, xi, v0, v1, v2) for K2's rows of two: four
    samples at every floor x0 in [-1, P) (so x0 takes every residue mod 4,
    and pairs straddle x = 0 and x = P - 1), y and z anywhere in [-1, P)
    with floors at -1 and at P - 1 on each, a quarter of each axis's
    fractions exactly 0, and six samples whose floor lies at -2 or below,
    or at P or above, on one axis (no corner inside)."""
    rng = np.random.default_rng(seed)
    n = 4 * (P + 1)
    frac = lambda k: rng.uniform(0, 0.999, k)   # stays below 1 in float32
    x = np.repeat(np.arange(-1, P), 4) + frac(n)
    y = rng.uniform(-1, P - 0.001, n)
    z = rng.uniform(-1, P - 0.001, n)
    q = n // 4
    y[:q], y[q:2 * q] = -1 + frac(q), P - 1 + frac(q)
    z[2 * q:3 * q], z[3 * q:] = -1 + frac(n - 3 * q), P - 1 + frac(n - 3 * q)
    for a in (x, y, z):
        whole = rng.uniform(size=n) < 0.25
        a[whole] = np.floor(a[whole])
    out = np.array([[-2.5, 5.5, 5.5], [P + 0.1, 5.5, 5.5], [5.5, -2.0, 5.5],
                    [5.5, P + 0.5, 5.5], [5.5, 5.5, -3.0], [5.5, 5.5, P]])
    xi, yi, zi = (np.concatenate([a, out[:, k]]) for k, a in
                  enumerate((x, y, z)))
    vals = rng.standard_normal((3, xi.size))
    return [a.astype(np.float32) for a in (zi, yi, xi, *vals)]


def tensor_at_offset(a, offset: int, device="cpu"):
    """A contiguous tensor equal to `a` that starts `offset` elements into
    a larger buffer: with offset 1 its data pointer is 4 bytes past the
    alignment of an allocation."""
    a = np.ascontiguousarray(a)
    src = torch.from_numpy(a)
    big = torch.empty(a.size + offset, dtype=src.dtype, device=device)
    out = big[offset:].view(a.shape)
    out.copy_(src)
    return out


def require_cuda():
    """Skip the calling test when no card is visible (decided at run time,
    never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


_IMPORT_PROBE = """
import sys
import xmipp3_tpu_torch
import xmipp3_tpu_torch.programs
from xmipp3_tpu_torch.programs import get_program
for name in ("reconstruct_fourier", "angular_project_library",
             "angular_projection_matching"):
    get_program(name)
from xmipp3_tpu_torch.core import metadata_program, sampling
from xmipp3_tpu_torch.ops import (cross, dft_mm, fourier, fsc, geo, match, polar,
                                  project, reconstruct, scatter, scatter_kb,
                                  scatter_tri, shear_rotate, shift)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "xmipp3_tpu"
             or m.startswith("xmipp3_tpu."))
print("BAD", bad)
"""


def test_port_imports_neither_jax_nor_the_reference():
    out = subprocess.run([sys.executable, "-c", _IMPORT_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    [*PORT.rglob("*.py"), *PORT.rglob("*.cu"), *PORT.rglob("*.cuh"),
     REPO / "chip_smoke.py"]))
def test_port_sources_name_neither_jax_nor_the_reference(path):
    text = (REPO / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M), path
    other = text.replace("xmipp3_tpu_torch", "")
    assert "xmipp3_tpu." not in other, path
    assert not re.search(r"^\s*(import|from)\s+xmipp3_tpu\b", other,
                         re.M), path


def test_resolve_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "default", "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            resolve_device(dev)
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_without_device_cpu_raises(monkeypatch, tmp_path):
    from xmipp3_tpu_torch.core.image import save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    from xmipp3_tpu_torch.programs import get_program
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = particle_batch(0, 2, 16)
    stk = str(tmp_path / "p.mrcs")
    save_image(stk, b["imgs"])
    fn = str(tmp_path / "p.xmd")
    MetaData.fromRows({"image": f"{i + 1}@{stk}", "angleRot": 0.0,
                       "angleTilt": 0.0, "anglePsi": 0.0}
                      for i in range(2)).write(fn)
    out = str(tmp_path / "rec.vol")
    with pytest.raises(RuntimeError, match="--device cpu"):
        get_program("reconstruct_fourier").run_with_args(["-i", fn, "-o", out])
    assert not os.path.exists(out)


def test_timing_phases_and_profiler_trace(tmp_path):
    from xmipp3_tpu_torch.core import timing
    timing.take_timing()
    timing.enable_timing(True)
    try:
        for _ in range(2):
            with timing.timed_phase("phase", sync=torch.ones(3)):
                torch.ones(8).sum()
        assert "phase" in timing.timing_report()
        took = timing.take_timing()
    finally:
        timing.enable_timing(False)
    assert took["phase"][1] == 2 and took["phase"][0] >= 0
    assert timing.take_timing() == {}
    with timing.trace(str(tmp_path / "tr")):
        torch.ones(64).cumsum(0)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
