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
    """max |a - b| / max |b| over numpy arrays or tensors."""
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b, np.float64)
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
get_program("reconstruct_fourier")
from xmipp3_tpu_torch.ops import fsc, reconstruct, scatter, scatter_kb, scatter_tri
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
    [*PORT.rglob("*.py"), *PORT.rglob("*.cu"), REPO / "chip_smoke.py"]))
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
