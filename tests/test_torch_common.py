"""Shared inputs for the tests of the PyTorch/CUDA port (xmipp3_tpu_torch),
and the tests of its import isolation and device selection.

The port must never import jax or the reference package, must run on the
card unless told otherwise, and must raise, never fall back to the CPU,
when no card is visible.
"""
import json
import os
import re
import socket
import subprocess
import sys
import time
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


# (z_lo, zdim) of K3's kz-slab cases in a KB_EDGE_P cube: the first and the
# last planes, a one-plane slab, and slabs inside
KB_SLABS = [(0, 5), (5, 6), (11, 5), (3, 1), (0, KB_EDGE_P)]


def kb_slab_samples(z_lo: int, zdim: int, seed: int = 19, P: int = KB_EDGE_P):
    """kb_edge_samples with the z of the in-cube samples moved around the
    slab [z_lo, z_lo + zdim): floors at z_lo - 2, z_lo - 1, z_lo + zdim - 1
    and z_lo + zdim (clipped into [0, P)), so that taps fall on both sides
    of both slab faces; the samples whose floor lies outside the cube stay
    (dropped whole, whatever the slab)."""
    zi, yi, xi, *vals = kb_edge_samples(seed, P)
    rng = np.random.default_rng(seed)
    n = 4 * P
    floors = np.array([z_lo - 2, z_lo - 1, z_lo + zdim - 1, z_lo + zdim])
    zf = np.clip(floors[np.arange(n) % 4], 0, P - 1)
    zi[:n] = (zf + rng.uniform(0, 1, n)).astype(np.float32)
    return [zi, yi, xi, *vals]


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


# the CTF of the reference package's synthetic PSDs
# (tests/test_ctf_full_estimation.py:17-31)
SYNTH_CTF = dict(voltage=300, Cs=2.7, Q0=0.07, K=1.0, espr=1.0, alpha=2e-4,
                 base_line=0.1, sqrt_K=3.0, sqU=12.0, sqV=14.0,
                 sqrt_angle=20.0, gaussian_K=1.5, sigmaU=8000.0,
                 sigmaV=9000.0, cU=0.02, cV=0.022, gaussian_angle=10.0)


def synthetic_psd(n=192, Ts=1.5, defU=17500.0, defV=14500.0, ang=40.0,
                  seed=0):
    """The reference package's synthetic PSD recipe (noise + CTF^2 times a
    chi-square(20)/20 speckle), evaluated with the port's CTF on the CPU:
    (rfft-layout float32 PSD, the true CTFDescription)."""
    from xmipp3_tpu_torch.ops.ctf import CTFDescription
    true = CTFDescription(sampling_rate=Ts, defocusU=defU, defocusV=defV,
                          azimuthal_angle=ang, **SYNTH_CTF)
    fy = np.fft.fftfreq(n).astype(np.float32)[:, None] / Ts
    fx = np.fft.rfftfreq(n).astype(np.float32)[None, :] / Ts
    ctf2 = true.pure_at(fx, fy, device="cpu").numpy() ** 2
    noise = true.noise_at(fx, fy, device="cpu").numpy()
    rng = np.random.default_rng(seed)
    mult = rng.chisquare(20, ctf2.shape).astype(np.float32) / 20
    return ((noise + ctf2) * mult).astype(np.float32), true


def require_cuda():
    """Skip the calling test when no card is visible (decided at run time,
    never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


_IMPORT_PROBE = """
import sys
import xmipp3_tpu_torch
import xmipp3_tpu_torch.programs
from xmipp3_tpu_torch.programs import ALIASES, get_program
from xmipp3_tpu_torch.programs import list_programs
for name in list_programs():
    get_program(name)
from xmipp3_tpu_torch.core import image_formats, metadata_program, sampling
from xmipp3_tpu_torch.ops import (align, arma, cross, ctf, denoise, dft_mm,
                                  features, fourier, fourier_filter, fsc,
                                  geo, mask, match, monogenic, movie,
                                  normalize, polar, project, psd,
                                  reconstruct, resize, scatter, scatter_kb,
                                  scatter_tri, shear_rotate, shift,
                                  spatial_filters)
from xmipp3_tpu_torch.programs import (ctf_correct, ctf_estimate,
                                       final_batch, image_align,
                                       movie_alignment, resolution_dir,
                                       resolution_fsc, resolution_misc,
                                       transform_filter, transform_geometry,
                                       transform_normalize)
from xmipp3_tpu_torch.models import cl2d, ctf_estimation, dimred, ml2d, som
from xmipp3_tpu_torch.models import deep
from xmipp3_tpu_torch import native
from xmipp3_tpu_torch.core import funcs, numerics
from xmipp3_tpu_torch.ops import basis, fringe, steerable
from xmipp3_tpu_torch.programs import (deep_programs, infra_scripts,
                                       matlab_bridge, scripts_misc)
assert len(list_programs()) == 257, len(list_programs())
from xmipp3_tpu_torch.programs import classify
from xmipp3_tpu_torch.core import emx
from xmipp3_tpu_torch.ops import art
from xmipp3_tpu_torch.programs import (align_significant, image_misc,
                                       image_operate, metadata_misc,
                                       metadata_utilities, reconstruct_misc,
                                       transform_misc)
from xmipp3_tpu_torch.parallel import (cli, engines, match, mesh, movie,
                                       reconstruct)
from xmipp3_tpu_torch.core import pdb
from xmipp3_tpu_torch.ops import continuous, phantom
from xmipp3_tpu_torch.programs import (angular_commonline_prog,
                                       angular_misc, angular_programs,
                                       phantom_programs, ssnr_residuals)
from xmipp3_tpu_torch.models import svm
from xmipp3_tpu_torch.ops import optim, pocs
from xmipp3_tpu_torch.programs import (micrograph_programs, misc_programs,
                                       volume_programs)
from xmipp3_tpu_torch.models import nma
from xmipp3_tpu_torch.ops import forward_zernike, zernike
from xmipp3_tpu_torch.programs import (flex_misc_ext, nma_programs,
                                       zernike_programs)
from xmipp3_tpu_torch.programs import list_programs
for name in ("ctf_estimate_from_micrograph", "ctf_estimate_from_psd",
             "ctf_estimate_from_psd_fast", "ctf_group", "ctf_sort_psds",
             "ctf_enhance_psd", "ctf_estimate_psd_with_arma",
             "psd_estimate", "movie_alignment_correlation",
             "cuda_movie_alignment_correlation", "movie_filter_dose",
             "movie_estimate_gain", "phantom_movie",
             "resolution_monogenic_signal", "resolution_monotomo",
             "resolution_fso", "resolution_localfilter",
             "volume_correct_bfactor", "volume_structure_factor",
             "resolution_directional", "classify_CL2D", "ml_align2d",
             "mlf_align2d", "classify_kerdensom",
             "classify_CL2D_core_analysis", "angular_accuracy_pca",
             "image_operate", "transform_window", "transform_add_noise",
             "transform_threshold", "transform_mirror",
             "transform_randomize_phases", "transform_downsample",
             "image_resize", "image_convert", "image_header",
             "image_statistics", "image_histogram", "metadata_utilities",
             "metadata_split", "metadata_import", "metadata_histogram",
             "angular_distance", "angular_rotate", "metadata_convert_emx",
             "reconstruct_art", "reconstruct_wbp", "reconstruct_significant",
             "align_significant", "phantom_create", "phantom_project",
             "project", "phantom_simulate_microscope",
             "angular_continuous_assign2", "angular_continuous_assign",
             "angular_class_average", "angular_neighbourhood",
             "subtract_projection", "image_residuals",
             "angular_discrete_assign", "angular_assignment_mag",
             "angular_break_symmetry", "angular_estimate_tilt_axis",
             "multireference_aligneability", "validation_nontilt",
             "compare_views", "resolution_ssnr",
             "continuous_create_residuals", "angular_commonline",
             "micrograph_scissor", "micrograph_automatic_picking",
             "transform_dimred", "angular_distribution_show",
             "image_odd_even", "transform_adjust_image_grey_levels",
             "local_volume_adjust", "volume_local_sharpening",
             "transform_morphology", "transform_center_image",
             "volume_from_pdb", "volume_center", "volume_align",
             "volume_subtraction", "volume_segment", "transform_mask",
             "transform_symmetrize", "volume_to_pseudoatoms",
             *ALIASES, *list_programs()):
    assert get_program(name) is not None, name
from xmipp3_tpu_torch.binding import xmippLib, xmipp_base
from xmipp3_tpu_torch.binding.xmippPyModules import (
    coordinatesTools, deepLearningToolkitUtils, example_module, swiftalign)
from xmipp3_tpu_torch.binding.xmippPyModules.classifyPcaFuntion import (
    assessment, bnb_gpu, pca_gpu)
from xmipp3_tpu_torch.binding.xmippPyModules.deepLearningToolkitUtils import \
    utils
for sub in ("alignment", "classification", "ctf", "fourier", "image",
            "metadata", "operators", "transform", "utils"):
    __import__("xmipp3_tpu_torch.binding.xmippPyModules.swiftalign." + sub)
assert get_program("test_script_importing_module").run_with_args([]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "optax", "xmipp3_tpu",
                                    "xmippLib", "xmipp_base",
                                    "xmippPyModules"))
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


# ---------------------------------------------------------------------------
# Ranks of a torch.distributed process group for the mesh tests: processes
# of their own that run `python test_torch_common.py <spec> <rank>`, import
# the port and never jax, and write their results beside the spec.
# ---------------------------------------------------------------------------

RANK_TIMEOUT_S = 120


def free_ports(k: int) -> list[int]:
    """k distinct free TCP ports on the loopback (each bound to port 0
    and released together)."""
    socks = [socket.socket() for _ in range(k)]
    try:
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        return [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()


class Ranks:
    """n rank processes running `jobs` (see _rank_main) on `device` in
    `workdir`, from numpy inputs saved as workdir/inputs.npz. join() waits
    at most RANK_TIMEOUT_S for all of them, kills every one that is left,
    and returns each rank's report; a rank that failed or hung fails the
    caller."""

    def __init__(self, n: int, jobs: list, workdir: Path, inputs: dict,
                 device: str = "cpu"):
        self.n, self.dir = n, Path(workdir)
        np.savez(self.dir / "inputs.npz", **inputs)
        ports = free_ports(len(jobs))
        spec = {"world": n, "device": device,
                "jobs": [dict(j, port=p) for j, p in zip(jobs, ports)]}
        (self.dir / "spec.json").write_text(json.dumps(spec))
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(REPO), str(REPO / "tests")])}
        self.procs = []
        for r in range(n):
            with open(self.dir / f"rank{r}.log", "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, __file__, str(self.dir / "spec.json"),
                     str(r)], cwd=self.dir, env=env, stdout=log,
                    stderr=subprocess.STDOUT))
        self.start = time.monotonic()

    def join(self) -> list[dict]:
        try:
            for p in self.procs:
                left = RANK_TIMEOUT_S - (time.monotonic() - self.start)
                p.wait(timeout=max(left, 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        logs = [(self.dir / f"rank{r}.log").read_text() for r in
                range(self.n)]
        for r, p in enumerate(self.procs):
            assert p.returncode == 0, (f"rank {r} of {self.n} exited with "
                                       f"{p.returncode}:\n{logs[r][-4000:]}")
        return [json.loads((self.dir / f"rank{r}.json").read_text())
                for r in range(self.n)]


def _rank_mesh(kind: str, device: str):
    from xmipp3_tpu_torch.parallel.mesh import (Mesh, data_mesh, rank_device,
                                                world)
    if kind == "slab2d":
        return Mesh({"data": world()[0] // 2, "z": 2}, rank_device(device))
    return data_mesh(axis_name=kind, device=device)


def _rank_main(spec_path: str, rank: int) -> None:
    """One rank: for each job, start the process group as the programs do
    (maybe_init_distributed; a CLI job through its own --dist_* flags), run
    the job and record what it returned or raised, the group's backend and
    the kernels' launches. A call job saves its result as
    out_<name>_r<rank>.npz. Every file write of the programs is counted
    per job, to show that only rank 0 writes."""
    from types import SimpleNamespace
    import torch.distributed as dist
    from xmipp3_tpu_torch.core.metadata import MetaData
    from xmipp3_tpu_torch.ops import cross, scatter, scatter_kb, scatter_tri
    from xmipp3_tpu_torch.parallel import engines as pe
    from xmipp3_tpu_torch.parallel import match as pm
    from xmipp3_tpu_torch.parallel import movie as pmov
    from xmipp3_tpu_torch.parallel import reconstruct as pr
    from xmipp3_tpu_torch.parallel.cli import maybe_init_distributed
    from xmipp3_tpu_torch.programs import get_program
    from xmipp3_tpu_torch.programs import align_significant as as_prog
    from xmipp3_tpu_torch.programs import angular_programs as ap_prog
    from xmipp3_tpu_torch.programs import classify_analysis as ca_prog
    from xmipp3_tpu_torch.programs import image_analysis as ia_prog
    from xmipp3_tpu_torch.programs import movie_alignment as ma_prog
    from xmipp3_tpu_torch.programs import reconstruct_fourier as rf_prog
    from xmipp3_tpu_torch.programs import reconstruct_misc as rm_prog
    torch.set_num_threads(1)
    spec = json.loads(Path(spec_path).read_text())
    n, device = spec["world"], spec["device"]
    counters = ((scatter, "launches"), (scatter, "streams_launches"),
                (scatter_tri, "launches"), (scatter_kb, "launches"),
                (scatter_kb, "slab_launches"), (cross, "launches"))
    inputs = dict(np.load(Path(spec_path).parent / "inputs.npz"))
    writes = [0]

    def counted(fn):
        def wrapper(*a, **k):
            writes[0] += 1
            return fn(*a, **k)
        return wrapper

    for prog in (rf_prog, ma_prog, rm_prog, as_prog, ap_prog, ca_prog,
                 ia_prog):
        prog.save_image = counted(prog.save_image)
    MetaData.write = counted(MetaData.write)
    report = {"rank": rank, "jobs": {}}
    for job in spec["jobs"]:
        writes[0] = 0
        for mod, name in counters:
            setattr(mod, name, 0)
        got = {}
        flags = SimpleNamespace(
            dist_coordinator=f"127.0.0.1:{job['port']}", dist_nprocs=n,
            dist_procid=rank, device_arg=device)
        try:
            if "program" in job and job.get("rendezvous") == "env":
                # a program without --dist_* flags: torchrun's environment
                os.environ.update(MASTER_ADDR="127.0.0.1",
                                  MASTER_PORT=str(job["port"]),
                                  WORLD_SIZE=str(n), RANK=str(rank))
                try:
                    got["rc"] = get_program(job["program"]).run_with_args(
                        job["argv"] + ["--device", device, "-v", "0"])
                finally:
                    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                              "RANK"):
                        os.environ.pop(k)
            elif "program" in job:
                got["rc"] = get_program(job["program"]).run_with_args(
                    job["argv"] + [
                        "--dist_coordinator", flags.dist_coordinator,
                        "--dist_nprocs", str(n), "--dist_procid", str(rank),
                        "--device", device, "-v", "0"])
            else:
                assert maybe_init_distributed(flags)
                try:
                    got["backend"] = dist.get_backend()
                    fn = next(getattr(m, job["fn"]) for m in (pr, pm, pmov,
                                                               pe)
                              if hasattr(m, job["fn"]))
                    out = fn(_rank_mesh(job["mesh"], device),
                             *(inputs[k] for k in job["args"]),
                             **{k: inputs[v] for k, v in
                                job.get("arrays", {}).items()},
                             **job.get("kwargs", {}))
                    if isinstance(out, (torch.Tensor, np.ndarray)):
                        out = {"vol": out}
                    elif isinstance(out, tuple):
                        out = {f"out{i}": v for i, v in enumerate(out)}
                    np.savez(Path(spec_path).parent /
                             f"out_{job['name']}_r{rank}.npz",
                             **{k: v.cpu().numpy() if torch.is_tensor(v)
                                else np.asarray(v) for k, v in out.items()})
                finally:
                    dist.destroy_process_group()
        except Exception as e:             # recorded, and read by the test
            got["raised"] = f"{type(e).__name__}: {e}"
        got["writes"] = writes[0]
        got["launches"] = {f"{mod.__name__.split('.')[-1]}.{name}":
                           getattr(mod, name) for mod, name in counters}
        report["jobs"][job["name"]] = got
    report["modules"] = sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "xmipp3_tpu" or m.startswith("xmipp3_tpu."))
    (Path(spec_path).parent / f"rank{rank}.json").write_text(
        json.dumps(report))


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
