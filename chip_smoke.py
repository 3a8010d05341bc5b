#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (xmipp3_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--seed 0]

Phases; any failure exits non-zero before the result line is printed:

1. Device and build: the card's name and power limit (nvidia-smi), the
   nvcc build of every kernel in xmipp3_tpu_torch/csrc/ and its seconds.
2. Kernel vs plain at the main path's shapes: N=128, P=256, one 256-image
   batch of slice samples from random poses (M = 1,661,440 samples). Each
   kernel is held against its plain PyTorch version on the same inputs
   (max |kernel - plain| / max |plain| <= 1e-4: the atomics add in another
   order) and timed with CUDA events beside its plain version, its bound
   and, for K1, three index_add_ calls.
3. End to end through the CLI: an analytic Gaussian phantom's projections
   at N=128 (10,000 views, the repo's headline reconstruction workload;
   uniform on the sphere, random psi, small shifts) are
   written as an .mrcs stack with an .xmd, and
   `python -m xmipp3_tpu_torch.programs reconstruct_fourier` runs
   in-process on the card with --interp kb, tri+kb and nn. Every kernel's
   launch count is set to 0 before each run and read after it; the run's
   kernel must have launched. The map must agree with the phantom: FSC >= 0.9
   up to half Nyquist for kb and tri+kb, real-space correlation >= 0.9 for
   nn.
4. A line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

It needs one card and the checkout around it: it imports xmipp3_tpu_torch
from beside itself (from any working directory), builds every kernel from
the checkout's sources and writes its data under chip_smoke_data/ in the
checkout, which it removes at the end. Without a card, or without the
package beside it, it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N, P, BATCH = 128, 256, 256
VIEWS = 10000  # BASELINE config 3: 10k particles at N=128
DEVICE = "cuda"
TOL = 1e-4
# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor
# cores (the kernels do plain float32 arithmetic).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# Gaussian-blob phantom (cz, cy, cx, sigma, amplitude), centred coordinates:
# the phantom of tests/test_project_reconstruct.py with its centres scaled
# from N=48 to N=128 and its widths kept, so that it has power to Nyquist/2.
_SCALE = 128 / 48
BLOBS = [(cz * _SCALE, cy * _SCALE, cx * _SCALE, s, a) for cz, cy, cx, s, a in
         [(0.0, 0.0, 0.0, 3.0, 1.0), (6.0, -4.0, 5.0, 2.0, 0.8),
          (-5.0, 5.0, -3.0, 2.5, 0.6), (3.0, 6.0, -6.0, 1.8, 0.9)]]

KERNELS = {  # name -> (CUDA source, the TPU kernel's pallas_call line)
    "scatter_add_3ch": ("xmipp3_tpu_torch/csrc/scatter.cu",
                        "xmipp3_tpu/ops/pallas_scatter.py:132"),
    "tri_scatter": ("xmipp3_tpu_torch/csrc/scatter_tri.cu",
                    "xmipp3_tpu/ops/pallas_scatter_tri.py:234"),
    "kb_scatter_3ch": ("xmipp3_tpu_torch/csrc/scatter_kb.cu",
                       "xmipp3_tpu/ops/pallas_scatter_kb.py:258"),
}
RUNS = (("kb", "kb_scatter_3ch"), ("tri+kb", "tri_scatter"),
        ("nn", "scatter_add_3ch"))


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def slice_samples(seed, device):
    """One batch of gridding samples as the main path makes them: slice
    coordinates of random poses (zi, yi, xi) and three value streams."""
    import torch
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    from xmipp3_tpu_torch.ops.reconstruct import _slice_tap_coords
    rng = np.random.default_rng(seed)
    rot = rng.uniform(0, 360, BATCH)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, BATCH)))
    psi = rng.uniform(0, 360, BATCH)
    mats = torch.as_tensor(euler_matrix(rot, tilt, psi), dtype=torch.float32,
                           device=device)
    coords = [a.reshape(-1).contiguous()
              for a in _slice_tap_coords(mats, N, P, 0.5)]
    M = coords[0].numel()
    vals = np.stack([rng.standard_normal(M), rng.standard_normal(M),
                     rng.uniform(0.5, 1.5, M)]).astype(np.float32)
    vals = [torch.as_tensor(v, device=device) for v in vals]
    return coords, vals


def time_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def cubes(device):
    import torch
    return [torch.zeros(P ** 3, dtype=torch.float32, device=device)
            for _ in range(3)]


def compare(name, kernel, plain, stream, bytes_per_sample, ops_per_tap,
            ops_per_sample, M, library=None):
    """Hold `kernel` against `plain` (both fn(c0, c1, c2)) on zeroed cubes,
    time both, and compute the bound from the plain tap stream `stream`
    (idx, u0, u1, u2) of this run's data."""
    import torch
    ck, cp = cubes(DEVICE), cubes(DEVICE)
    kernel(*ck)
    plain(*cp)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(ck, cp))
    ref = max(float(b.abs().max()) for b in cp)
    rel = err / ref
    log(f"  {name}: max|kernel-plain| = {err:.3e}, / max|plain| = {rel:.3e}")
    check(np.isfinite(rel) and rel <= TOL,
          f"{name}: kernel disagrees with its plain version ({rel:.3e} > "
          f"{TOL})")
    ms = time_ms(lambda: kernel(*ck), reps=20)
    plain_ms = time_ms(lambda: plain(*cp), reps=5, warmup=1)
    library_ms = None if library is None else \
        time_ms(lambda: library(*cp), reps=20)
    # bound: the samples read once, every voxel the data touches read and
    # written once in three channels; the taps' float32 arithmetic
    idx, _, _, u2 = stream
    live = u2 != 0
    taps = int(live.sum())
    touched = int(torch.unique(idx[live]).numel())
    nbytes = M * bytes_per_sample + touched * 3 * 4 * 2
    nops = taps * ops_per_tap + M * ops_per_sample
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"  {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms"
        + ("" if library_ms is None else f", index_add_ x3 {library_ms:.4f} ms")
        + f"); bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, "
        f"{nops / 1e9:.3f} GFLOP; {taps} live taps, {touched} voxels)")
    src, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "samples": M, "live_taps": taps,
            "touched_voxels": touched}


def kernels_vs_plain(seed):
    import torch
    from xmipp3_tpu_torch.ops import scatter, scatter_kb, scatter_tri
    from xmipp3_tpu_torch.ops.reconstruct import (BLOB_ALPHA, BLOB_ORDER,
                                                  BLOB_RADIUS)
    (zi, yi, xi), (v0, v1, v2) = slice_samples(seed, DEVICE)
    M = zi.numel()
    log(f"phase 2: kernels vs plain at N={N}, P={P}, one {BATCH}-image "
        f"batch: M = {M} samples")
    out = []

    # K1 on the nn update stream of the batch (one tap per sample)
    z0, y0, x0 = (torch.round(a).to(torch.int32) for a in (zi, yi, xi))
    nn = scatter.expand_taps(z0, y0, x0, [(0, 0, 0)],
                             lambda *_: torch.ones_like(zi), v0, v1, v2, P)
    out.append(compare(
        "scatter_add_3ch",
        lambda *c: scatter.scatter_add_3ch(*c, *nn),
        lambda *c: scatter.scatter_add_3ch_plain(*c, *nn),
        nn, 16, 3, 0, nn[0].numel(),
        library=lambda *c: [a.index_add_(0, nn[0], u)
                            for a, u in zip(c, nn[1:])]))
    del nn

    samples = (zi, yi, xi, v0, v1, v2)
    # K2: per sample floor, fractions and 1-f (9); per live corner the
    # weight (2), three products and three adds (6)
    tri = scatter_tri.tri_expand(*samples, P)
    out.append(compare(
        "tri_scatter",
        lambda *c: scatter_tri.tri_scatter(*c, *samples, P=P),
        lambda *c: scatter_tri.tri_scatter_plain(*c, *samples, P=P),
        tri, 24, 8, 9, M))
    del tri

    # K3: per sample floor and fractions (6); per live tap the distance (8),
    # the degree-7 Horner polynomial (14), three products and three adds (6)
    kb = dict(P=P, radius=BLOB_RADIUS, alpha=BLOB_ALPHA, order=BLOB_ORDER)
    kbs = scatter_kb.kb_expand(*samples, **kb)
    out.append(compare(
        "kb_scatter_3ch",
        lambda *c: scatter_kb.kb_scatter_3ch(*c, *samples, **kb),
        lambda *c: scatter_kb.kb_scatter_plain(*c, *samples, **kb),
        kbs, 24, 28, 6, M))
    del kbs
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 3: end to end through the CLI
# ---------------------------------------------------------------------------

def phantom(n):
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) - n // 2
    vol = np.zeros((n, n, n), np.float32)
    for cz, cy, cx, s, a in BLOBS:
        vol += a * np.exp(-((z - cz) ** 2 + (y - cy) ** 2 + (x - cx) ** 2)
                          / (2 * s ** 2))
    return vol


def projections(n, rot, tilt, psi, sx, sy):
    """Exact projections of the phantom at ZYZ poses, each image's content
    moved by (-sx, -sy) so that the metadata shifts (sx, sy) undo it."""
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    A = np.asarray(euler_matrix(rot, tilt, psi), np.float64)       # (V,3,3)
    y, x = np.mgrid[0:n, 0:n].astype(np.float64) - n // 2
    imgs = np.zeros((len(rot), n, n), np.float32)
    for lo in range(0, len(rot), 256):
        sl = slice(lo, lo + 256)
        acc = np.zeros((len(rot[sl]), n, n))
        for cz, cy, cx, s, a in BLOBS:
            c = np.array([cx, cy, cz])
            px = A[sl, 0] @ c - sx[sl]
            py = A[sl, 1] @ c - sy[sl]
            acc += a * s * np.sqrt(2 * np.pi) * np.exp(
                -((x - px[:, None, None]) ** 2 + (y - py[:, None, None]) ** 2)
                / (2 * s ** 2))
        imgs[sl] = acc
    return imgs


def write_dataset(root: Path, views: int, seed: int):
    from xmipp3_tpu_torch.core.image import save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    rng = np.random.default_rng(seed + 1)
    rot = rng.uniform(0, 360, views)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, views)))
    psi = rng.uniform(0, 360, views)
    sx, sy = rng.uniform(-3, 3, (2, views))
    imgs = projections(N, rot, tilt, psi, sx, sy)
    stk = root / "phantom.mrcs"
    save_image(str(stk), imgs)
    md = MetaData.fromRows(
        {"image": f"{i + 1}@{stk}", "angleRot": float(rot[i]),
         "angleTilt": float(tilt[i]), "anglePsi": float(psi[i]),
         "shiftX": float(sx[i]), "shiftY": float(sy[i])}
        for i in range(views))
    fn = root / "phantom.xmd"
    md.write(str(fn))
    return fn


def end_to_end(seed):
    import torch
    from xmipp3_tpu_torch.core import timing
    from xmipp3_tpu_torch.core.image import Image
    from xmipp3_tpu_torch.ops import scatter, scatter_kb, scatter_tri
    from xmipp3_tpu_torch.ops.fsc import fsc_3d
    from xmipp3_tpu_torch.programs import main as xmipp
    mods = {"scatter_add_3ch": scatter, "tri_scatter": scatter_tri,
            "kb_scatter_3ch": scatter_kb}
    root = ROOT / "chip_smoke_data"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir()
    t0 = time.perf_counter()
    md = write_dataset(root, VIEWS, seed)
    log(f"phase 3: {VIEWS} phantom views at N={N} written in "
        f"{time.perf_counter() - t0:.2f} s")
    ref = phantom(N)
    launches, runs = {}, []
    timing.enable_timing(True)
    try:
        for interp, kname in RUNS:
            out = root / f"rec_{interp.replace('+', '_')}.vol"
            for m in mods.values():
                m.launches = 0
            timing.take_timing()
            t0 = time.perf_counter()
            rc = xmipp(["xmipp", "reconstruct_fourier", "-i", str(md), "-o",
                        str(out), "--interp", interp, "--device", DEVICE,
                        "-v", "0"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: m.launches for k, m in mods.items()}
            phases = timing.take_timing()
            check(rc == 0, f"reconstruct_fourier --interp {interp}: rc {rc}")
            launches[kname] = counts[kname]
            check(counts[kname] > 0, f"--interp {interp} never launched "
                  f"{kname}: {counts}")
            rec = np.squeeze(Image(str(out)).data)
            check(rec.shape == (N, N, N) and np.isfinite(rec).all(),
                  f"--interp {interp}: map of shape {rec.shape}, finite "
                  f"{np.isfinite(rec).all()}")
            _, fsc = fsc_3d(rec, ref, device=DEVICE)
            fsc = fsc.cpu().numpy()
            half = fsc[: len(fsc) // 2]
            a, b = rec - rec.mean(), ref - ref.mean()
            corr = float((a * b).sum() / np.sqrt((a * a).sum()
                                                 * (b * b).sum()))
            run = {"interp": interp, "kernel": kname, "launches": counts,
                   "wall_s": wall, "images_per_s": VIEWS / wall,
                   "fsc_min_to_half_nyquist": float(half.min()),
                   "corr": corr,
                   "phases_s": {k: v[0] for k, v in phases.items()}}
            log(f"  --interp {interp}: {wall:.3f} s, {VIEWS / wall:.1f} "
                f"images/s, launches {counts}, min FSC to Nyquist/2 "
                f"{half.min():.4f}, corr {corr:.4f}, phases "
                + ", ".join(f"{k} {v[0]:.3f} s" for k, v in phases.items()))
            if interp == "nn":
                check(corr >= 0.9, f"--interp nn: correlation {corr:.4f} "
                      "with the phantom < 0.9")
            else:
                check(half.min() >= 0.9, f"--interp {interp}: FSC "
                      f"{half.min():.4f} < 0.9 below half Nyquist")
            runs.append(run)
    finally:
        timing.take_timing()
        timing.enable_timing(False)
        shutil.rmtree(root, ignore_errors=True)
    log("e2e " + json.dumps({"runs": runs}))
    return launches


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "xmipp3_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no xmipp3_tpu_torch package beside {ROOT}; run "
              "this script inside a checkout of the repo", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from xmipp3_tpu_torch.ops import _cuda_build
    t0 = time.perf_counter()
    reports = _cuda_build.build()
    log(f"phase 1: built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, rep in sorted(reports.items()):
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    try:
        kernels = kernels_vs_plain(args.seed)
        launches = end_to_end(args.seed)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
