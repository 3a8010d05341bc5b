#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (xmipp3_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--seed 0]

Phases; any failure exits non-zero before the result line is printed:

1. Device and build: the card's name and power limit (nvidia-smi), the
   nvcc build of every kernel in xmipp3_tpu_torch/csrc/ and its seconds.
2. Kernel vs plain at the main path's shapes: N=128, P=256, one 256-image
   batch of slice samples from random poses (M = 1,661,440 samples) for the
   gridding kernels; for the multi-stream scatter that batch's 160 tap
   streams under the wide blob of phase 3, made as the main path makes them
   (and, as a side reading, its 8 trilinear tap streams); ring FFTs of
   noise at B=512 images, 31 rings,
   R=1652 references and 64 harmonics for the cross-spectrum. Each kernel
   is held against its plain PyTorch version on the same inputs
   (max |kernel - plain| / max |plain| <= 1e-4 for the scatters, whose
   atomics add in another order; <= 1e-5 for the cross-spectrum, whose sums
   run in a fixed order) and timed with CUDA events beside its plain
   version, its bound and, where one PyTorch call computes the same, that
   call. The scatters also get their bound counted in 32-byte sectors (what
   the atomics move between L2 and device memory), their channel adds per
   second and the wrapper's host microseconds per call; K1 is also timed on
   K5's tap streams flattened, beside K5 on them stacked.
3. End to end through the CLI: an analytic Gaussian phantom's projections
   at N=128 (10,000 views, the repo's headline reconstruction workload;
   uniform on the sphere, random psi, small shifts) are
   written as an .mrcs stack with an .xmd, and
   `python -m xmipp3_tpu_torch.programs reconstruct_fourier` runs
   in-process on the card with --interp kb, tri+kb and nn, and with a blob
   wider than the kb kernel's footprint (--blob 2.5 0 10), whose taps go
   through the multi-stream scatter. Every kernel's launch count is set to
   0 before each run and read after it; the run's kernel must have
   launched. The map must agree with the phantom: FSC >= 0.9 up to half
   Nyquist for kb and tri+kb, real-space correlation >= 0.9 for nn and the
   wide blob.
4. The cycle through the CLI: an 8-blob phantom at N=128 ->
   angular_project_library --sampling_rate 5 (1652 directions) -> 10,000
   analytic views (uniform on the sphere, random psi, shifts of +-3 px,
   noise of 0.5 sigma) -> angular_projection_matching --max_shift 4
   --batch 512 -> reconstruct_fourier on the assigned poses. The launch
   counts are set to 0 before each program. The cross-spectrum kernel must
   have launched in the matching run (13 trial shifts x 20 batches); >= 90 %
   of the views must be assigned within 7.5 degrees of their true direction
   (the antipode with a flip is the same view), the median shift error must
   be <= 0.5 px and the closing map must correlate >= 0.8 with the phantom.
   Its FSC curve and the matching run's per-phase seconds are printed.
5. A line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

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
TOL = 1e-4         # scatters: float atomics add in a run-dependent order
TOL_CROSS = 1e-5   # cross-spectrum: fixed summation order over the rings
# projection matching at full width: the program's defaults at N=128
MATCH_BATCH, MATCH_SHIFT, GALLERY_RATE = 512, 4, 5.0
RINGS, HARMONICS = 31, 64   # radii 2..62 by 2; rfft bins kept by the scan
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

# The 8-blob phantom of tests/test_match.py, scaled like BLOBS: its views
# differ enough for projection matching to tell them apart.
BLOBS8 = BLOBS + [(cz * _SCALE, cy * _SCALE, cx * _SCALE, s, a)
                  for cz, cy, cx, s, a in
                  [(-8.0, -7.0, 2.0, 1.5, 1.1), (9.0, 3.0, -2.0, 1.6, 0.7),
                   (-2.0, -9.0, -8.0, 2.2, 0.95), (7.0, 8.0, 7.0, 1.4, 1.2)]]

KERNELS = {  # name -> (CUDA source, the TPU kernel's pallas_call line)
    "scatter_add_3ch": ("xmipp3_tpu_torch/csrc/scatter.cu",
                        "xmipp3_tpu/ops/pallas_scatter.py:132"),
    "tri_scatter": ("xmipp3_tpu_torch/csrc/scatter_tri.cu",
                    "xmipp3_tpu/ops/pallas_scatter_tri.py:234"),
    "kb_scatter_3ch": ("xmipp3_tpu_torch/csrc/scatter_kb.cu",
                       "xmipp3_tpu/ops/pallas_scatter_kb.py:258"),
    "cross_spectrum": ("xmipp3_tpu_torch/csrc/cross.cu",
                       "xmipp3_tpu/ops/pallas_cross.py:67"),
    "scatter_add_3ch_streams": ("xmipp3_tpu_torch/csrc/scatter.cu",
                                "xmipp3_tpu/ops/pallas_scatter.py:309"),
}
WIDE_BLOB = ("2.5", "0", "10")   # radius, order, alpha: 160 taps a sample
RUNS = (("kb", (), "kb_scatter_3ch"), ("tri+kb", (), "tri_scatter"),
        ("nn", (), "scatter_add_3ch"),
        ("kb", ("--blob", *WIDE_BLOB), "scatter_add_3ch_streams"))


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


def host_us(fn, reps=200):
    """Host microseconds a call of `fn` takes to return (the wrapper's
    checks and the launch; the card runs behind), then a synchronise."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / reps * 1e6


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
    call_us = host_us(lambda: kernel(*ck))
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
    # the same counted in the 32-byte sectors an atomic moves in and out of
    # L2 (the cubes start on a sector boundary)
    sectors = int(torch.unique(idx[live] >> 3).numel())
    sector_bytes = M * bytes_per_sample + sectors * 3 * 32 * 2
    sector_bound_ms = sector_bytes / HBM_BYTES_PER_S * 1e3
    atomics_per_s = 3 * taps / (ms * 1e-3)   # a float2 atomic counts as two
    nops = taps * ops_per_tap + M * ops_per_sample
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"  {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms"
        + ("" if library_ms is None else f", index_add_ {library_ms:.4f} ms")
        + f"); bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, "
        f"{nops / 1e9:.3f} GFLOP; {taps} live taps, {touched} voxels); "
        f"sector bound {sector_bound_ms:.4f} ms ({sectors} sectors, "
        f"{sector_bytes / 1e6:.1f} MB); {atomics_per_s / 1e9:.1f} G channel "
        f"adds/s; wrapper {call_us:.1f} us a call on the host")
    src, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "samples": M, "live_taps": taps,
            "touched_voxels": touched, "sector_bound_ms": sector_bound_ms,
            "touched_sectors": sectors, "atomics_per_s": atomics_per_s,
            "host_us_per_call": call_us}


def streams_vs_plain(label, idx_streams, v_streams, flat):
    """K5 on stacked streams (ns, M) / (ns, 3, M) against its plain version
    and against index_add_ per stream and channel; `flat` is the same
    updates tap-major (idx, u0, u1, u2), on which K1 is timed in the same
    call: which of the two a footprint of several taps should go through."""
    from xmipp3_tpu_torch.ops import scatter
    name = "scatter_add_3ch_streams"
    log(f"  {name} on {label}: {tuple(idx_streams.shape)}")
    got = compare(
        name,
        lambda *c: scatter.scatter_add_3ch_streams(*c, idx_streams, v_streams),
        lambda *c: scatter.scatter_add_3ch_streams_plain(*c, idx_streams,
                                                         v_streams),
        flat, 16, 3, 0, idx_streams.numel(),
        library=lambda *c: [a.index_add_(0, i, u)
                            for i, v in zip(idx_streams, v_streams)
                            for a, u in zip(c, v)])
    ck = cubes(DEVICE)
    k1_ms = time_ms(lambda: scatter.scatter_add_3ch(*ck, *flat), reps=10)
    got["streams"] = idx_streams.shape[0]
    got["k1_on_flattened_streams_ms"] = k1_ms
    log(f"  scatter_add_3ch on these streams flattened ({flat[0].numel()} "
        f"updates): {k1_ms:.4f} ms, against {got['ms']:.4f} ms for {name} "
        "on them stacked")
    return got


def kernels_vs_plain(seed):
    import torch
    from xmipp3_tpu_torch.ops import scatter, scatter_kb, scatter_tri
    from xmipp3_tpu_torch.ops.reconstruct import (BLOB_ALPHA, BLOB_ORDER,
                                                  BLOB_RADIUS, _footprint)
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

    # K5 on the 8 trilinear tap streams of the batch (a side reading: K2's
    # taps, as in earlier runs): per update the index and three values (16
    # bytes), three adds
    tri = scatter_tri.tri_expand(*samples, P)
    idx8 = tri[0].view(8, -1)
    v8 = torch.stack([u.view(8, -1) for u in tri[1:]], dim=1).contiguous()
    tri8 = streams_vs_plain("8 trilinear streams", idx8, v8, tri)
    del tri, idx8, v8, samples
    torch.cuda.empty_cache()

    # K5 at the shape the main path gives it: the batch's tap streams under
    # the wide blob, made as backproject_chunk makes them
    radius, order, alpha = WIDE_BLOB
    foot = _footprint(zi, yi, xi, "kb", (float(radius), int(order),
                                         float(alpha)))
    idxw, vw = scatter.expand_tap_streams(*foot, v0, v1, v2, P)
    del foot
    flat = (idxw.view(-1), *(vw[:, k].reshape(-1) for k in range(3)))
    wide = streams_vs_plain(f"{idxw.shape[0]} streams of the blob "
                            + " ".join(WIDE_BLOB), idxw, vw, flat)
    wide["on_8_trilinear_streams"] = {
        k: tri8[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                             "sector_bound_ms", "rel_err", "max_abs_err",
                             "samples", "live_taps", "atomics_per_s",
                             "k1_on_flattened_streams_ms")}
    out.append(wide)
    del idxw, vw, flat
    torch.cuda.empty_cache()
    out.append(cross_vs_plain(seed))
    torch.cuda.empty_cache()
    return out


def cross_vs_plain(seed):
    """K4 at the matching run's shapes, on ring FFTs of seeded noise made
    as the scan makes them (polar resampling, rfft, 64 harmonics kept)."""
    import torch
    from xmipp3_tpu_torch.ops import cross
    from xmipp3_tpu_torch.ops.polar import cartesian_to_polar, ring_ffts
    name = "cross_spectrum"
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 2)

    def spectra(count):
        imgs = torch.randn((count, N, N), generator=gen, device=DEVICE)
        pol = cartesian_to_polar(imgs, 2, N // 2 - 2, n_angles=2 * HARMONICS,
                                 stride=2)
        return ring_ffts(pol)[..., :HARMONICS].contiguous()

    R = 1652            # directions of a c1 gallery sampled every 5 degrees
    fi, fr = spectra(MATCH_BATCH), spectra(R)
    B, nr, K = fi.shape
    check((nr, K) == (RINGS, HARMONICS), f"{name}: ring FFTs {fi.shape}")
    radii = torch.arange(2, 2 + nr, dtype=torch.float32, device=DEVICE)
    w = radii / radii.sum()
    log(f"phase 2: {name} at B={B}, nr={nr}, R={R}, k={K}, with the mirror")
    got = cross.cross_spectrum(fi, fr, w, mirror=True)
    want = cross.cross_spectrum_plain(fi, fr, w, mirror=True)
    torch.cuda.synchronize()
    err = max(float((g - p).abs().max()) for g, p in zip(got, want))
    rel = err / max(float(p.abs().max()) for p in want)
    log(f"  {name}: max|kernel-plain| = {err:.3e}, / max|plain| = {rel:.3e}")
    check(np.isfinite(rel) and rel <= TOL_CROSS,
          f"{name}: kernel disagrees with its plain version ({rel:.3e} > "
          f"{TOL_CROSS})")
    del got, want
    ms = time_ms(lambda: cross.cross_spectrum(fi, fr, w, mirror=True), reps=20)
    plain_ms = time_ms(lambda: cross.cross_spectrum_plain(fi, fr, w, True),
                       reps=5, warmup=1)

    def library():
        wi = w[None, :, None]
        return (torch.einsum("brk,Rrk->bRk", fi * wi, fr.conj()),
                torch.einsum("brk,Rrk->bRk", fi.conj() * wi, fr.conj()))

    library_ms = time_ms(library, reps=5, warmup=1)
    # what follows K4 in every trial of the scan, per spectrum: the inverse
    # rFFT to the angular curve and the argmax over it
    spec = cross.cross_spectrum(fi, fr, w, mirror=True)[0]
    A = 2 * (K - 1)
    irfft_ms = time_ms(lambda: torch.fft.irfft(spec, n=A), reps=10)
    curve = torch.fft.irfft(spec, n=A)
    argmax_ms = time_ms(lambda: curve.argmax(dim=-1), reps=10)
    del spec, curve
    log(f"  after {name}, per spectrum: irfft(n={A}) {irfft_ms:.4f} ms, "
        f"argmax {argmax_ms:.4f} ms")
    # bound: both operands and the weights read once, the two complex
    # spectra written once; per ring and output pair four multiply-adds
    nbytes = 8 * (B + R) * nr * K + 4 * nr + 2 * 8 * B * R * K
    nops = 8 * B * nr * R * K
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOPS * 1e3
    log(f"  {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, two complex einsums "
        f"{library_ms:.4f} ms); bound {max(t_bytes, t_ops):.4f} ms "
        f"({nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, {nops / 1e9:.3f} GFLOP "
        f"-> {t_ops:.4f} ms)")
    src, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": None, "max_abs_err": err, "rel_err": rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "shape": [B, nr, R, K],
            "irfft_ms": irfft_ms, "argmax_ms": argmax_ms}


# ---------------------------------------------------------------------------
# phase 3: end to end through the CLI
# ---------------------------------------------------------------------------

def phantom(n, blobs=BLOBS):
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) - n // 2
    vol = np.zeros((n, n, n), np.float32)
    for cz, cy, cx, s, a in blobs:
        vol += a * np.exp(-((z - cz) ** 2 + (y - cy) ** 2 + (x - cx) ** 2)
                          / (2 * s ** 2))
    return vol


def projections(n, rot, tilt, psi, sx, sy, blobs=BLOBS):
    """Exact projections of the phantom at ZYZ poses, each image's content
    moved by (-sx, -sy) so that the metadata shifts (sx, sy) undo it."""
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    A = np.asarray(euler_matrix(rot, tilt, psi), np.float64)       # (V,3,3)
    y, x = np.mgrid[0:n, 0:n].astype(np.float64) - n // 2
    imgs = np.zeros((len(rot), n, n), np.float32)
    for lo in range(0, len(rot), 256):
        sl = slice(lo, lo + 256)
        acc = np.zeros((len(rot[sl]), n, n))
        for cz, cy, cx, s, a in blobs:
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


def launch_counts(reset=False):
    """Every kernel's launch count since it was last set to 0; reset=True
    sets them all to 0 after reading."""
    from xmipp3_tpu_torch.ops import cross, scatter, scatter_kb, scatter_tri
    where = {"scatter_add_3ch": (scatter, "launches"),
             "tri_scatter": (scatter_tri, "launches"),
             "kb_scatter_3ch": (scatter_kb, "launches"),
             "cross_spectrum": (cross, "launches"),
             "scatter_add_3ch_streams": (scatter, "streams_launches")}
    counts = {k: getattr(m, a) for k, (m, a) in where.items()}
    if reset:
        for m, a in where.values():
            setattr(m, a, 0)
    return counts


def map_quality(path, ref):
    """(map, FSC curve against ref, real-space correlation with ref)."""
    from xmipp3_tpu_torch.core.image import Image
    from xmipp3_tpu_torch.ops.fsc import fsc_3d
    rec = np.squeeze(Image(str(path)).data)
    check(rec.shape == ref.shape and np.isfinite(rec).all(),
          f"{path.name}: map of shape {rec.shape}, finite "
          f"{np.isfinite(rec).all()}")
    _, fsc = fsc_3d(rec, ref, device=DEVICE)
    a, b = rec - rec.mean(), ref - ref.mean()
    corr = float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))
    return rec, fsc.cpu().numpy(), corr


def end_to_end(seed):
    import torch
    from xmipp3_tpu_torch.core import timing
    from xmipp3_tpu_torch.programs import main as xmipp
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
        for interp, extra, kname in RUNS:
            label = " ".join((interp, *extra))
            out = root / f"rec_{len(runs)}.vol"
            launch_counts(reset=True)
            timing.take_timing()
            t0 = time.perf_counter()
            rc = xmipp(["xmipp", "reconstruct_fourier", "-i", str(md), "-o",
                        str(out), "--interp", interp, *extra, "--device",
                        DEVICE, "-v", "0"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            phases = timing.take_timing()
            check(rc == 0, f"reconstruct_fourier --interp {label}: rc {rc}")
            launches[kname] = counts[kname]
            check(counts[kname] > 0, f"--interp {label} never launched "
                  f"{kname}: {counts}")
            _, fsc, corr = map_quality(out, ref)
            half = fsc[: len(fsc) // 2]
            run = {"interp": label, "kernel": kname, "launches": counts,
                   "wall_s": wall, "images_per_s": VIEWS / wall,
                   "fsc_min_to_half_nyquist": float(half.min()),
                   "corr": corr,
                   "phases_s": {k: v[0] for k, v in phases.items()}}
            log(f"  --interp {label}: {wall:.3f} s, {VIEWS / wall:.1f} "
                f"images/s, launches {counts}, min FSC to Nyquist/2 "
                f"{half.min():.4f}, corr {corr:.4f}, phases "
                + ", ".join(f"{k} {v[0]:.3f} s" for k, v in phases.items()))
            if interp == "nn" or extra:
                check(corr >= 0.9, f"--interp {label}: correlation "
                      f"{corr:.4f} with the phantom < 0.9")
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
# phase 4: gallery -> projection matching -> reconstruction, through the CLI
# ---------------------------------------------------------------------------

def matching_cycle(seed):
    import torch
    from xmipp3_tpu_torch.core import timing
    from xmipp3_tpu_torch.core.image import save_image
    from xmipp3_tpu_torch.core.metadata import MetaData
    from xmipp3_tpu_torch.core.sampling import directions_from_angles
    from xmipp3_tpu_torch.ops.match import _trial_shift_grid
    from xmipp3_tpu_torch.programs import main as xmipp
    root = ROOT / "chip_smoke_data"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir()
    ref = phantom(N, BLOBS8)
    save_image(str(root / "phantom.vol"), ref)
    rng = np.random.default_rng(seed + 3)
    rot = rng.uniform(0, 360, VIEWS)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, VIEWS)))
    psi = rng.uniform(0, 360, VIEWS)
    sx, sy = rng.uniform(-3, 3, (2, VIEWS))
    t0 = time.perf_counter()
    imgs = projections(N, rot, tilt, psi, sx, sy, BLOBS8)
    imgs += (0.5 * imgs.std()) * rng.standard_normal(imgs.shape,
                                                     dtype=np.float32)
    stk = root / "views.mrcs"
    save_image(str(stk), imgs)
    del imgs
    MetaData.fromRows({"image": f"{i + 1}@{stk}", "itemId": i + 1}
                      for i in range(VIEWS)).write(str(root / "views.xmd"))
    log(f"phase 4: {VIEWS} noisy views of the 8-blob phantom at N={N} "
        f"written in {time.perf_counter() - t0:.2f} s")

    steps = (
        ("angular_project_library",
         ["-i", str(root / "phantom.vol"), "-o", str(root / "gallery"),
          "--sampling_rate", str(GALLERY_RATE)]),
        ("angular_projection_matching",
         ["-i", str(root / "views.xmd"), "-o", str(root / "assigned.xmd"),
          "--ref", str(root / "gallery"), "--max_shift", str(MATCH_SHIFT),
          "--batch", str(MATCH_BATCH)]),
        ("reconstruct_fourier",
         ["-i", str(root / "assigned.xmd"), "-o", str(root / "cycle.vol")]))
    report, launches = {}, {}
    timing.enable_timing(True)
    torch.cuda.reset_peak_memory_stats()
    try:
        for name, args in steps:
            launch_counts(reset=True)
            timing.take_timing()
            t0 = time.perf_counter()
            rc = xmipp(["xmipp", name, *args, "--device", DEVICE, "-v", "0"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(rc == 0, f"{name}: rc {rc}")
            report[name] = {
                "wall_s": wall, "launches": launch_counts(),
                "phases_s": {k: v[0] for k, v in timing.take_timing().items()},
                "peak_device_GB": torch.cuda.max_memory_allocated() / 1e9}
            torch.cuda.reset_peak_memory_stats()
            log(f"  {name}: {wall:.3f} s")

        gallery = MetaData(str(root / "gallery.doc"))
        n_refs = gallery.size()
        trials = len(_trial_shift_grid(MATCH_SHIFT))
        batches = -(-VIEWS // MATCH_BATCH)
        launches = report["angular_projection_matching"]["launches"]
        k4 = launches["cross_spectrum"]
        log(f"  gallery: {n_refs} directions; cross_spectrum launched {k4} "
            f"times ({trials} trial shifts x {batches} batches = "
            f"{trials * batches} expected)")
        check(k4 > 0, "the matching run never launched cross_spectrum")
        check(k4 == trials * batches, f"cross_spectrum launched {k4} times, "
              f"expected {trials * batches}")

        md = MetaData(str(root / "assigned.xmd"))
        rows = [md.getRow(i) for i in md]
        check(len(rows) == VIEWS, f"{len(rows)} assignments for {VIEWS} views")
        col = lambda k: np.array([float(r[k]) for r in rows])
        order = col("itemId").astype(int) - 1
        flip = col("flip") > 0
        d_true = directions_from_angles(np.stack([rot, tilt], 1))[order]
        d_got = directions_from_angles(
            np.stack([col("angleRot"), col("angleTilt")], 1))
        # proj(-d) is the mirror of proj(d): a flipped match names the antipode
        d_got = np.where(flip[:, None], -d_got, d_got)
        ang = np.degrees(np.arccos(np.clip((d_true * d_got).sum(1), -1, 1)))
        within = float((ang <= 1.5 * GALLERY_RATE).mean())
        shift_err = np.hypot(col("shiftX") - sx[order],
                             col("shiftY") - sy[order])
        _, fsc, corr = map_quality(root / "cycle.vol", ref)
        report["quality"] = {
            "gallery_directions": n_refs,
            "within_7.5_deg": within, "median_angle_deg": float(np.median(ang)),
            "median_shift_err_px": float(np.median(shift_err)),
            "flipped": float(flip.mean()),
            "mean_maxCC": float(col("maxCC").mean()), "map_corr": corr,
            "fsc": [round(float(v), 4) for v in fsc]}
        log(f"  {within:.4f} of the views within {1.5 * GALLERY_RATE} deg of "
            f"their direction (median {np.median(ang):.2f} deg), median shift "
            f"error {np.median(shift_err):.3f} px, map correlation "
            f"{corr:.4f}")
        check(within >= 0.9, f"only {within:.4f} of the views were assigned "
              f"within {1.5 * GALLERY_RATE} deg of their direction")
        check(np.median(shift_err) <= 0.5, "median shift error "
              f"{np.median(shift_err):.3f} px > 0.5")
        check(corr >= 0.8, f"the cycle's map correlates {corr:.4f} < 0.8 "
              "with the phantom")
    finally:
        timing.take_timing()
        timing.enable_timing(False)
        shutil.rmtree(root, ignore_errors=True)
    log("cycle " + json.dumps(report))
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
        launches.update({k: v for k, v in matching_cycle(args.seed).items()
                         if k not in launches})
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
