"""The reconstruct job's numbers: the plain reference
(reference/reconstruct.py) over the first job the window finished.

  grid_err  the job's gridded cubes at a sample of voxels drawn from the
            seed against the reference's sums over all the job's
            particles, symmetry copies and frequencies: per cube, the
            largest distance of the program's value from the reference's
            interval, over the reference's largest magnitude; the largest
            of the three cubes;
  map_err   the job's map against the reference's finalize of the job's
            cubes, max |difference| / max |reference|.

The reference grids only the sampled voxels (all of a 512^3 or 720^3 cube
would take it minutes), so the finalize is checked from the program's own
cubes, which the first number holds to the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from cryobench.reference import reconstruct as ref
from cryobench.symmetry import group


def numbers(job, data, cfg, mix, seed, dev, control: str | None = None):
    """The numbers of the window's first finished job; with `control` set
    ("bf16"), of the reference computed in that precision put in the
    program's place instead."""
    if not job.finished:
        return {"grid_err": float("inf"), "map_err": float("inf")}
    rec, vol = job.finished[0]
    cubes = (rec.data_r, rec.data_i, rec.weights)
    n = cfg["sizes"]["box"]
    P = cubes[0].shape[-1]
    rng = np.random.default_rng(seed + 7)
    vox = ref.sample_voxels(rng, mix["check_voxels"], P)
    lin = torch.as_tensor((vox[:, 0] * P + vox[:, 1]) * P + vox[:, 2],
                          device=dev)
    sym = group(cfg["sizes"]["sym"])
    args = (vox, data.stack, data.poses, data.groups, data.group_of, sym,
            cfg, mix)
    lo, hi = ref.voxel_sums(*args, "fp32")
    if control is None:
        got = torch.stack([c.reshape(-1)[lin].to(torch.float64)
                           for c in cubes])
        got_map = vol.to(torch.float64)
    else:
        got = ref.voxel_sums(*args, control)[0]
        got_map = ref.finalize(*cubes, n, control)
    dist = torch.clamp(torch.maximum(lo - got, got - hi), min=0.0)
    scale = torch.maximum(lo.abs(), hi.abs()).amax(dim=1)
    grid_err = float((dist.amax(dim=1) / scale).max())
    want = ref.finalize(*cubes, n, "fp32")
    map_err = float((got_map - want).abs().max() / want.abs().max())
    return {"grid_err": grid_err, "map_err": map_err}


def failed(job) -> int:
    """Particles of finished jobs whose map is not finite."""
    return sum(job.data.stack.shape[0] for _, vol in job.finished
               if not bool(torch.isfinite(vol).all()))
