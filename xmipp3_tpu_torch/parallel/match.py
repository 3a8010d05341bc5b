"""Data- and gallery-parallel matching over the ranks of a mesh.

Counterpart of the reference package's parallel/match.py, which replaces
BasicMpiMetadataProgram's work-dealing on the matching path. In the data
parallel entry points every rank matches its contiguous shard of the
particles (padded to a multiple of the axis size) against the whole
gallery, through the serial functions of ops/match.py and so through K4,
and the fixed-shape result rows are all_gather'ed (the reference's output
sharding, gatherMetadatas in Xmipp). In the gallery-parallel entry points
every rank holds a slice of the gallery, scans all particles against it,
and the global winner is reduced with all_reduce(MAX) and (SUM), as the
reference reduces it with pmax and psum. Every rank returns the same numpy
results. The score matrix (parallel_match_score_matrix) is the one scorer
of align_significant and reconstruct_significant, serial and on a mesh:
it deals fixed chunks of images to the ranks in turn, so that a mesh run
scores each chunk at the serial run's shape, and returns tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.ops.match import (_scan_trials, _trial_shift_grid,
                                        match_score_matrix, match_to_gallery,
                                        refine_winners)
from xmipp3_tpu_torch.parallel.mesh import (all_gather, all_reduce,
                                            pad_to_multiple, replicate,
                                            shard_particles)


def _trials(max_shift: int):
    return tuple(map(tuple, _trial_shift_grid(max_shift)
                     .astype(float).tolist()))


def _gathered(out: dict, mesh, axis_name: str, n_valid: int) -> dict:
    """Each rank's result rows, gathered in rank order and cut to the
    unpadded particles, as numpy."""
    return {k: all_gather(v, mesh, axis_name)[:n_valid].cpu().numpy()
            for k, v in out.items()}


def parallel_match(mesh, refs, imgs, max_shift: int = 8, radius_min: int = 2,
                   radius_max: int | None = None, check_mirror: bool = True,
                   axis_name: str = "data"):
    """The coarse scan of match_to_gallery with the particle axis sharded
    over the mesh: dict(peak, psi, ref_idx, trial, flip)."""
    imgs_p, n_valid = pad_to_multiple(np.asarray(imgs, np.float32),
                                      mesh.shape[axis_name])
    if radius_max is None:
        radius_max = imgs_p.shape[-1] // 2 - 2
    peak, psi, ref, trial, flip = _scan_trials(
        replicate(refs, mesh), shard_particles(imgs_p, mesh, axis_name),
        _trials(max_shift), radius_min, radius_max, check_mirror)
    return _gathered(dict(peak=peak, psi=psi, ref_idx=ref, trial=trial,
                          flip=flip), mesh, axis_name, n_valid)


def parallel_match_full(mesh, refs, imgs, max_shift: int = 8,
                        radius_min: int = 2, radius_max: int | None = None,
                        refine_iters: int = 2, check_mirror: bool = True,
                        axis_name: str = "data", allowed=None,
                        psi_allow=None, n_orientations: int = 1,
                        trial_step=None):
    """Full gallery match (coarse 5-D scan + winner refinement) with the
    particle axis sharded over the mesh: the dp engine behind `--mesh dp`.
    allowed (B, R) candidate masks and psi_allow (B, A) in-plane masks
    shard with the particles; padded rows allow everything (their outputs
    are dropped)."""
    imgs = np.asarray(imgs, np.float32)
    n_dev = mesh.shape[axis_name]
    imgs_p, n_valid = pad_to_multiple(imgs, n_dev)
    if radius_max is None:
        radius_max = imgs.shape[-1] // 2 - 2

    def shard_mask(mask):
        if mask is None:
            return None
        padded = pad_to_multiple(np.asarray(mask, np.float32), n_dev,
                                 fill=1.0)[0]
        return shard_particles(padded, mesh, axis_name)

    out = match_to_gallery(replicate(refs, mesh),
                           shard_particles(imgs_p, mesh, axis_name),
                           max_shift=max_shift, radius_min=radius_min,
                           radius_max=radius_max, refine_iters=refine_iters,
                           check_mirror=check_mirror,
                           allowed=shard_mask(allowed),
                           psi_allow=shard_mask(psi_allow),
                           n_orientations=n_orientations,
                           trial_step=trial_step)
    out.pop("aligned", None)
    return _gathered(out, mesh, axis_name, n_valid)


_SCORE_KEYS = ("peak", "psi", "trial", "flip")


def parallel_match_score_matrix(mesh, refs, imgs, max_shift: int = 8,
                                axis_name: str = "data",
                                check_mirror: bool = True,
                                batch: int | None = None, verbose: int = 0):
    """The full (image, reference) best-over-(psi, shift) score matrix of
    match_score_matrix, in chunks of `batch` images: a dict of (B, R)
    tensors on the references' device (this rank's with a mesh) and the
    trial grid. The chunks are dealt to the ranks along axis_name in turn
    and gathered back in order, so every chunk is scored at the shape that
    the serial run (mesh None) gives it and the scores equal the serial
    ones. batch None: one chunk a rank, the reference's contiguous shards
    (align_significant and reconstruct_significant --mesh dp in the
    reference)."""
    n_dev = 1 if mesh is None else mesh.shape[axis_name]
    rank = 0 if mesh is None else mesh.coords[axis_name]
    if mesh is not None:
        refs = replicate(refs, mesh)
    B, R = len(imgs), len(refs)
    batch = batch or max(-(-B // n_dev), 1)
    n_chunks = -(-B // batch)
    per_rank = -(-n_chunks // n_dev)
    rows = {k: [] for k in _SCORE_KEYS}
    for c in range(rank, per_rank * n_dev, n_dev):
        s, e = c * batch, min((c + 1) * batch, B)
        if c < n_chunks:
            out = match_score_matrix(
                refs, torch.as_tensor(imgs[s:e], dtype=torch.float32,
                                      device=refs.device),
                max_shift=max_shift, check_mirror=check_mirror)
            if verbose:
                print(f"  scored {e}/{B}")
        else:                     # a padding chunk, for the gather's shape
            out = {k: refs.new_zeros((0, R)) for k in _SCORE_KEYS}
        for k in _SCORE_KEYS:
            v = out[k].to(torch.float32)
            rows[k].append(torch.cat([v, v.new_zeros((batch - len(v), R))]))
    res = {}
    for k in _SCORE_KEYS:
        v = torch.cat(rows[k])
        if mesh is not None:
            # rank-major (rank, its chunks, batch) -> chunk order
            v = all_gather(v, mesh, axis_name).reshape(
                n_dev, per_rank, batch, R).transpose(0, 1).reshape(-1, R)
        res[k] = v[:B]
    res["trial"] = res["trial"].to(torch.int64)
    res["flip"] = res["flip"] > 0.5
    res["trials"] = _trial_shift_grid(max_shift).astype(np.float32)
    return res


def parallel_match_tp(mesh, refs, imgs, max_shift: int = 8,
                      radius_min: int = 2, radius_max: int | None = None,
                      refine_iters: int = 2, check_mirror: bool = True,
                      axis_name: str = "model"):
    """Gallery-sharded coarse scan (parallel_match_refsharded) followed by
    the winner refinement, which every rank runs on every particle (the
    reference runs it once, unsharded): the tp counterpart of
    parallel_match_full, for galleries too large to replicate per card."""
    refs = replicate(refs, mesh)
    imgs = replicate(imgs, mesh)
    if radius_max is None:
        radius_max = imgs.shape[-1] // 2 - 2
    coarse = parallel_match_refsharded(mesh, refs, imgs, max_shift=max_shift,
                                       radius_min=radius_min,
                                       radius_max=radius_max,
                                       check_mirror=check_mirror,
                                       axis_name=axis_name)
    grid = _trial_shift_grid(max_shift)
    t = grid[np.clip(coarse["trial"], 0, len(grid) - 1)].astype(np.float32)
    # a winner on a padded (all-zero) reference names an index past the
    # gallery; the reference's gather clamps it to the last one
    best = np.minimum(coarse["ref_idx"], len(refs) - 1)
    on = lambda a: torch.as_tensor(a, device=mesh.device)
    out = refine_winners(refs, imgs, on(best), on(coarse["psi"]), on(t),
                         on(coarse["flip"]), max_shift, radius_min,
                         radius_max, refine_iters)
    res = {k: v.cpu().numpy() for k, v in out.items() if k != "aligned"}
    res["peak"] = coarse["peak"]
    return res


def parallel_match_refsharded(mesh, refs, imgs, max_shift: int = 8,
                              radius_min: int = 2,
                              radius_max: int | None = None,
                              check_mirror: bool = True,
                              axis_name: str = "model"):
    """Gallery-sharded (tensor-parallel) matching: each rank holds a slice
    of the gallery (padded with zero references to a multiple of the axis
    size), correlates ALL particles against it, and the global winner is
    reduced across the ranks, ties going to the lowest rank. Returns
    dict(peak, psi, ref_idx, trial, flip, valid); valid is False where a
    padded reference won."""
    refs = replicate(refs, mesh)
    imgs = replicate(imgs, mesh)
    n_dev = mesh.shape[axis_name]
    per_dev = -(-len(refs) // n_dev)
    if radius_max is None:
        radius_max = imgs.shape[-1] // 2 - 2
    # this rank's slice of the gallery, padded with zero references
    dev = mesh.coords[axis_name]
    mine = refs[dev * per_dev:(dev + 1) * per_dev]
    mine = torch.cat([mine, mine.new_zeros((per_dev - len(mine),
                                            *refs.shape[1:]))])
    # local best over this rank's gallery slice
    peak, psi, ref, trial, flip = _scan_trials(
        mine, imgs, _trials(max_shift), radius_min, radius_max, check_mirror)
    gref = ref + dev * per_dev
    # winner-take-all across the ranks: the best peak, then the lowest rank
    # that holds it sends its payload, the others send zeros
    best_peak = all_reduce(peak.clone(), mesh, axis_name, "max")
    win = peak == best_peak
    first = all_reduce(torch.where(win, n_dev - dev, 0), mesh, axis_name,
                       "max")
    mine = win & (dev == n_dev - first)
    pick = lambda v: all_reduce(torch.where(mine, v.to(torch.float32), 0.0),
                                mesh, axis_name).cpu().numpy()
    gref = pick(gref).astype(int)
    return dict(peak=best_peak.cpu().numpy(), psi=pick(psi), ref_idx=gref,
                trial=pick(trial).astype(int), flip=pick(flip) > 0.5,
                valid=gref < len(refs))
