"""CL2D 2-D classification: hierarchical multireference alignment with
class-average refinement.

Counterpart of the reference package's models/cl2d.py (the reference
mpi_classify_CL2D, parallel/mpi_classify_CL2D.h:190). Every iteration
matches all particles against all class references through
ops/match.match_to_gallery (K4 on the card), registers them, decides the
class by correntropy (or correlation), and recomputes the class averages on
the card. The random choices of the level splits and of the reseeding of
small classes are drawn on the host from numpy Generators made from the
same seeds as the reference's, so that both packages pick the same subsets.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor, fp32_products, resolve_device
from xmipp3_tpu_torch.ops.geo import apply_md_geometry, shift_2d_real
from xmipp3_tpu_torch.ops.match import match_to_gallery
from xmipp3_tpu_torch.ops.shift import best_shift

# images per match_to_gallery call: the scan's (B, T, rings, angles)
# spectra of a chunk stay near 1 GB at N=128
MATCH_CHUNK = 2048
# bytes of one correntropy chunk's (B, R, D) float32 kernel tensor
CORRENTROPY_CHUNK_BYTES = 1 << 30

_LEVEL_KEYS = ("refs", "assignments", "psi", "sx", "sy", "flip", "corr")


def initial_references(imgs, n_refs: int, seed: int = 0, device=None):
    """Averages of random subsets: a permutation of the images drawn from
    default_rng(seed), split into n_refs nearly equal parts."""
    imgs = as_tensor(imgs, device)
    order = np.random.default_rng(seed).permutation(len(imgs))
    return torch.stack([imgs[torch.as_tensor(c, device=imgs.device)]
                        .mean(dim=0)
                        for c in np.array_split(order, n_refs)])


def _median(x):
    """numpy's median of a 1-D tensor (the mean of the two middle values
    for an even count; torch.median takes the lower one)."""
    s = torch.sort(x).values
    n = s.numel()
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def correntropy_assign(registered, refs, device=None):
    """Correntropy of each registered image against every reference,
    mean_j exp(-(x_j - r_j)^2 / (2 sigma^2)), with one global sigma^2: the
    median over the images of the per-pixel squared distance to their
    nearest reference (reference correntropy distance,
    mpi_classify_CL2D.cpp:1744-1746). The (B, R, D) kernel tensor is made in
    chunks of about CORRENTROPY_CHUNK_BYTES. Returns (B, R) float32."""
    registered = as_tensor(registered, device)
    X = registered.reshape(len(registered), -1)
    R = as_tensor(refs, X.device).reshape(-1, X.shape[1])
    D = X.shape[1]
    with fp32_products():
        d2m = ((X * X).sum(1, keepdim=True) + (R * R).sum(1)[None, :]
               - 2.0 * (X @ R.T)).clamp(min=0.0) / D
    sigma2 = max(float(_median(d2m.min(dim=1).values)), 1e-12)
    step = max(1, CORRENTROPY_CHUNK_BYTES // max(4 * len(R) * D, 1))
    out = torch.empty((len(X), len(R)), dtype=torch.float32, device=X.device)
    for s in range(0, len(X), step):
        d2 = (X[s:s + step, None, :] - R[None, :, :]) ** 2
        out[s:s + step] = torch.exp(-d2 / (2 * sigma2)).mean(dim=-1)
    return out


def _center_refs(refs, prev):
    """Translation-centre each new representative against its previous
    version (the reference centres class representatives every iteration
    unless --dontAlign, mpi_classify_CL2D.cpp:1755)."""
    sx, sy, _ = best_shift(prev, refs)
    return shift_2d_real(refs, -sx, -sy)


_MATCH_KEYS = {"ref_idx": torch.int64, "psi": torch.float32,
               "sx": torch.float32, "sy": torch.float32, "flip": torch.bool,
               "corr": torch.float32}


def _match(match_refs, imgs, max_shift, check_mirror, mesh):
    """[ref_idx, psi, sx, sy, flip, corr] of every image as tensors on the
    images' device, from match_to_gallery over chunks of C = min(
    MATCH_CHUNK, B) images (the last one padded with zero images). On a
    mesh the chunks are dealt out to the ranks in turn and gathered back
    (the reference's particle-sharded matching, parallel/match.py, as the
    mpi_classify_CL2D shareAssignments replacement): every chunk is the
    serial run's, so the mesh run matches as the serial one does, bit for
    bit, and the classification, which a single changed assignment can
    send elsewhere (the splits draw from the members), stays the same."""
    B = len(imgs)
    C = min(MATCH_CHUNK, B)
    n_chunks = -(-B // C)
    n_dev, rank = 1, 0
    if mesh is not None:
        axis = next(iter(mesh.shape))
        n_dev, rank = mesh.shape[axis], mesh.coords[axis]
    per_rank = -(-n_chunks // n_dev)
    parts = []
    for k in range(rank, per_rank * n_dev, n_dev):
        if k >= n_chunks:           # a padding chunk: the gather's shape
            parts.append({key: torch.zeros(C, dtype=dt, device=imgs.device)
                          for key, dt in _MATCH_KEYS.items()})
            continue
        part = imgs[k * C:(k + 1) * C]
        if len(part) < C:
            part = torch.cat([part, part.new_zeros((C - len(part),)
                                                   + part.shape[1:])])
        parts.append(match_to_gallery(match_refs, part, max_shift=max_shift,
                                      check_mirror=check_mirror))
    out = []
    for key in _MATCH_KEYS:
        v = torch.cat([p[key] for p in parts])
        if mesh is not None:
            from xmipp3_tpu_torch.parallel.mesh import all_gather
            # rank-major (rank, its chunks, C) -> chunk order
            v = all_gather(v, mesh, axis).reshape(n_dev, per_rank, C) \
                .transpose(0, 1).reshape(-1)
        out.append(v[:B])
    return out


def classify_cl2d(imgs, n_refs: int, n_iters: int = 10, max_shift: int = 8,
                  seed: int = 0, verbose: int = 0, check_mirror: bool = True,
                  mesh=None, nref0: int = 1, init_refs=None,
                  distance: str = "correntropy",
                  classical_multiref: bool = False,
                  classical_split: bool = False, max_split_trials: int = 5,
                  min_size_pct: float = 20.0, normalize: bool = True,
                  threshold_mask=None, align_refs: bool = True,
                  neigh: int = -1, device=None):
    """Hierarchical CL2D: start from nref0 classes and split the population
    level by level until n_refs classes exist (the reference's level
    scheme), refining with full multireference alignment at each level.

    The option surface of the reference (mpi_classify_CL2D.cpp:1727-1755):
    --nref0/--ref0 seeds, correntropy|correlation distance with
    --classicalMultiref/--classicalSplit, --minsize, --maxSplitTrials,
    --dontNormalizeImages, --useThresholdMask, --dontAlign, --neigh.
    On a mesh the matching's chunks are dealt out to its ranks and every
    rank holds the same result, the serial run's. Runs on `device`
    (default: the card; the mesh's device on a mesh).

    Returns dict(refs, assignments, psi, sx, sy, flip, corr, history,
    levels) as numpy arrays."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    imgs = as_tensor(imgs, dev)
    if normalize:
        flat = imgs.reshape(len(imgs), -1)
        mu = flat.mean(dim=1, keepdim=True)
        sd = flat.std(dim=1, unbiased=False, keepdim=True).clamp(min=1e-12)
        imgs = ((flat - mu) / sd).reshape(imgs.shape)
    rng = np.random.default_rng(seed)
    if init_refs is not None:
        refs = as_tensor(init_refs, dev).clone()
    elif nref0 > 1:
        refs = initial_references(imgs, min(nref0, n_refs), seed)
    else:
        refs = imgs.mean(dim=0, keepdim=True)
    kw = dict(distance=distance, classical=classical_multiref,
              min_size_pct=min_size_pct, max_split_trials=max_split_trials,
              threshold_mask=threshold_mask, align_refs=align_refs,
              neigh=neigh)
    levels = []
    while len(refs) < n_refs:
        res = _refine(imgs, refs, max(2, n_iters // 2), max_shift,
                      check_mirror, seed, verbose, mesh,
                      **dict(kw, classical=classical_multiref
                             or classical_split))
        levels.append({k: res[k] for k in _LEVEL_KEYS})
        refs = res["refs"]
        # split the widest classes (largest intra-class variance times
        # size) until the target count, at most doubling a level
        n_new = min(2 * len(refs), n_refs)
        assign = res["assignments"]
        registered = res["registered"]
        spread = []
        for k in range(len(refs)):
            sel = torch.as_tensor(np.nonzero(assign == k)[0], device=dev)
            spread.append(-float(registered[sel].var(unbiased=False))
                          * max(len(sel), 1))
        new_refs = list(refs)
        for k in np.argsort(spread):
            if len(new_refs) >= n_new:
                break
            members = np.where(assign == k)[0]
            if len(members) < 2:
                continue
            half = rng.permutation(members)
            a, b = half[: len(half) // 2], half[len(half) // 2:]
            new_refs[k] = registered[torch.as_tensor(a, device=dev)].mean(0)
            new_refs.append(registered[torch.as_tensor(b, device=dev)]
                            .mean(0))
        refs = torch.stack(new_refs)
        levels[-1]["refs"] = levels[-1]["refs"].cpu().numpy()
    res = _refine(imgs, refs, n_iters, max_shift, check_mirror, seed,
                  verbose, mesh, **kw)
    res.pop("registered")
    res["refs"] = res["refs"].cpu().numpy()
    levels.append({k: res[k] for k in _LEVEL_KEYS})
    res["levels"] = levels
    return res


def _refine(imgs, refs, n_iters, max_shift, check_mirror, seed, verbose,
            mesh=None, distance: str = "correntropy",
            classical: bool = False, min_size_pct: float = 0.0,
            max_split_trials: int = 5, threshold_mask=None,
            align_refs: bool = True, neigh: int = -1):
    """n_iters refinement iterations at a fixed class count. Returns
    dict(refs (tensor), assignments, psi, sx, sy, flip, corr (numpy),
    history, registered (tensor))."""
    dev = imgs.device
    n_refs = len(refs)
    history = []
    for it in range(n_iters):
        match_refs = refs
        if threshold_mask is not None:
            # pixels at or below the threshold drop out of the comparison
            # (reference --useThresholdMask)
            match_refs = torch.where(refs > threshold_mask, refs, 0.0)
        ref_idx, psi, sx, sy, flip, corr = _match(
            match_refs, imgs, max_shift, check_mirror, mesh)
        registered = apply_md_geometry(imgs, psi, sx, sy, flip)
        assign = ref_idx.cpu().numpy()
        if distance == "correntropy" and not classical and n_refs > 1:
            # enhanced clustering: correntropy decides the class, the pose
            # stays the correlation match's (as in the reference)
            sim = correntropy_assign(registered, match_refs)
            if neigh > 0 and history:
                # each image keeps only the `neigh` code vectors nearest
                # its previous class (reference --neigh)
                R = refs.reshape(n_refs, -1)
                Rn = R / torch.linalg.vector_norm(
                    R, dim=1, keepdim=True).clamp(min=1e-12)
                with fp32_products():
                    ref_cc = (Rn @ Rn.T).cpu().numpy()
                allowed = np.argsort(-ref_cc, axis=1)[:, :neigh]
                mask = np.full((n_refs, n_refs), -np.inf, np.float32)
                for r in range(n_refs):
                    mask[r, allowed[r]] = 0.0
                sim = sim + torch.as_tensor(mask[history[-1][0]], device=dev)
            assign = sim.argmax(dim=1).cpu().numpy()
        corr_np = corr.cpu().numpy()
        assign_t = torch.as_tensor(assign, device=dev)
        new_refs = torch.empty_like(refs)
        counts = np.bincount(assign, minlength=n_refs)
        wgt = corr.clamp(min=0.0) + 1e-6
        for k in range(n_refs):
            if counts[k] > 0:
                sel = assign_t == k
                w = wgt[sel]
                new_refs[k] = (registered[sel] * w[:, None, None]).sum(0) \
                    / w.sum()
        # reseed empty and too-small classes from half of the most
        # populated one (reference --minsize: classes under min_size_pct %
        # of the average size are re-split, at most max_split_trials
        # times, mpi_classify_CL2D.cpp:1737-1743)
        rng = np.random.default_rng(seed + it)
        min_count = min_size_pct / 100.0 * len(imgs) / max(n_refs, 1)
        trials = 0
        for k in range(n_refs):
            too_small = counts[k] == 0 or (counts[k] < min_count
                                           and trials < max_split_trials)
            if too_small:
                trials += counts[k] > 0
                big = int(np.argmax(counts))
                members = np.where(assign == big)[0]
                half = rng.choice(members, size=max(len(members) // 2, 1),
                                  replace=False)
                new_refs[k] = registered[torch.as_tensor(half, device=dev)] \
                    .mean(0)
        if align_refs and it > 0:
            new_refs = _center_refs(new_refs, refs)
        changed = float((assign != history[-1][0]).mean()) if history else 1.0
        history.append((assign.copy(), float(corr_np.mean())))
        refs = new_refs
        if verbose:
            print(f"  CL2D[{n_refs}] iter {it + 1}: mean corr "
                  f"{corr_np.mean():.4f}, reassigned {changed * 100:.1f}%")
        if it > 0 and changed < 0.01:
            break
    return dict(refs=refs, assignments=assign, psi=psi.cpu().numpy(),
                sx=sx.cpu().numpy(), sy=sy.cpu().numpy(),
                flip=flip.cpu().numpy(), corr=corr_np, history=history,
                registered=registered)
