"""The match job's numbers: the plain reference (reference/match.py) over a
sample, drawn from the seed, of the particles the window matched.

  dirs_unmatched
               the gallery's directions against the reference's sampling
               of the asymmetric unit at the mix's rate and the
               configuration's symmetry (reference/sampling.py): the
               directions of either side with no partner of the other
               within 1e-3 degrees, one to one; exact;
  gallery_err  the last job's gallery against the reference's projections
               at the reference's directions, in the program's order,
               max |difference| / max |reference|;
  scan_gap     per particle the larger of |the program's scan peak - the
               reference's best| and the reference's best - its score of
               the program's reference and mirror: the scan's value and
               its choice;
  psi_err_deg, shift_err_px, corr_err
               the refinement: the reference refines from the program's
               reference and mirror, from its best trial and psi for
               them (from each local peak over the trials within 1e-5 of
               the best, where there are ties, the one nearest the
               program's answer counting), and the largest differences
               of psi, shift and correlation.
"""
from __future__ import annotations

import numpy as np
import torch

from cryobench.reference import match as ref
from cryobench.reference import sampling

TIE = 1e-5
DIR_TOL_DEG = 1e-3


def program_outputs(job, seed: int, count: int):
    """(particle indices, {output: tensor}) of a sample of the particles
    the window matched."""
    idx, outs = [], {}
    for start, res in job.done:
        n = len(res["ref_idx"])
        idx.append(np.arange(start, start + n))
        for k, v in res.items():
            outs.setdefault(k, []).append(v)
    idx = np.concatenate(idx)
    outs = {k: torch.cat(v) for k, v in outs.items()}
    rng = np.random.default_rng(seed + 7)
    pick = np.sort(rng.choice(len(idx), min(count, len(idx)),
                              replace=False))
    sel = torch.as_tensor(pick, device=outs["ref_idx"].device)
    return idx[pick], {k: v[sel] for k, v in outs.items()}


def numbers(job, data, cfg, mix, seed, dev, control: str | None = None):
    """The numbers of the window's outputs; with `control` set ("tf32"),
    of the reference computed in that precision put in the program's
    place instead."""
    n = cfg["sizes"]["box"]
    dirs = sampling.directions(mix["gallery_rate_deg"], cfg["sizes"]["sym"])
    order, unmatched = sampling.pair(job.angles, dirs, DIR_TOL_DEG)
    # the directions as the job hands them to the projector, in float32
    angles = dirs[order].astype(np.float32)
    parts, prog = program_outputs(job, seed, mix["check_particles"])
    imgs = data.stack[torch.as_tensor(parts, device=dev)]
    vf = ref.pad_spectrum(data.vol)
    G = ref.gallery(vf, angles, n, "fp32")
    if control is None:
        G_prog = job.refs
    else:
        G_prog = ref.gallery(vf, angles, n, control)
        prog = ref.match(G_prog, imgs, mix["max_shift"], control)
    del vf
    out = {"dirs_unmatched": float(unmatched),
           "gallery_err": float((G_prog - G).abs().max() / G.abs().max())}
    del G_prog
    best, top, trials = ref.scan(G, imgs, mix["max_shift"], "fp32")
    B = len(imgs)
    ar = torch.arange(B, device=dev)
    r, f = prog["ref_idx"].long(), prog["flip"].long()
    mine = top[ar, r, f]                                   # (B, 2, 3)
    gap = torch.maximum((prog["peak"] - best["peak"]).abs(),
                        best["peak"] - mine[:, 0, 0])
    out["scan_gap"] = float(gap.max())
    # the refinement from every coarse start that ties for the best of the
    # program's reference and mirror; the one nearest the program counts
    ok, trial, psi0 = ref.starts(G, imgs, r, prog["flip"].bool(),
                                 mix["max_shift"], TIE)
    C = ok.shape[1]
    rep = lambda x: x.repeat_interleave(C, 0)
    t = torch.as_tensor(trials, device=dev)[trial.reshape(-1)]
    psi, sx, sy, corr = ref.refine(G, rep(imgs), rep(r), psi0.reshape(-1),
                                   t, rep(prog["flip"].bool()),
                                   mix["max_shift"], "fp32",
                                   mix["refine_iters"])
    at = lambda x: x.reshape(B, C)
    dpsi = (torch.remainder(prog["psi"][:, None] - at(psi) + 180.0, 360.0)
            - 180.0).abs()
    dsh = torch.hypot(prog["sx"][:, None] - at(sx),
                      prog["sy"][:, None] - at(sy))
    dco = (prog["corr"][:, None] - at(corr)).abs()
    far = torch.where(ok, dpsi / 0.1 + dsh / 0.01 + dco / 1e-4, torch.inf)
    pick = far.argmin(dim=1, keepdim=True)
    pick = [x.gather(1, pick)[:, 0] for x in (dpsi, dsh, dco)]
    out["psi_err_deg"] = float(pick[0].max())
    out["shift_err_px"] = float(pick[1].max())
    out["corr_err"] = float(pick[2].max())
    return out


def failed(job) -> int:
    """Particles whose outputs are not finite."""
    bad = 0
    for _, res in job.done:
        ok = torch.ones_like(res["psi"], dtype=torch.bool)
        for k in ("psi", "sx", "sy", "corr", "peak"):
            ok &= torch.isfinite(res[k])
        bad += int((~ok).sum())
    return bad
