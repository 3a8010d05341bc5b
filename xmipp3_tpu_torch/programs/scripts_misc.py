"""Script programs of the reference package's programs/scripts_misc.py:
xmipp_tomo_misalignment_resid_statistics and the k-means that
classify_FTTRI and classify_CLTomo_prog share (`_kmeans`). The module's
other programs are still to be ported (ROADMAP.md port queue item 14).

The statistics program reads and writes metadata on the host, as in the
reference. `_kmeans` draws its starting centroids from the caller's numpy
Generator on the host, in the reference's order, and runs its distances,
centroid means and inertia in float64 on `device`.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.device import resolve_device


def _kmeans(X, k, rng, iters=50, restarts=8, device=None):
    """Labels (numpy int64, (n,)) of the rows of X (an array, or a tensor)
    from the lowest-inertia run of `restarts`
    Lloyd runs of at most `iters` steps, each started from k rows drawn
    without replacement by `rng` (numpy Generator). A run stops when no
    label changes (from all-zero labels at the first step, as in the
    reference)."""
    dev = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float64, device=dev)
    best = None
    for _ in range(restarts):
        C = X[torch.as_tensor(rng.choice(len(X), k, replace=False),
                              device=dev)].clone()
        labels = torch.zeros(len(X), dtype=torch.int64, device=dev)
        for _ in range(iters):
            d = torch.stack([((X - C[c]) ** 2).sum(-1) for c in range(k)],
                            dim=1)
            new = d.argmin(dim=1)
            if bool((new == labels).all()):
                break
            labels = new
            for c in range(k):
                m = labels == c
                if bool(m.any()):
                    C[c] = X[m].mean(dim=0)
        inertia = float(((X - C[labels]) ** 2).sum())
        if best is None or inertia < best[0]:
            best = (inertia, labels)
    return best[1].cpu().numpy()


class ProgTomoMisalignmentResidStatistics(XmippProgram):
    name = "xmipp_tomo_misalignment_resid_statistics"

    def defineParams(self):
        self.addUsageLine("Aggregate statistics over landmark-residual files "
                          "(per-chain rms, per-image mean, histograms).")
        self.addParamsLine("   -i <listOrFile> : Residual .xmd, or text list of them")
        self.addParamsLine("   -o <md>         : Output statistics metadata")

    def run(self):
        fn = self.getParam("-i")
        files = [fn]
        if not fn.endswith(".xmd"):
            files = [ln.strip() for ln in open(fn) if ln.strip()]
        rows = []
        for f in files:
            md = MetaData(f)
            rx = np.asarray(md.getColumn("shiftX"), float)
            ry = np.asarray(md.getColumn("shiftY"), float)
            r = np.sqrt(rx ** 2 + ry ** 2)
            frames = np.asarray(md.getColumn("frameId"), int)
            for fr in np.unique(frames):
                m = r[frames == fr]
                rows.append({"image": f, "frameId": int(fr),
                             "min": float(m.min()), "max": float(m.max()),
                             "avg": float(m.mean()),
                             "stddev": float(m.std())})
        MetaData.fromRows(rows).write(self.getParam("-o"))
        if self.verbose:
            tot = np.mean([r["avg"] for r in rows]) if rows else 0.0
            print(f"{len(rows)} frame statistics; overall mean residual "
                  f"{tot:.2f} px")
