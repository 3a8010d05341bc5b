"""The match job: projection matching of the whole stack against a gallery
projected from the current map, as `angular_project_library` and
`angular_projection_matching` run it in every refinement iteration.

A job projects the gallery anew (`FourierProjector`, padding 2, at the
directions of `core.sampling.Sampling` for the mix's rate and the
configuration's symmetry, in the library program's batches), then sends
the stack through `ops.match.match_to_gallery` in the mix's batches, with
the matching program's main-path flags (`--max_shift`, mirrors checked,
`--Ri 1` hence radius 2, `--Ro` dim/2-2, 2 refinement iterations).
"""
from __future__ import annotations

import numpy as np
import torch

from cryobench.jobs import Step

KIND = "match"
OUTPUTS = ("ref_idx", "psi", "sx", "sy", "corr", "flip", "peak")


class Job:
    """Runs match jobs back to back; `step()` is one batch (the first of a
    job also projects the gallery)."""

    def __init__(self, cfg: dict, mix: dict, data, dev, spans, seed: int):
        from xmipp3_tpu_torch.core.sampling import Sampling
        self.cfg, self.mix, self.data, self.dev = cfg, mix, data, dev
        self.spans = spans
        self.angles = np.asarray(Sampling(mix["gallery_rate_deg"],
                                          cfg["sizes"]["sym"]).angles,
                                 np.float32)
        n = cfg["sizes"]["box"]
        self.radius_max = n // 2 - 2
        V, B = data.stack.shape[0], mix["batch"]
        self.starts = list(range(0, V, B))
        self.rng = np.random.default_rng(seed + 1)
        self.refs = None
        self.queue = []
        self.done = []            # (start, {output: tensor}) a batch

    def gallery(self) -> torch.Tensor:
        from xmipp3_tpu_torch.ops.project import FourierProjector
        proj = FourierProjector(self.data.vol, pad_factor=self.mix["pad"],
                                device=self.dev)
        a, b = self.angles, self.mix["gallery_batch"]
        out = [proj.project_euler(a[s:s + b, 0], a[s:s + b, 1],
                                  np.zeros(len(a[s:s + b]), np.float32))
               for s in range(0, len(a), b)]
        return torch.cat(out)

    def match(self, imgs):
        from xmipp3_tpu_torch.ops.match import match_to_gallery
        mix = self.mix
        res = match_to_gallery(self.refs, imgs, max_shift=mix["max_shift"],
                               radius_min=2, radius_max=self.radius_max,
                               refine_iters=mix["refine_iters"],
                               check_mirror=True)
        res.pop("aligned", None)
        return res

    def step(self) -> Step:
        """One batch; returns what it did."""
        new_job = not self.queue
        if new_job:
            self.queue = list(self.rng.permutation(self.starts))
            with self.spans("gallery", sync=True):
                self.refs = self.gallery()
        s = int(self.queue.pop(0))
        e = min(s + self.mix["batch"], self.data.stack.shape[0])
        with self.spans("match_batch"):
            res = self.match(self.data.stack[s:e])
        self.done.append((s, {k: res[k] for k in OUTPUTS}))
        return Step(particles=e - s, job_end=not self.queue)

    def release(self) -> None:
        """Free what the check does not read: it reads `refs` (the last
        job's gallery) and `done`."""
        self.queue = []

    def warm(self) -> None:
        """Set-up: the gallery once and one batch, which builds and loads
        the kernels and the caches of every shape a job uses."""
        self.refs = self.gallery()
        B = self.mix["batch"]
        self.match(self.data.stack[:B])
        last = self.data.stack.shape[0] % B
        if last:
            self.match(self.data.stack[:last])
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.refs = None
