"""The reconstruct job: direct Fourier reconstruction of the map from the
whole stack at its poses, as `reconstruct_fourier` runs it with xmipp's
defaults (`--padding 2`, `--interp kb`, blob 1.9/0/15, `--max_resolution
0.5`) and `--useCTF --phaseFlipped --minCTF 0.1` at the configuration's
`--sampling` and `--sym`.

A job builds a fresh `ops.reconstruct.FourierReconstructor`, sends every
particle through `add_batch` in the mix's batches with its micrograph's
CTF (`ops.ctf.ctf_params_arrays`), and ends with `finish()`.
"""
from __future__ import annotations

import numpy as np
import torch

from cryobench.jobs import Step

KIND = "reconstruct"


class Job:
    """Runs reconstruct jobs back to back; `step()` is one batch (the last
    of a job also finishes the map)."""

    def __init__(self, cfg: dict, mix: dict, data, dev, spans, seed: int):
        from xmipp3_tpu_torch.ops.ctf import CTFDescription, ctf_params_arrays
        self.cfg, self.mix, self.data, self.dev = cfg, mix, data, dev
        self.spans = spans
        sz, ctf = cfg["sizes"], cfg["ctf"]
        g = data.groups
        descs = [CTFDescription(sampling_rate=sz["apix"], voltage=sz["kv"],
                                defocusU=float(u), defocusV=float(v),
                                azimuthal_angle=float(a), Cs=ctf["cs_mm"],
                                Q0=ctf["q0"])
                 for u, v, a in zip(g["dfu"], g["dfv"], g["az"])]
        per_group = ctf_params_arrays(descs)
        self.ctfp = {k: v[data.group_of] for k, v in per_group.items()}
        self.pose = {k: np.asarray(v, np.float32)
                     for k, v in data.poses.items()}
        V, B = data.stack.shape[0], mix["batch"]
        self.starts = list(range(0, V, B))
        self.rng = np.random.default_rng(seed + 1)
        self.queue = []
        self.rec = None
        self.finished = []        # (reconstructor, map) of finished jobs
        self.batches = []         # the start of every batch, in order

    def reconstructor(self):
        from xmipp3_tpu_torch.ops.reconstruct import FourierReconstructor
        mix, sz = self.mix, self.cfg["sizes"]
        return FourierReconstructor(
            sz["box"], mix["pad"], sz["sym"], mix["max_freq"],
            interp=mix["interp"], blob=tuple(mix["blob"]),
            sampling=sz["apix"], min_ctf=mix["min_ctf"],
            phase_flipped=mix["phase_flipped"], device=self.dev)

    def add(self, rec, s: int, e: int) -> None:
        p = self.pose
        rec.add_batch(self.data.stack[s:e], p["rot"][s:e], p["tilt"][s:e],
                      p["psi"][s:e], p["sx"][s:e], p["sy"][s:e],
                      ctfp={k: v[s:e] for k, v in self.ctfp.items()})

    def step(self) -> Step:
        """One batch; returns what it did."""
        if not self.queue:
            self.queue = list(self.rng.permutation(self.starts))
            self.rec = self.reconstructor()
        s = int(self.queue.pop(0))
        e = min(s + self.mix["batch"], self.data.stack.shape[0])
        with self.spans("add_batch", sync=True):
            self.add(self.rec, s, e)
        self.batches.append(s)
        end = not self.queue
        if end:
            with self.spans("finish", sync=True):
                vol = self.rec.finish()
            if not self.finished:
                self.finished.append((self.rec, vol))
            self.rec = None
        return Step(particles=e - s, job_end=end)

    def release(self) -> None:
        """Free what the check does not read: it reads `finished`."""
        self.rec = None
        self.queue = []

    def warm(self) -> None:
        """Set-up: one batch of each size a job grids and one finish, which
        build and load the kernels and plan the transforms."""
        rec = self.reconstructor()
        B = self.mix["batch"]
        self.add(rec, 0, B)
        last = self.data.stack.shape[0] % B
        if last:
            self.add(rec, 0, last)
        rec.finish()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
