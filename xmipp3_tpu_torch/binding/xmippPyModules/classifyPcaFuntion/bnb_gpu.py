"""Branch-and-bound 2-D alignment/classification core (reference
py_xmipp/classifyPcaFuntion/bnb_gpu.py API). The torch band machinery
becomes rfft ring bands + a batched distance match, on the card unless
`device="cpu"` is given:

- setRotAndShift: the (angle, shift) trial grid
- selectFourierBands / create_batchExp: per-image band coefficient
  vectors (rfft2 coefficients grouped by frequency ring)
- precalculate_projection: band vectors of every rotated/shifted
  reference, every trial's warp in one batch
- match_batch: min band-distance assignment over the trial grid
- init_ramdon_classes: random class seeds (host)

Arrays come back to the host as numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor, fp32_products, resolve_device

WARP_BATCH = 4096     # images a warp of precalculate_projection takes


class BnBgpu:
    def __init__(self, nBand, device=None):
        self.nBand = int(nBand)
        self.device = resolve_device(device)

    # -- trial grid ---------------------------------------------------------
    def setRotAndShift(self, angle, shift):
        """angle = (start, stop, step); shift = (max_shift, step).
        Returns the (T, 3) trial table (psi, sx, sy)."""
        a0, a1, astep = angle
        angs = np.arange(a0, a1, astep, dtype=np.float32)
        smax, sstep = shift
        ss = np.arange(-smax, smax + 1e-6, sstep, dtype=np.float32)
        trials = [(a, x, y) for a in angs for x in ss for y in ss]
        self.trials = np.asarray(trials, np.float32)
        return self.trials

    # -- frequency bands ----------------------------------------------------
    def _band_masks(self, n):
        fy = np.fft.fftfreq(n)[:, None]
        fx = np.fft.rfftfreq(n)[None, :]
        r = np.sqrt(fy * fy + fx * fx)
        edges = np.linspace(0.02, 0.45, self.nBand + 1)
        return [(r >= edges[i]) & (r < edges[i + 1])
                for i in range(self.nBand)]

    def _bands(self, images):
        """Band coefficient vectors of a (B, n, n) tensor on its device:
        list over bands of (B, n_coef*2) float32 tensors."""
        F = torch.fft.rfft2(images)
        out = []
        for m in self._band_masks(images.shape[-1]):
            c = F[..., torch.as_tensor(m, device=F.device)]
            out.append(torch.cat([c.real, c.imag], dim=-1))
        return out

    def selectFourierBands(self, images):
        """Band coefficient vectors of a stack: list over bands of
        (B, n_coef*2) real arrays."""
        return [b.cpu().numpy() for b in
                self._bands(as_tensor(images, self.device))]

    def create_batchExp(self, images):
        """Experimental band matrix: (B, sum_coeffs) concatenated bands."""
        return torch.cat(self._bands(as_tensor(images, self.device)),
                         dim=-1).cpu().numpy()

    def precalculate_projection(self, refs, trials=None):
        """Band matrix of every (reference, trial) pair:
        (R, T, sum_coeffs)."""
        from xmipp3_tpu_torch.ops.geo import apply_alignment_2d
        refs = as_tensor(refs, self.device)
        trials = self.trials if trials is None else trials
        R, T = len(refs), len(trials)
        t = as_tensor(np.repeat(np.asarray(trials, np.float32), R, axis=0),
                      self.device)                      # (T*R, 3), t-major
        out = []
        for lo in range(0, T * R, WARP_BATCH):
            sl = slice(lo, min(lo + WARP_BATCH, T * R))
            idx = torch.arange(sl.start, sl.stop, device=self.device) % R
            warped = apply_alignment_2d(refs[idx], t[sl, 0], t[sl, 1],
                                        t[sl, 2])
            out.append(torch.cat(self._bands(warped), dim=-1))
        return torch.cat(out).reshape(T, R, -1).transpose(0, 1) \
            .cpu().numpy()                              # (R, T, C)

    def match_batch(self, batchExp, batchRef):
        """Min L2 band distance over (ref, trial): returns
        (labels (B,), best_trial (B,), distances (B,))."""
        x = as_tensor(batchExp, self.device)
        ref = as_tensor(batchRef, self.device)
        B = len(x)
        Rr, T, C = ref.shape
        flat = ref.reshape(Rr * T, C)
        with fp32_products():
            x2 = (x ** 2).sum(1, keepdim=True)
            r2 = (flat ** 2).sum(1)[None, :]
            d2 = x2 + r2 - 2.0 * x @ flat.T
        k = d2.argmin(dim=1)
        dist = d2[torch.arange(B, device=x.device), k]
        k = k.cpu().numpy()
        return k // T, k % T, dist.cpu().numpy()

    def init_ramdon_classes(self, n_classes, images, seed=0):
        """Random-subset class averages (the reference's spelling kept)."""
        rng = np.random.default_rng(seed)
        images = np.asarray(images, np.float32)
        order = rng.permutation(len(images))
        return np.stack([images[c].mean(axis=0)
                         for c in np.array_split(order, n_classes)])
