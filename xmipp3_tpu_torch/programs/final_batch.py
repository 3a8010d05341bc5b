"""xmipp_phantom_movie: the synthetic movie generator of the reference
package's programs/final_batch.py (its other programs are still to be
ported, ROADMAP.md port queue item 14).

The scene (ice and content) is drawn with numpy from --seed exactly as the
reference draws it, so both packages make the same reference frame; the
ice low-pass, the per-frame displacement and bilinear resampling and the
Poisson dose run on the card unless `--device cpu` is given. The dose is
drawn with a torch.Generator seeded from --seed, so dosed frames match the
reference's in distribution, not value for value.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.image import save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import as_tensor, resolve_device


class ProgPhantomMovie(XmippProgram):
    """Synthetic movie generator with the reference's full displacement/
    ice/dose model (phantom_movie_main.cpp:41-83, phantom_movie.cpp:30-66
    shift polynomials, :70-93 barrel distortion, :262-280 ice + low-pass,
    :276-305 per-frame resampling and Poisson dose)."""
    name = "xmipp_phantom_movie"

    def defineParams(self):
        self.addUsageLine("Generate a synthetic movie (drifting grid/"
                          "particle scene over low-passed ice, barrel "
                          "distortion, Poisson dose) for testing movie "
                          "alignment (reference phantom_movie).")
        self.addParamsLine("  [-size <x=4096> <y=4096> <n=40>] : Frame size "
                           "and frame count")
        self.addParamsLine("     alias --size;")
        self.addParamsLine("   -o <movie>   : Output stack")
        self.addParamsLine("  [--type <t=grid>] : Scene content")
        self.addParamsLine("      where <t> grid circle cross")
        self.addParamsLine("  [--step <x=50> <y=50>] : Grid period (px)")
        self.addParamsLine("  [--particleSize <min=40> <max=50>] : Particle "
                           "diameter range (circle/cross types)")
        self.addParamsLine("  [--count <c=100>] : Number of particles")
        self.addParamsLine("  [--thickness <t=5>] : Grid-line / cross-arm "
                           "thickness (px)")
        self.addParamsLine("  [--signal <t=0.15>] : Signal added over the "
                           "ice background")
        self.addParamsLine("  [--shift <a1=-0.039> <a2=0.002> <b1=-0.02> "
                           "<b2=0.002>] : Global drift polynomial "
                           "x(t)=a1*t+a2*t^2+cos(t/10)/10, "
                           "y(t)=b1*t+b2*t^2+sin(t^2)/5")
        self.addParamsLine("  [--barrel <k1_start=0.01> <k1_end=0.015> "
                           "<k2_start=0.01> <k2_end=0.015>] : Barrel "
                           "distortion coefficients (linear in frame index)")
        self.addParamsLine("  [--simple] : Use only the linear drift term")
        self.addParamsLine("  [--skipBarrel] : No barrel distortion")
        self.addParamsLine("  [--skipShift] : No drift")
        self.addParamsLine("  [--shiftAfterBarrel] : Apply drift after the "
                           "barrel distortion")
        self.addParamsLine("  [--skipDose] : No Poisson shot noise")
        self.addParamsLine("  [--skipIce] : No ice background")
        self.addParamsLine("  [--gain <file=\"\">] : Write a (unit) gain "
                           "reference image")
        self.addParamsLine("  [--dark <file=\"\">] : Write a (zero) dark "
                           "reference image")
        self.addParamsLine("  [--seed <s=42>]    : Random seed")
        self.addParamsLine("  [--ice <avg=1.0> <stddev=1.0> <min=0.0> "
                           "<max=2.0>] : Ice noise statistics and final "
                           "range")
        self.addParamsLine("  [--low <w1=0.05> <raisedW=0.02>] : Ice "
                           "low-pass cutoff and raised-cosine width")
        self.addParamsLine("  [--dose <mean=1>] : Electron dose (Poisson "
                           "scale)")

    def _shift(self, t):
        a1, a2 = (self.getDoubleParam("--shift", k) for k in (0, 1))
        b1, b2 = (self.getDoubleParam("--shift", k) for k in (2, 3))
        t = float(t)
        if self.checkParam("--simple"):
            return a1 * t, b1 * t
        return (a1 * t + a2 * t * t + np.cos(t / 10.0) / 10.0,
                b1 * t + b2 * t * t + np.sin(t * t) / 5.0)

    def _displace(self, x, y, n, F, X, Y):
        """Source coordinates in the reference frame for output pixel
        (x, y) of frame n (phantom_movie.cpp:70-93); x, y float32 arrays or
        tensors, the coefficients Python floats."""
        if self.checkParam("--skipShift"):
            sx = sy = 0.0
        else:
            sx, sy = self._shift(F - n - 1)   # reversed order (see ref doc)
        if self.checkParam("--skipBarrel"):
            return x + sx, y + sy
        after = self.checkParam("--shiftAfterBarrel")
        k1s, k1e, k2s, k2e = (self.getDoubleParam("--barrel", k)
                              for k in range(4))
        g = n / max(F - 1, 1)
        k1 = k1s + g * (k1e - k1s)
        k2 = k2s + g * (k2e - k2s)
        xc, yc = X / 2.0, Y / 2.0
        xn = (x - xc + (0.0 if after else sx)) / xc
        yn = (y - yc + (0.0 if after else sy)) / yc
        r2 = xn * xn + yn * yn
        scale = 1 + k1 * r2 + k2 * r2 * r2
        return (xn * scale * xc + xc + (sx if after else 0.0),
                yn * scale * yc + yc + (sy if after else 0.0))

    def _add_content(self, ref, rng):
        """The grid, circles or crosses over the reference frame (numpy,
        in place), drawn from `rng` as the reference draws them."""
        sig = self.getDoubleParam("--signal")
        thick = self.getIntParam("--thickness")
        kind = self.getParam("--type")
        Yr, Xr = ref.shape
        if kind == "grid":
            xs = self.getIntParam("--step", 0)
            ys = self.getIntParam("--step", 1)
            for y0 in range(ys - thick // 2, Yr - thick // 2, ys):
                ref[y0:y0 + thick, :] += sig
            for x0 in range(xs, Xr - thick // 2, xs):
                ref[:, x0:x0 + thick] += sig
            return
        mn = self.getIntParam("--particleSize", 0)
        mx = self.getIntParam("--particleSize", 1)
        count = self.getIntParam("--count")
        lo = mx // 2 + thick // 2
        yy, xx = np.mgrid[0:Yr, 0:Xr]
        for _ in range(count):
            s = int(rng.integers(mn, mx + 1)) // 2
            x = int(rng.integers(lo, Xr - lo))
            y = int(rng.integers(lo, Yr - lo))
            if kind == "circle":
                d2 = (yy - y) ** 2 + (xx - x) ** 2
                ref[(d2 <= s * s) & (d2 >= (s - thick) ** 2)] += sig
            else:  # cross: X-shaped diagonals, thickened
                for t in range(max(thick // 2, 1)):
                    for d in range(s):
                        for oy, ox in ((-t, 0), (t, 0), (0, -t), (0, t)):
                            cy, cx = y + oy, x + ox
                            ref[cy - d, cx - d] += sig
                            ref[cy - d, cx + d] += sig
                            ref[cy + d, cx - d] += sig
                            ref[cy + d, cx + d] += sig

    def _reference_frame(self, X, Y, F, seed, device):
        """The padded reference frame (ice + content) on the device."""
        from xmipp3_tpu_torch.ops.fourier_filter import (
            apply_fourier_mask_2d, low_pass_mask)
        rng = np.random.default_rng(seed)
        # work size: pad the reference frame by the maximal |displacement|
        # so every output pixel samples inside it (findWorkSize)
        mx = my = 0.0
        for n in range(F):
            for cx, cy in ((0.0, 0.0), (X - 1.0, Y - 1.0)):
                dx, dy = self._displace(cx, cy, n, F, X, Y)
                mx = max(mx, abs(dx - cx), 1.0)
                my = max(my, abs(dy - cy), 1.0)
        Xr = X + 2 * (int(np.ceil(mx)) + 2)
        Yr = Y + 2 * (int(np.ceil(my)) + 2)
        ref = np.zeros((Yr, Xr), np.float32)
        if not self.checkParam("--skipIce"):
            avg, std, vmin, vmax = (self.getDoubleParam("--ice", k)
                                    for k in range(4))
            ice = (avg + std * rng.standard_normal((Yr, Xr))
                   ).astype(np.float32)
            w1 = self.getDoubleParam("--low", 0)
            rw = self.getDoubleParam("--low", 1)
            ice = apply_fourier_mask_2d(as_tensor(ice, device),
                                        low_pass_mask(Yr, Xr, w1, rw))
            lo, hi = ice.min(), ice.max()
            ref = (vmin + (ice - lo) * (vmax - vmin)
                   / torch.clamp(hi - lo, min=1e-12)).cpu().numpy()
        self._add_content(ref, np.random.default_rng(seed))
        return as_tensor(ref, device)

    def run(self):
        device = resolve_device(self.getParam("--device"))
        X = self.getIntParam("-size", 0)
        Y = self.getIntParam("-size", 1)
        F = self.getIntParam("-size", 2)
        seed = self.getIntParam("--seed")
        with timed_phase("reference frame"):
            ref = self._reference_frame(X, Y, F, seed, device)
        Yr, Xr = ref.shape
        xc, yc = Xr / 2.0 - X / 2.0, Yr / 2.0 - Y / 2.0
        yy = torch.arange(Y, dtype=torch.float32, device=device)[:, None] \
            .expand(Y, X)
        xx = torch.arange(X, dtype=torch.float32, device=device)[None, :] \
            .expand(Y, X)
        flat = ref.reshape(-1)
        dose = self.getDoubleParam("--dose")
        do_dose = not self.checkParam("--skipDose")
        gen = torch.Generator(device=device).manual_seed(seed)
        frames = torch.empty((F, Y, X), dtype=torch.float32, device=device)
        truth = []
        with timed_phase("frames", sync=frames):
            for n in range(F):
                sx_, sy_ = self._displace(xx, yy, n, F, X, Y)
                gx = torch.clamp(sx_ + xc, 0, Xr - 1.001)
                gy = torch.clamp(sy_ + yc, 0, Yr - 1.001)
                x0 = gx.to(torch.int64)
                y0 = gy.to(torch.int64)
                wx = gx - x0
                wy = gy - y0
                tap = lambda dy, dx: flat[(y0 + dy) * Xr + x0 + dx]
                fr = (tap(0, 0) * (1 - wx) * (1 - wy)
                      + tap(0, 1) * wx * (1 - wy)
                      + tap(1, 0) * (1 - wx) * wy
                      + tap(1, 1) * wx * wy)
                if do_dose:
                    fr = torch.poisson(torch.clamp(fr * dose, min=0),
                                       generator=gen)
                frames[n] = fr
                if self.checkParam("--skipShift"):
                    truth.append((0.0, 0.0))
                else:
                    sx, sy = self._shift(F - n - 1)
                    # content moves opposite the sampling displacement
                    truth.append((-sx, -sy))
        fn = self.getParam("-o")
        with timed_phase("write"):
            save_image(fn, frames.cpu().numpy())
            if self.checkParam("--gain") and self.getParam("--gain"):
                save_image(self.getParam("--gain"),
                           np.ones((Y, X), np.float32))
            if self.checkParam("--dark") and self.getParam("--dark"):
                save_image(self.getParam("--dark"),
                           np.zeros((Y, X), np.float32))
            MetaData.fromRows([
                {"image": f"{i + 1:06d}@{fn}", "shiftX": t[0],
                 "shiftY": t[1], "itemId": i + 1}
                for i, t in enumerate(truth)]
            ).write(fn.rsplit(".", 1)[0] + "_gt.xmd")


PROGRAM = None
