"""Three programs of the reference package's programs/final_batch.py:
xmipp_phantom_movie, xmipp_image_peak_high_contrast and
xmipp_image_assignment_tilt_pair (its other programs are still to be
ported, ROADMAP.md port queue item 14).

image_peak_high_contrast's fiducial mode band-passes the tomogram's slices
and thresholds them on the card; the connected components (scipy), the
box filters and the simple mode's greedy peak loop run on the host, as in
the reference. image_assignment_tilt_pair is host geometry (scipy's
Delaunay triangulations and k-d trees, numpy least squares) in both
packages.

phantom_movie: the scene (ice and content) is drawn with numpy from --seed exactly as the
reference draws it, so both packages make the same reference frame; the
ice low-pass, the per-frame displacement and bilinear resampling and the
Poisson dose run on the card unless `--device cpu` is given. The dose is
drawn with a torch.Generator seeded from --seed, so dosed frames match the
reference's in distribution, not value for value.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.image import Image, save_image
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


class ProgImagePeakHighContrast(XmippProgram):
    name = "xmipp_image_peak_high_contrast"

    def defineParams(self):
        self.addUsageLine("Detect high-contrast peaks (e.g. gold beads) in "
                          "images/volumes.")
        self.addParamsLine("  [-i <image=\"\">]   : Input image or volume "
                           "(simple sigma-peak mode)")
        self.addParamsLine("  [-o <md_file=coordinates3D.xmd>] : Peak "
                           "coordinates")
        self.addParamsLine("  [--boxSize <b=32>] : Box size of the peaked "
                           "fiducials")
        self.addParamsLine("  [--thr <t=5>]  : Threshold (sigmas, simple "
                           "mode)")
        # full fiducial-detection surface
        # (image_peak_high_contrast.cpp:58-68)
        self.addParamsLine("  [--vol <vol=\"\">] : Input tomogram "
                           "(fiducial-detection mode)")
        self.addParamsLine("  [--samplingRate <s=1>] : Sampling (A/px)")
        self.addParamsLine("  [--fiducialSize <f=100>] : Fiducial size (A)")
        self.addParamsLine("  [--numberSampSlices <n=10>] : Slices used to "
                           "estimate the outlier threshold")
        self.addParamsLine("  [--sdThr <s=5>] : STD multiples defining an "
                           "outlier pixel")
        self.addParamsLine("  [--numberOfCoordinatesThr <n=10>] : Minimum "
                           "voxels attracted to a coordinate")
        self.addParamsLine("  [--mirrorCorrelationThr <m=0.1>] : Minimum "
                           "correlation of a peak box with its mirror")
        self.addParamsLine("  [--mahalanobisDistanceThr <m=2>] : Maximum "
                           "Mahalanobis distance of a peak's radial "
                           "profile")
        self.addParamsLine("  [--relaxedModeThr <n=3>] : Disable a filter "
                           "if it would leave fewer coordinates than this")

    def _run_fiducial(self):
        """Full pipeline (image_peak_high_contrast.cpp): bandpass at the
        fiducial scale, dark-outlier thresholding from sampling slices,
        connected-component coordinate attraction, mirror-correlation and
        Mahalanobis filters with relaxed-mode fallbacks."""
        from scipy import ndimage

        from xmipp3_tpu_torch.ops.fourier_filter import (apply_fourier_mask_2d,
                                                         band_pass_mask)
        dev = resolve_device(self.getParam("--device"))
        vol = np.squeeze(Image(self.getParam("--vol")).data
                         ).astype(np.float32)
        fid_px = max(self.getDoubleParam("--fiducialSize")
                     / self.getDoubleParam("--samplingRate"), 4.0)
        box = self.getIntParam("--boxSize")
        n_samp = self.getIntParam("--numberSampSlices")
        sd_thr = self.getDoubleParam("--sdThr")
        relaxed = self.getIntParam("--relaxedModeThr")
        Z, H, W = vol.shape
        with timed_phase("band-pass"):
            # slice-wise bandpass at the fiducial scale
            filt = apply_fourier_mask_2d(
                vol, band_pass_mask(H, W, 1.0 / (4.0 * fid_px),
                                    min(1.0 / (0.5 * fid_px), 0.45)),
                device=dev)
            # outlier threshold from the central sampling slices
            z0 = max(Z // 2 - n_samp // 2, 0)
            samp = filt[z0:z0 + max(n_samp, 1)]
            mu, sd = float(samp.mean()), float(samp.std(correction=0))
            dark = (filt < mu - sd_thr * sd).cpu().numpy()
            filt = filt.cpu().numpy()
        with timed_phase("components"):
            labels, n_lab = ndimage.label(dark)
            coords = []
            if n_lab:
                idx = np.arange(1, n_lab + 1)
                sizes = ndimage.sum_labels(dark, labels, idx)
                cents = ndimage.center_of_mass(dark, labels, idx)
                coords = [(int(round(cx)), int(round(cy)), int(round(cz)),
                           float(n)) for n, (cz, cy, cx) in zip(sizes, cents)
                          if n >= self.getIntParam("--numberOfCoordinatesThr")]
        h = box // 2
        coords = [(x, y, z, n) for (x, y, z, n) in coords
                  if h <= x < W - h and h <= y < H - h and 0 <= z < Z]
        bxs = np.asarray([filt[z, y - h:y + h, x - h:x + h]
                          for (x, y, z, _) in coords])
        # mirror-correlation filter (fiducials are centro-symmetric)
        if len(coords):
            b = bxs - bxs.mean(axis=(1, 2), keepdims=True)
            m = b[:, ::-1, ::-1]
            cc = (b * m).sum(axis=(1, 2)) / np.maximum(
                np.sqrt((b * b).sum(axis=(1, 2))
                        * (m * m).sum(axis=(1, 2))), 1e-12)
            keep = cc >= self.getDoubleParam("--mirrorCorrelationThr")
            if keep.sum() >= relaxed:          # relaxed mode fallback
                coords = [c for c, k in zip(coords, keep) if k]
                bxs = bxs[keep]
        # Mahalanobis filter on radial profiles
        if len(coords) > 3:
            yy, xx = np.mgrid[0:box, 0:box] - h
            r = np.sqrt(yy * yy + xx * xx).astype(int)
            nb = min(h, r.max())
            prof = np.stack([[bx[r == k].mean() for k in range(nb)]
                             for bx in bxs])
            d = prof - prof.mean(axis=0)
            icov = np.linalg.inv(np.cov(prof.T) + 1e-6 * np.eye(nb))
            keep = np.sqrt(np.einsum("ni,ij,nj->n", d, icov, d)) \
                <= self.getDoubleParam("--mahalanobisDistanceThr")
            if keep.sum() >= relaxed:
                coords = [c for c, k in zip(coords, keep) if k]
        rows = [{"xcoor": x, "ycoor": y, "zcoor": z, "cost": n}
                for (x, y, z, n) in coords]
        MetaData.fromRows(rows).write(self.getParam("-o"))
        self.n_peaks = len(rows)
        if self.verbose:
            print(f"Detected {len(rows)} fiducial coordinates")

    def run(self):
        if self.getParam("--vol"):
            self._run_fiducial()
            return
        data = np.squeeze(Image(self.getParam("-i")).data).astype(np.float32)
        thr = self.getDoubleParam("--thr")
        box = self.getIntParam("--boxSize")
        work = np.abs(data - data.mean())
        sigma = data.std()
        rows = []
        for _ in range(200):
            pos = np.unravel_index(np.argmax(work), work.shape)
            if work[pos] < thr * sigma:
                break
            row = {"xcoor": int(pos[-1]), "ycoor": int(pos[-2])}
            if data.ndim == 3:
                row["zcoor"] = int(pos[0])
            row["cost"] = float(work[pos])
            rows.append(row)
            work[tuple(slice(max(p - box, 0), p + box) for p in pos)] = 0
        MetaData.fromRows(rows).write(self.getParam("-o"))
        self.n_peaks = len(rows)


class ProgImageAssignmentTiltPair(XmippProgram):
    name = "xmipp_image_assignment_tilt_pair"

    def defineParams(self):
        self.addUsageLine("Match particle coordinates between untilted and "
                          "tilted micrographs: Delaunay-triangle RANSAC "
                          "initialization (reference external/delaunay + "
                          "TiltPairAligner, data/micrograph.h:549) followed "
                          "by iterative affine refinement on mutual nearest "
                          "neighbors.")
        self.addParamsLine("   --untiltcoor <md> : Untilted coordinates")
        self.addParamsLine("   --tiltcoor <md>   : Tilted coordinates")
        self.addParamsLine("   --odir <dir=.>    : Output directory")
        self.addParamsLine("  [--maxshift <s=50>] : Max residual (px)")
        self.addParamsLine("  [--tiltmicsize <img_file=\"\">] : Tilt "
                           "micrograph (its dimensions bound the projected "
                           "untilted points, reference "
                           "image_assignment_tilt_pair.cpp:124)")
        self.addParamsLine("  [--tiltangle <s=-1>] : Tilt angle estimate; "
                           "candidate affines are gated to the "
                           "[tiltangle-15, tiltangle+15] deg area-"
                           "compression band (reference :332-369)")
        self.addParamsLine("  [--particlesize <p=100>] : Particle size (px)")
        self.addParamsLine("  [--threshold <d=0.3>] : Points closer than "
                           "threshold*particlesize count as the same point "
                           "(inlier tolerance)")
        self.addParamsLine("  [--no_delaunay]     : Skip the Delaunay RANSAC initialization")

    @staticmethod
    def _quads(P):
        """Canonical (a, b, r1, r2) quads of two Delaunay triangles that
        share the edge (a, b), and the barycentric coordinates of r2 in
        (a, b, r1): exact affine invariants."""
        from scipy.spatial import Delaunay
        dt = Delaunay(P)
        simp, nbr = dt.simplices, dt.neighbors

        def area(x, y, z):
            return 0.5 * ((P[y, 0] - P[x, 0]) * (P[z, 1] - P[x, 1])
                          - (P[z, 0] - P[x, 0]) * (P[y, 1] - P[x, 1]))
        pts, desc = [], []
        for i in range(len(simp)):
            for k in range(3):
                j = nbr[i, k]
                if j <= i:
                    continue
                shared = [v for v in simp[j] if v in simp[i]]
                if len(shared) != 2:
                    continue
                r1 = [v for v in simp[i] if v not in shared][0]
                r2 = [v for v in simp[j] if v not in shared][0]
                a, b = shared
                # canonical labels: bigger triangle first; edge order fixed
                # by positive orientation (tilt affines preserve it)
                if abs(area(a, b, r1)) < abs(area(a, b, r2)):
                    r1, r2 = r2, r1
                if area(a, b, r1) < 0:
                    a, b = b, a
                T = np.array([[P[a, 0], P[b, 0], P[r1, 0]],
                              [P[a, 1], P[b, 1], P[r1, 1]],
                              [1.0, 1.0, 1.0]])
                try:
                    lam = np.linalg.solve(T, np.array([P[r2, 0], P[r2, 1],
                                                       1.0]))
                except np.linalg.LinAlgError:
                    continue
                pts.append((a, b, r1, r2))
                desc.append(lam[:2])
        return np.array(pts, int), np.array(desc, float)

    @classmethod
    def _delaunay_ransac(cls, u, t, max_cands=300, tol=None, cos_band=None,
                         dims=None):
        """Initial affine from corresponding adjacent-triangle quads of the
        two Delaunay triangulations (the robust role of the reference's
        DCEL Delaunay matcher, external/delaunay + TiltPairAligner): quads
        matched by invariant distance, each candidate's 4-point affine
        scored by its nearest-neighbour inlier count."""
        from scipy.spatial import cKDTree
        qu, du = cls._quads(u)
        qt, dtt = cls._quads(t)
        if len(qu) == 0 or len(qt) == 0:
            return np.eye(2), t.mean(0) - u.mean(0)
        dist, jidx = cKDTree(dtt).query(du, k=1)
        tree = cKDTree(t)
        if tol is None:
            nn_d, _ = tree.query(t, k=2)
            tol = max(0.75 * np.median(nn_d[:, 1]), 4.0)
        best = (0, np.eye(2), t.mean(0) - u.mean(0))
        for o in np.argsort(dist)[:max_cands]:
            U = np.hstack([u[list(qu[o])], np.ones((4, 1))])
            M, *_ = np.linalg.lstsq(U, t[list(qt[jidx[o]])], rcond=None)
            A = M[:2].T
            if cos_band is not None:
                # tilt compresses areas by cos(tilt): gate det(A) to the
                # [cos(tilt+15), cos(tilt-15)] band (reference :332-369)
                det = abs(np.linalg.det(A))
                if not (cos_band[0] - 0.02 <= det <= cos_band[1] + 0.02):
                    continue
            proj = u @ A.T + M[2]
            ok = tree.query(proj, k=1)[0] < tol
            if dims is not None:
                # reject projections falling outside the tilt micrograph
                ok &= ((proj[:, 0] >= 0) & (proj[:, 0] <= dims[0])
                       & (proj[:, 1] >= 0) & (proj[:, 1] <= dims[1]))
            if int(ok.sum()) > best[0]:
                best = (int(ok.sum()), A, M[2])
        return best[1], best[2]

    def run(self):
        import os
        md_u = MetaData(self.getParam("--untiltcoor"))
        md_t = MetaData(self.getParam("--tiltcoor"))
        xy = lambda md: np.stack([md.getColumn("xcoor").astype(float),
                                  md.getColumn("ycoor").astype(float)],
                                 axis=1)
        u, t = xy(md_u), xy(md_t)
        # inlier tolerance = threshold * particlesize (reference readParams)
        psize = self.getDoubleParam("--particlesize") \
            if self.checkParam("--particlesize") else 0.0
        tol = self.getDoubleParam("--threshold") * psize if psize > 0 \
            else None
        tiltest = self.getDoubleParam("--tiltangle")
        cos_band = None
        if tiltest >= 0:
            cos_band = (np.cos(np.deg2rad(min(tiltest + 15.0, 89.0))),
                        np.cos(np.deg2rad(max(tiltest - 15.0, 0.0))))
        dims = None
        if self.getParam("--tiltmicsize"):
            hdr = Image()
            hdr.read(self.getParam("--tiltmicsize"), header_only=True)
            _, _, yd, xd = hdr.header.shape
            dims = (xd, yd)
        # Delaunay RANSAC initialization, then iterative mutual-NN affine
        if len(u) >= 4 and len(t) >= 4 and \
                not self.checkParam("--no_delaunay"):
            A, b = self._delaunay_ransac(u, t, tol=tol, cos_band=cos_band,
                                         dims=dims)
        else:
            A, b = np.eye(2), t.mean(axis=0) - u.mean(axis=0)
        pairs = []
        for _ in range(5):
            d = ((u @ A.T + b)[:, None] - t[None]) ** 2
            d = d.sum(-1)
            fwd, bwd = d.argmin(axis=1), d.argmin(axis=0)
            pairs = [(i, fwd[i]) for i in range(len(u)) if bwd[fwd[i]] == i]
            if len(pairs) < 3:
                break
            U = np.hstack([u[[p[0] for p in pairs]],
                           np.ones((len(pairs), 1))])
            M, *_ = np.linalg.lstsq(U, t[[p[1] for p in pairs]], rcond=None)
            A, b = M[:2].T, M[2]
        max_shift = self.getDoubleParam("--maxshift")
        if tol is not None:
            max_shift = min(max_shift, tol)
        proj = u @ A.T + b
        good = [(i, j) for i, j in pairs
                if np.linalg.norm(proj[i] - t[j]) <= max_shift]
        odir = self.getParam("--odir")
        for fn, P, k in (("untilted_assigned.xmd", u, 0),
                         ("tilted_assigned.xmd", t, 1)):
            MetaData.fromRows([
                {"itemId": n + 1, "xcoor": int(P[p[k], 0]),
                 "ycoor": int(P[p[k], 1])} for n, p in enumerate(good)]
            ).write(os.path.join(odir, fn))
        self.n_pairs = len(good)
        if self.verbose:
            print(f"Assigned {len(good)} tilt pairs")
