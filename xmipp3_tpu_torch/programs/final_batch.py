"""The programs of the reference package's programs/final_batch.py:
phantom_movie, image_peak_high_contrast, image_assignment_tilt_pair,
metadata_xml, metadata_split_3D, coordinates_noisy_zones_filter,
volumeset_align, pdb_analysis, pdb_label_from_volume,
pdb_reduce_pseudoatoms, pdb_sph_deform, compare_density,
ctf_correct_wiener3d and transform_adjust_volume_grey_levels.

On the card unless `--device cpu` is given: the noisy zones' windows and
variances, the alignments of volumeset_align (ProgVolumeAlign), the
nearest-neighbour distances of pdb_analysis and the k-means of
pdb_reduce_pseudoatoms (float64), compare_density's projections and
low-pass, the 3-D Wiener filters and FFTs (float64), and the grey-level
fit's projections and normal equations. The metadata programs, the PDB
text, the atoms' labels and the Zernike deformation of a model, and the
Otsu thresholds and connected components run on the host, as in the
reference.

image_peak_high_contrast's fiducial mode band-passes the tomogram's slices
and thresholds them on the card; the connected components (scipy), the
box filters and the simple mode's greedy peak loop run on the host, as in
the reference. image_assignment_tilt_pair is host geometry (scipy's
Delaunay triangulations and k-d trees, numpy least squares) in both
packages.

phantom_movie: the scene (ice and content) is drawn with numpy from
--seed exactly as the reference draws it, so both packages make the same
reference frame; the ice low-pass, the per-frame displacement and
bilinear resampling and the Poisson dose run on the card unless
`--device cpu` is given. The dose is drawn with a torch.Generator seeded
from --seed, so dosed frames match the reference's in distribution, not
value for value.
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


class ProgMetadataXML(XmippProgram):
    name = "xmipp_metadata_xml"

    def defineParams(self):
        self.addUsageLine("Export a picking metadata as particlepicking XML "
                          "(metadata_xml.cpp:56-120) or a generic table.")
        self.addParamsLine("   -i <md_file> : Input metadata")
        self.addParamsLine("   -o <xml>     : Output XML")
        self.addParamsLine("  [--extractParticlesMD] : Input comes from the ExtractParticles protocol (single block, micrograph column, disabled rows dropped)")
        self.addParamsLine("  [--root <name=metadata>] : Root element name (generic table mode)")

    @staticmethod
    def _coords(f, md):
        for i in md:
            r = md.getRow(i)
            x = int(float(r.get("xcoor", 0) or 0))
            y = int(float(r.get("ycoor", 0) or 0))
            f.write(f'<coordinate x="{x}" y="{y}"/>\n')

    def run(self):
        import os
        fn_in = self.getParam("-i")
        md = MetaData(fn_in)
        if self.checkParam("--extractParticlesMD"):
            # one extract_particles table: its rows grouped by micrograph
            md.removeDisabled()
            md.sort("micrograph")
            with open(self.getParam("-o"), "w") as f:
                f.write("<particlepicking>\n")
                cur = None
                for i in md:
                    r = md.getRow(i)
                    mic = os.path.splitext(os.path.basename(
                        str(r.get("micrograph", ""))))[0]
                    if mic != cur:
                        if cur is not None:
                            f.write("</micrograph>\n")
                        f.write(f'<micrograph id="{mic}">\n')
                        cur = mic
                    x = int(float(r.get("xcoor", 0) or 0))
                    y = int(float(r.get("ycoor", 0) or 0))
                    f.write(f'<coordinate x="{x}" y="{y}"/>\n')
                if cur is not None:
                    f.write("</micrograph>\n")
                f.write("</particlepicking>\n")
            return
        try:
            blocks = MetaData.blocksInFile(fn_in)
        except Exception:
            blocks = []
        if blocks and md.containsLabel("xcoor"):
            # one picking block a micrograph (the reference's default mode)
            with open(self.getParam("-o"), "w") as f:
                f.write("<particlepicking>\n")
                for b in blocks:
                    f.write(f'<micrograph id="{b.split("_", 1)[-1]}">\n')
                    self._coords(f, MetaData(f"{b}@{fn_in}"))
                    f.write("</micrograph>\n")
                f.write("</particlepicking>\n")
            return
        root = self.getParam("--root")
        with open(self.getParam("-o"), "w") as f:
            f.write("<?xml version='1.0' encoding='utf-8'?>\n")
            f.write(f"<{root}>\n")
            for i in md:
                f.write("  <ROW ")
                for k, v in md.getRow(i).items():
                    if isinstance(v, np.ndarray):
                        v = " ".join(f"{x:g}" for x in v)
                    f.write(f'{k}="{v}" ')
                f.write("/>\n")
            f.write(f"</{root}>\n")


class ProgMetadataSplit3D(XmippProgram):
    name = "xmipp_metadata_split_3d"

    def defineParams(self):
        self.addUsageLine("Split particles into correlates-well/-poorly "
                          "halves per projection direction "
                          "(metadata_split_3D.cpp:63-210): for each gallery "
                          "direction the neighbouring images are split at "
                          "their median maxCC and each imageIndex "
                          "accumulates +-1 votes.")
        self.addParamsLine("   -i <md_file> : Input with angles, imageIndex and maxCC")
        self.addParamsLine("  [--vol <volume=\"\">] : Reference volume (directions are generated from --sym/--angSampling; the volume itself is not reprojected)")
        self.addParamsLine("  [--oroot <root=split>] : Output rootname")
        self.addParamsLine("  [--sym <symmetry_file=c1>] : Symmetry")
        self.addParamsLine("  [--angSampling <a=5>] : Angular sampling (deg)")
        self.addParamsLine("  [--maxDist <a=10>] : Maximum angular distance (deg)")

    def run(self):
        from xmipp3_tpu_torch.core.sampling import (compute_sampling_points,
                                                    remove_redundant_points)
        from xmipp3_tpu_torch.core.sym import SymList
        md = MetaData(self.getParam("-i"))
        md.removeDisabled()
        rows = list(md.iterRows())
        root = self.getParam("--oroot") or "split"
        sym = self.getParam("--sym") if self.checkParam("--sym") else "c1"
        samp = (self.getDoubleParam("--angSampling")
                if self.checkParam("--angSampling") else 5.0)
        max_dist = np.deg2rad(self.getDoubleParam("--maxDist")
                              if self.checkParam("--maxDist") else 10.0)

        def direction(rot, tilt):
            r, t = np.deg2rad(rot), np.deg2rad(tilt)
            return np.array([np.cos(r) * np.sin(t),
                             np.sin(r) * np.sin(t), np.cos(t)])

        dirs_in = np.stack([
            direction(float(r.get("angleRot", 0) or 0),
                      float(r.get("angleTilt", 0) or 0)) for r in rows])
        refno = np.array([int(r.get("imageIndex", i) or i)
                          for i, r in enumerate(rows)])
        cc = np.array([float(r.get("maxCC", 0) or 0) for r in rows])
        gal = remove_redundant_points(compute_sampling_points(samp, 0.0, 90.0),
                                      SymList(sym))
        gal_dirs = np.stack([direction(a[0], a[1]) for a in gal])
        votes = np.zeros(int(refno.max()) + 1)
        cosmax = np.cos(max_dist)
        for gd in gal_dirs:
            near = (dirs_in @ gd) > cosmax
            if not near.any():
                continue
            # one vote per distinct imageIndex, at its best cc
            best: dict[int, float] = {}
            for k, c in zip(refno[near], cc[near]):
                if c > best.get(int(k), -np.inf):
                    best[int(k)] = float(c)
            vals = np.array(sorted(best.values()))
            med = vals[len(vals) // 2]
            for k, c in best.items():
                votes[k] += 1.0 if c > med else -1.0
        upper, lower = [], []
        for i, r in enumerate(rows):
            d = dict(r)
            d["cost"] = float(votes[refno[i]])
            if votes[refno[i]] > 0:
                upper.append(d)
            elif votes[refno[i]] < 0:
                lower.append(d)
        for suffix, part in (("_upper", upper), ("_lower", lower),
                             ("_1", upper), ("_2", lower)):
            MetaData.fromRows(part or [{"image": ""}]).write(
                root + suffix + ".xmd")


class ProgCoordinatesNoisyZonesFilter(XmippProgram):
    name = "xmipp_coordinates_noisy_zones_filter"

    def defineParams(self):
        self.addUsageLine("Remove picked coordinates that fall in noisy/"
                          "contaminated micrograph zones (local variance "
                          "screening).")
        self.addParamsLine("   --pos <md>  : Coordinates (xcoor/ycoor)")
        self.addParamsLine("   --mic <micrograph> : The micrograph")
        self.addParamsLine("   -o <md>     : Filtered coordinates")
        self.addParamsLine("  [--patchSize <p=64>] : Analysis window")
        self.addParamsLine("  [--zmax <z=3>] : Max allowed variance zScore")

    def run(self):
        dev = resolve_device(self.getParam("--device"))
        mic = as_tensor(np.squeeze(Image(self.getParam("--mic")).data)
                        .astype(np.float32), dev)
        rows = list(MetaData(self.getParam("--pos")).iterRows())
        p = self.getIntParam("--patchSize")
        H, W = mic.shape
        x0 = np.clip([int(r["xcoor"]) - p // 2 for r in rows], 0, W - p)
        y0 = np.clip([int(r["ycoor"]) - p // 2 for r in rows], 0, H - p)
        # every window in one gather: (n, p, p)
        ar = torch.arange(p, device=dev)
        yy = torch.as_tensor(y0, device=dev)[:, None] + ar
        xx = torch.as_tensor(x0, device=dev)[:, None] + ar
        win = mic[yy[:, :, None], xx[:, None, :]].double()
        v = win.var(dim=(1, 2), unbiased=False).cpu().numpy()
        med = np.median(v)
        z = np.abs(v - med) / max(1.4826 * np.median(np.abs(v - med)), 1e-12)
        keep = [r for r, zz in zip(rows, z)
                if zz <= self.getDoubleParam("--zmax")]
        MetaData.fromRows(keep).write(self.getParam("-o"))
        self.n_kept = len(keep)


class ProgVolumesetAlign(XmippProgram):
    name = "xmipp_volumeset_align"

    def defineParams(self):
        self.addUsageLine("Align every volume of a set to a reference "
                          "volume (volumeset_align.cpp:40-49 surface).")
        self.addParamsLine("   -i <md_file> : Metadata with volumes (image column)")
        self.addParamsLine("   --ref <volume> : Reference")
        self.addParamsLine("  [-o <md_file=\"\">] : Output with alignment "
                           "angles (default <odir>/volumeset_align.xmd)")
        self.addParamsLine("  [--odir <dir=.>] : Output directory")
        self.addParamsLine("  [--resume] : Skip volumes already present in "
                           "the output metadata")
        self.addParamsLine("  [--step <s=30>] : Coarse angular step")
        self.addParamsLine("  [--frm <L=24>]  : Use SO(3) Fast Rotational "
                           "Matching instead of the grid")
        self.addParamsLine("  [--frm_parameters <freq=0.25> <shift=10>] : "
                           "FRM alignment with this max frequency and "
                           "shift bound")
        self.addParamsLine("  [--tilt_values <t0=-90> <tF=90>] : Missing-"
                           "wedge compensation range for the FRM scoring")
        self.addParamsLine("  [--mask <type=\"\"> <r=0>] : Mask applied "
                           "during the alignment (circular <r> or a file)")

    def run(self):
        import os
        from xmipp3_tpu_torch.programs.volume_programs import ProgVolumeAlign
        md = MetaData(self.getParam("-i"))
        fn_out = (self.getParam("-o")
                  if self.checkParam("-o") and self.getParam("-o")
                  else os.path.join(self.getParam("--odir"),
                                    "volumeset_align.xmd"))
        done = set()
        rows = []
        if self.checkParam("--resume") and os.path.exists(fn_out):
            for r in MetaData(fn_out).iterRows():
                done.add(str(r["image"]))
                rows.append(dict(r))
        for i in md:
            r = md.getRow(i)
            if str(r["image"]) in done:
                continue
            sub = ProgVolumeAlign()
            args = [sub.name, "--i1", self.getParam("--ref"),
                    "--i2", str(r["image"]), "--step", self.getParam("--step"),
                    "--device", self.getParam("--device")]
            if self.checkParam("--frm_parameters"):
                args += ["--frm", *(self.getParam("--frm_parameters", k)
                                    for k in (0, 1)),
                         *(self.getParam("--tilt_values", k)
                           for k in (0, 1))]
            elif self.checkParam("--frm"):
                args += ["--frm", self.getParam("--frm")]
            if self.checkParam("--mask"):
                args += ["--mask", self.getParam("--mask", 0),
                         self.getParam("--mask", 1)]
            sub.read(args)
            sub.verbose = 0
            sub.run()
            r["angleRot"], r["angleTilt"], r["anglePsi"] = sub.angles
            r["maxCC"] = sub.corr
            rows.append(r)
            MetaData.fromRows(rows).write(fn_out)   # checkpoint (--resume)
        MetaData.fromRows(rows).write(fn_out)


class ProgPDBAnalysis(XmippProgram):
    name = "xmipp_pdb_analysis"

    def defineParams(self):
        self.addUsageLine("Report geometric statistics of an atomic model.")
        self.addParamsLine("   -i <pdb> : Input model")
        self.addParamsLine("  [--operation <op=stats>] : Operation to perform")
        self.addParamsLine("    where <op>")
        self.addParamsLine("      stats : Print geometric statistics")
        self.addParamsLine("      distance_histogram <fileOut> <Nnearest=3> <MaxDistance=-1> : Histogram of distances between each atom and its N nearest neighbours (pdb_analysis.cpp:35-39)")

    def run(self):
        from collections import Counter
        from xmipp3_tpu_torch.core.pdb import read_pdb
        m = read_pdb(self.getParam("-i"))
        c = m.coords
        if self.checkParam("--operation") and \
                self.getParam("--operation") == "distance_histogram":
            dev = resolve_device(self.getParam("--device"))
            n_near = self.getIntParam("--operation", 2)
            max_d = self.getDoubleParam("--operation", 3)
            # the N nearest distances of every atom, on the card (float64)
            t = torch.as_tensor(np.asarray(c, np.float64), device=dev)
            d = torch.cdist(t, t, compute_mode="donot_use_mm_for_euclid_dist")
            d.fill_diagonal_(float("inf"))
            k = min(n_near, len(c) - 1)
            nearest = torch.topk(d, k, dim=1, largest=False).values \
                .cpu().numpy().ravel()
            if max_d > 0:
                nearest = nearest[nearest <= max_d]
            counts, edges = np.histogram(nearest, bins=200)
            centers = 0.5 * (edges[:-1] + edges[1:])
            with open(self.getParam("--operation", 1), "w") as f:
                for x, v in zip(centers, counts):
                    f.write(f"{x:12.6f} {v}\n")
            self.hist = (centers, counts)
            return
        center = c.mean(axis=0)
        extent = c.max(axis=0) - c.min(axis=0)
        rg = float(np.sqrt(((c - center) ** 2).sum(axis=1).mean()))
        comp = Counter(e.upper() for e in m.elements)
        print(f"Atoms: {len(m)}")
        print(f"Center of mass: {np.round(center, 2)}")
        print(f"Extent (Å): {np.round(extent, 2)}")
        print(f"Radius of gyration: {rg:.2f} Å")
        print("Composition: " + " ".join(f"{k}:{v}"
                                         for k, v in sorted(comp.items())))
        self.radius_of_gyration = rg


class ProgPDBLabelFromVolume(XmippProgram):
    """Full reference surface (pdb_label_from_volume.cpp:36-238
    ProgPdbValueToVol): per atom, average the volume values within
    --radius of the atom position (always including the atom's own
    voxel), restricted to --mask when given; occupancy = sign(signed
    mean) * absolute mean; --md records the global mean and absolute
    mean (MDL_VOLUME_SCORE1/2); --origin shifts the voxel indexing
    (indices run from 0 unless --origin x y z is given). Host numpy, as
    in the reference: a few voxels an atom."""
    name = "xmipp_pdb_label_from_volume"

    def defineParams(self):
        self.addUsageLine("Put volume values (e.g. local resolution) on "
                          "the atoms of a PDB.")
        self.addParamsLine("   --pdb <file> : File to process")
        self.addParamsLine("   --vol <volume> : Input volume")
        self.addParamsLine("  [--mask <vol=\"\">] : Input mask (average "
                           "only inside the mask)")
        self.addParamsLine("   -o <file>    : Modified output PDB")
        self.addParamsLine("  [--sampling <Ts=1>] : Pixel size (A/px)")
        self.addParamsLine("  [--origin <x=0> <y=0> <z=0>] : Volume origin "
                           "(voxels); without it indices start at 0")
        self.addParamsLine("  [--radius <radius=0.8>] : Radius of the atom "
                           "(A)")
        self.addParamsLine("  [--md <output=params.xmd>] : Save mean and "
                           "absolute mean of the atom values")

    def run(self):
        from xmipp3_tpu_torch.core.pdb import AtomicModel, read_pdb, write_pdb
        m = read_pdb(self.getParam("--pdb"))
        vol = np.squeeze(Image(self.getParam("--vol")).data
                         ).astype(np.float64)
        mask = None
        if self.checkParam("--mask") and self.getParam("--mask"):
            mask = np.squeeze(Image(self.getParam("--mask")).data) > 1e-5
        Ts = self.getDoubleParam("--sampling")
        radius = self.getDoubleParam("--radius")
        orig = np.zeros(3)
        if self.checkParam("--origin"):
            orig = np.array([self.getDoubleParam("--origin", k)
                             for k in range(3)])
        D, H, W = vol.shape
        vox = m.coords / Ts + orig[None, :]          # (N, 3) x, y, z
        r2 = radius * radius
        vals = np.zeros(len(m), np.float64)
        absvals = np.zeros(len(m), np.float64)
        for a, (x, y, z) in enumerate(vox):
            k0, kF = max(int(np.floor(z - radius)), 0), \
                min(int(np.ceil(z + radius)), D - 1)
            i0, iF = max(int(np.floor(y - radius)), 0), \
                min(int(np.ceil(y + radius)), H - 1)
            j0, jF = max(int(np.floor(x - radius)), 0), \
                min(int(np.ceil(x + radius)), W - 1)
            if k0 > kF or i0 > iF or j0 > jF:
                continue
            kk, ii, jj = np.mgrid[k0:kF + 1, i0:iF + 1, j0:jF + 1]
            sel = (z - kk) ** 2 + (y - ii) ** 2 + (x - jj) ** 2 < r2
            # the atom's own (floor) voxel always counts
            ka, ia, ja = (max(int(np.floor(z)), 0), max(int(np.floor(y)), 0),
                          max(int(np.floor(x)), 0))
            sel |= (kk == ka) & (ii == ia) & (jj == ja)
            if mask is not None:
                sel &= mask[kk, ii, jj]
            if not sel.any():
                continue
            v = vol[kk[sel], ii[sel], jj[sel]]
            absvals[a] = np.abs(v).mean()
            vals[a] = (1.0 if v.mean() >= 0 else -1.0) * absvals[a]
        mean = float(vals.mean()) if len(m) else 0.0
        mean_abs = float(absvals.mean()) if len(m) else 0.0
        if self.verbose:
            print(f"mean value: = {mean}")
            print(f"absolute mean value: = {mean_abs}")
        MetaData.fromRows([{"scoreVolume1": mean,
                            "scoreVolume2": mean_abs}]).write(
            self.getParam("--md") if self.checkParam("--md")
            else "params.xmd")
        write_pdb(self.getParam("-o"),
                  AtomicModel(m.coords, m.elements, m.bfactors,
                              vals.astype(np.float32)))
        self.mean, self.mean_abs = mean, mean_abs


class ProgPDBReducePseudoatoms(XmippProgram):
    name = "xmipp_pdb_reduce_pseudoatoms"

    def defineParams(self):
        self.addUsageLine("Reduce a pseudoatom model: keep the strongest "
                          "atoms by intensity (pdb_reduce_pseudoatoms.cpp:"
                          "43-46) or cluster to --num centers (k-means).")
        self.addParamsLine("   -i <pdb>  : Input model")
        self.addParamsLine("   -o <pdb>  : Reduced model")
        self.addParamsLine("  [--number <num=-1>] : Keep this many pseudoatoms with highest intensity")
        self.addParamsLine("  [--threshold <thresh=0.0>] : Remove pseudoatoms below this intensity")
        self.addParamsLine("  [--num <n=100>] : Target pseudoatom count (k-means clustering mode)")

    def run(self):
        from xmipp3_tpu_torch.core.pdb import AtomicModel, read_pdb, write_pdb
        m = read_pdb(self.getParam("-i"))
        if self.checkParam("--number") or self.checkParam("--threshold"):
            # the reference's intensity (occupancy) selection
            inten = np.asarray(m.occupancies, np.float64)
            keep = np.ones(len(m), bool)
            if self.checkParam("--threshold"):
                keep &= inten >= self.getDoubleParam("--threshold")
            if self.checkParam("--number"):
                num = self.getIntParam("--number")
                if 0 < num < int(keep.sum()):
                    chosen = [i for i in np.argsort(-inten) if keep[i]][:num]
                    keep = np.zeros(len(m), bool)
                    keep[chosen] = True
            sel = np.where(keep)[0]
            write_pdb(self.getParam("-o"), AtomicModel(
                m.coords[sel], [m.elements[i] for i in sel],
                np.asarray(m.bfactors)[sel], np.asarray(m.occupancies)[sel]))
            return
        # weighted k-means of the atoms on the card (float64), its start
        # drawn by the reference's Generator
        dev = resolve_device(self.getParam("--device"))
        n = min(self.getIntParam("--num"), len(m))
        rng = np.random.default_rng(0)
        X = torch.as_tensor(np.asarray(m.coords, np.float64), device=dev)
        w = torch.as_tensor(m.weights, dtype=torch.float64, device=dev)
        C = X[torch.as_tensor(rng.choice(len(m), n, replace=False),
                              device=dev)].clone()
        for _ in range(20):
            assign = ((X[:, None] - C[None]) ** 2).sum(-1).argmin(dim=1)
            wsum = torch.zeros(n, dtype=torch.float64, device=dev) \
                .index_add_(0, assign, w)
            acc = torch.zeros_like(C).index_add_(0, assign, X * w[:, None])
            hit = wsum > 0
            C[hit] = acc[hit] / wsum[hit, None]
        write_pdb(self.getParam("-o"), AtomicModel(
            C.cpu().numpy(), ["C"] * n, np.zeros(n, np.float32),
            np.ones(n, np.float32)))


class ProgPDBSphDeform(XmippProgram):
    name = "xmipp_pdb_sph_deform"

    def defineParams(self):
        self.addUsageLine("Deform an atomic model with Zernike3D "
                          "coefficients.")
        self.addParamsLine("   --pdb <file> : Input model")
        self.addParamsLine("   -o <file>    : Deformed model")
        self.addParamsLine("   --clnm <md>  : Metadata with sphCoefficients")
        self.addParamsLine("  [--l1 <l=3>] : Zernike radial depth")
        self.addParamsLine("  [--l2 <l=2>] : Spherical harmonic depth")
        self.addParamsLine("  [--radius <r=-1>] : Normalization radius (Å)")
        self.addParamsLine("  [--center_mass] : Center the PDB at its center of mass first")
        self.addParamsLine("  [--boxsize <b=0>] : Box size (px) of the volume the coefficients were fitted in")
        self.addParamsLine("  [--sr <s=1>] : Sampling rate (Å/px) of that volume")

    def run(self):
        from xmipp3_tpu_torch.core.pdb import AtomicModel, read_pdb, write_pdb
        from xmipp3_tpu_torch.ops.zernike import (real_sph_harm,
                                                  zernike_indices,
                                                  zernike_radial)
        m = read_pdb(self.getParam("--pdb"))
        if self.checkParam("--center_mass"):
            m = m.centered()
        md = MetaData(self.getParam("--clnm"))
        coeffs = np.asarray(md.getValue("sphCoefficients", md.firstObject()),
                            np.float64).reshape(3, -1)
        radius = self.getDoubleParam("--radius")
        boxsize = (self.getIntParam("--boxsize")
                   if self.checkParam("--boxsize") else 0)
        sr = self.getDoubleParam("--sr") if self.checkParam("--sr") else 1.0
        if radius <= 0 and boxsize > 0:
            # the fitting volume's normalisation radius in A
            # (pdb_sph_deform.cpp:36-38)
            radius = 0.5 * boxsize * sr
        if radius <= 0:
            radius = np.linalg.norm(m.coords, axis=1).max() + 1e-6
        r = np.linalg.norm(m.coords, axis=1) / radius
        rs = np.where(r > 0, r, 1e-9)
        theta = np.arccos(np.clip(m.coords[:, 2] / (rs * radius), -1, 1))
        phi = np.arctan2(m.coords[:, 1], m.coords[:, 0])
        idx = zernike_indices(self.getIntParam("--l1"),
                              self.getIntParam("--l2"))
        disp = np.zeros_like(m.coords)
        for k, (l, n, mm) in enumerate(idx[: coeffs.shape[1]]):
            B = zernike_radial(n, l, r) * real_sph_harm(l, mm, theta, phi)
            B = np.where(r <= 1.0, B, 0.0)
            for c in range(3):
                disp[:, c] += coeffs[c, k] * B
        write_pdb(self.getParam("-o"), AtomicModel(
            m.coords + disp, m.elements, m.bfactors, m.occupancies))


class ProgCompareDensity(XmippProgram):
    """Full reference surface (compare_density.cpp:119-126): -v1/-v2,
    --degstep grid; for each (rot, tilt) cell project both volumes,
    low-pass filter (w1=1/12, raised 0.02), Otsu-binarize, subtract the
    biggest connected component, and record the SIGN of the residual
    pixel-wise density difference (+1 where v1's residual mass dominates,
    -1 where v2's does, 0 when equal). The projections and the filter run
    on the card, the whole grid in one batch; the thresholds and the
    connected components (scipy.ndimage.label) on the host, as in the
    reference."""
    name = "xmipp_compare_density"

    def defineParams(self):
        self.addUsageLine("Compare the segmented densities of two volumes "
                          "over a (rot, tilt) projection grid.")
        self.addParamsLine("   -v1 <volume>  : First volume to compare")
        self.addParamsLine("   -v2 <volume>  : Second volume to compare")
        self.addParamsLine("  [-o <image=\"\">] : Output correlation image")
        self.addParamsLine("  [--degstep <d=5.0>] : Degrees step size for "
                           "rot and tilt angles")
        self.addParamsLine("  [--thr <N=-1>] : Max processing threads "
                           "(device batching replaces the thread pool)")

    def run(self):
        from scipy import ndimage
        from xmipp3_tpu_torch.core.funcs import otsu_threshold
        from xmipp3_tpu_torch.ops.fourier_filter import (
            apply_fourier_mask_2d, low_pass_mask)
        from xmipp3_tpu_torch.programs.angular_misc import \
            project_both_on_grid
        dev = resolve_device(self.getParam("--device"))
        with timed_phase("project_filter"):
            p1, p2, n_rot, n_tilt = project_both_on_grid(
                self.getParam("-v1"), self.getParam("-v2"),
                self.getDoubleParam("--degstep"), device=dev)
            mask = low_pass_mask(*p1.shape[-2:], 1.0 / 12.0, raised_w=0.02)
            p1 = apply_fourier_mask_2d(p1, mask).cpu().numpy()
            p2 = apply_fourier_mask_2d(p2, mask).cpu().numpy()
        corr = np.zeros(len(p1), np.float32)
        with timed_phase("segment"):
            for i in range(len(p1)):
                b1 = (p1[i] > otsu_threshold(p1[i])).astype(np.float64)
                b2 = (p2[i] > otsu_threshold(p2[i])).astype(np.float64)
                for b in (b1, b2):
                    lab, n = ndimage.label(b)
                    if n > 0:
                        sizes = ndimage.sum(b, lab, range(1, n + 1))
                        b -= (lab == (1 + int(np.argmax(sizes))))
                corr[i] = np.sign(np.sign(b1 - b2).sum())
        cc = corr.reshape(n_rot, n_tilt)
        save_image(self.getParam("-o") or "Rot_tilt_corr_map.xmp", cc)
        self.corr_image = cc
        if self.verbose:
            print(f"fraction of differing views: {(cc != 0).mean():.3f}")


class ProgCTFCorrectWiener3D(XmippProgram):
    """3-D Wiener deconvolution of defocus-group volumes on the card: the
    radial CTFs, the shared Wiener denominator, the volumes' FFTs and the
    refiltered groups in float64."""
    name = "xmipp_ctf_correct_wiener3d"

    def defineParams(self):
        self.addUsageLine("3D Wiener deconvolution of defocus-group volumes "
                          "(ctf_correct_wiener3d.cpp:61-69): combines the "
                          "group volumes with image-count-weighted Wiener "
                          "filters and writes the per-group refiltered "
                          "volumes.")
        self.addParamsLine("   -i <input>  : Metadata with _image (group volume), _CTFModel and _class_count columns, or a single volume")
        self.addParamsLine("  [--oroot <root=wiener3d>] : Output rootname (root_deconvolved.vol + root_ctffiltered_groupNN.vol)")
        self.addParamsLine("  [--minFreq <Ang=-1>] : Apply the Wiener filter only beyond this resolution (A)")
        self.addParamsLine("  [--phase_flipped] : Volumes were reconstructed from phase-corrected images")
        self.addParamsLine("  [--wienerConstant <K=0.05>] : Wiener constant (multiplied by the total image count)")
        self.addParamsLine("  [--ctf <ctfparam=\"\">] : Representative CTF (single-volume mode)")
        self.addParamsLine("  [-o <out=\"\">] : Output (single-volume mode)")
        self.addParamsLine("  [--sampling <Ts=0>] : Override pixel size")
        self.addParamsLine("  [--wc <w=0.05>] : Wiener constant (single-volume mode)")

    @staticmethod
    def _radial_ctf(ctf, shape, phase_flipped, dev):
        """The CTF at each rfftn frequency's radius (float32, as the
        reference evaluates it) as float64, and the radius (1/A)."""
        from xmipp3_tpu_torch.ops.fourier import freq_grid_3d
        fz, fy, fx = freq_grid_3d(*shape)
        r = np.sqrt(fz ** 2 + fy ** 2 + fx ** 2) / np.float32(
            ctf.sampling_rate)
        r = torch.as_tensor(r, device=dev)
        c = ctf.pure_at(r, torch.zeros_like(r)).double()
        return (c.abs() if phase_flipped else c), r.double()

    def run(self):
        from xmipp3_tpu_torch.core.metadata_program import is_metadata_file
        from xmipp3_tpu_torch.ops.ctf import CTFDescription
        dev = resolve_device(self.getParam("--device"))
        fn_in = self.getParam("-i")
        Ts = self.getDoubleParam("--sampling")
        flipped = self.checkParam("--phase_flipped")
        rfft = lambda v: torch.fft.rfftn(v)
        irfft = lambda f, s: torch.fft.irfftn(f, s=s).cpu().numpy() \
            .astype(np.float32)
        if is_metadata_file(fn_in):
            root = (self.getParam("--oroot")
                    if self.checkParam("--oroot") else "wiener3d")
            K = self.getDoubleParam("--wienerConstant")
            min_freq = self.getDoubleParam("--minFreq")
            vols, ctfs, counts = [], [], []
            for r in MetaData(fn_in).iterRows():
                vols.append(torch.as_tensor(np.squeeze(
                    Image(str(r["image"])).data).astype(np.float64),
                    device=dev))
                ctf = CTFDescription.from_metadata(str(r["ctfModel"]))
                if Ts > 0:
                    ctf.sampling_rate = Ts
                ctfs.append(ctf)
                counts.append(float(r.get("classCount", 1) or 1))
            shape = tuple(vols[0].shape)
            cs = []
            for ctf in ctfs:
                c, freq = self._radial_ctf(ctf, shape, flipped, dev)
                if min_freq > 0:
                    # below the resolution limit the CTF is 1 inside the
                    # shared denominator (generateCTF1D), so the weights
                    # change continuously: w = n / (K Ntot + sum n_g)
                    c = torch.where(freq < 1.0 / min_freq, 1.0, c)
                cs.append(c)
            denom = K * sum(counts) + sum(n * c * c
                                          for n, c in zip(counts, cs))
            num = sum(rfft(v) * (n * c / denom)
                      for n, c, v in zip(counts, cs, vols))
            dec = torch.fft.irfftn(num, s=shape)
            save_image(root + "_deconvolved.vol",
                       dec.cpu().numpy().astype(np.float32))
            fdec = rfft(dec)
            for g, c in enumerate(cs, start=1):
                save_image(f"{root}_ctffiltered_group{g:02d}.vol",
                           irfft(fdec * c, shape))
            return
        # single-volume mode
        vol = np.squeeze(Image(fn_in).data).astype(np.float32)
        ctf = CTFDescription.from_metadata(self.getParam("--ctf"))
        if Ts > 0:
            ctf.sampling_rate = Ts
        c, _ = self._radial_ctf(ctf, vol.shape, flipped, dev)
        c = c.float()
        wien = (c / (c * c + np.float32(self.getDoubleParam("--wc")))).double()
        out = irfft(rfft(torch.as_tensor(vol, device=dev).double()) * wien,
                    vol.shape)
        save_image(self.getParam("-o") or "wiener3d.vol", out)


class ProgAdjustVolumeGreyLevels(XmippProgram):
    """Full reference surface (adjust_volume_grey_levels.cpp:40-236):
    adjust the volume's grey range so its projections match a set of
    experimental projections (-m): first guess a = stddevF/stddev0,
    b = avgF - a*avg0 with avgF = avg_pict/r, stddevF = stddev_pict/
    sqrt(r), r = cbrt(#voxels); --optimize refines (a, b) on the
    projection-mismatch cost over a random image subset (--probb_eval
    selection probability). proj(a*V + b) = a*proj(V) + b*proj(1), so one
    batched projection of V and of the unit volume on the card turns the
    reference's per-evaluation reprojection into a closed-form 2x2 least
    squares. -r adjusts against a reference volume directly."""
    name = "xmipp_transform_adjust_volume_grey_levels"

    def defineParams(self):
        self.addUsageLine("Adjust the grey level range of a volume to "
                          "its experimental projections.")
        self.addParamsLine("   -i <volume>  : Volume to adjust")
        self.addParamsLine("  [-m <metadata=\"\">] : Set of projections of "
                           "the volume (with angles)")
        self.addParamsLine("   alias --metadata;")
        self.addParamsLine("  [-r <volume=\"\">]  : Reference volume "
                           "(direct voxel least-squares mode)")
        self.addParamsLine("  [-o <out=\"\">] : Output (default in-place)")
        self.addParamsLine("  [--optimize] : Refine the linear transform "
                           "on the projection-mismatch cost")
        self.addParamsLine("  [--probb_eval <p=0.2>] : Probability of "
                           "each image entering the goal function")
        self.addParamsLine("  [--seed <s=0>] : Random subset seed")

    def run(self):
        dev = resolve_device(self.getParam("--device"))
        v = np.squeeze(Image(self.getParam("-i")).data).astype(np.float32)
        fn_out = self.getParam("-o") or self.getParam("-i")
        if self.checkParam("-r") and self.getParam("-r"):
            ref = np.squeeze(Image(self.getParam("-r")).data
                             ).astype(np.float32)
            A = np.stack([v.ravel(), np.ones(v.size, np.float32)], axis=1)
            coef, *_ = np.linalg.lstsq(A, ref.ravel(), rcond=None)
            save_image(fn_out, coef[0] * v + coef[1])
            return
        from xmipp3_tpu_torch.core.metadata_program import load_image_rows
        rows = list(MetaData(self.getParam("-m")).iterRows())
        imgs = load_image_rows(rows)
        # first estimate (the reference's apply()): ray statistics
        avg_pict = float(np.mean([i.mean() for i in imgs]))
        stddev_pict = float(np.sqrt(np.mean([i.std() ** 2 for i in imgs])))
        r = v.size ** (1.0 / 3.0)
        avgF = avg_pict / r
        stddevF = stddev_pict / np.sqrt(r)
        avg0, stddev0 = float(v.mean()), float(max(v.std(), 1e-12))
        a = stddevF / stddev0
        b = avgF - a * avg0
        if self.verbose:
            print(f"First Linear transformation: y={a}*x+{b}")
        if self.checkParam("--optimize"):
            from xmipp3_tpu_torch.ops.project import project_real_space
            rng = np.random.default_rng(
                self.getIntParam("--seed") if self.checkParam("--seed")
                else 0)
            p = self.getDoubleParam("--probb_eval") \
                if self.checkParam("--probb_eval") else 0.2
            sel = rng.uniform(0, 1, len(rows)) <= p
            if not sel.any():
                sel[rng.integers(len(rows))] = True
            idx = np.nonzero(sel)[0]
            ang = {k: np.array([float(rows[i].get(k, 0.0)) for i in idx],
                               np.float32)
                   for k in ("angleRot", "angleTilt", "anglePsi")}
            with timed_phase("project"):
                P, T = (project_real_space(
                    x, ang["angleRot"], ang["angleTilt"], ang["anglePsi"],
                    device=dev).double() for x in (v, np.ones_like(v)))
            I = torch.as_tensor(imgs[idx], device=dev).double()
            # normal equations of min ||I - aP - bT||^2
            M = torch.stack([torch.stack([(P * P).sum(), (P * T).sum()]),
                             torch.stack([(P * T).sum(), (T * T).sum()])]) \
                .cpu().numpy()
            rhs = torch.stack([(P * I).sum(), (T * I).sum()]).cpu().numpy()
            try:
                a, b = np.linalg.solve(M, rhs)
            except np.linalg.LinAlgError:
                pass
            if self.verbose:
                print(f"Optimized transformation: y={a}*x+{b}")
        save_image(fn_out, (a * v + b).astype(np.float32))
        self.ab = (float(a), float(b))
