"""Tilt-series alignment quality of the reference package's
programs/tomo_landmark_residuals.py: xmipp_tomo_calculate_landmark_residuals,
xmipp_tomo_detect_misalignment_residuals and
xmipp_tomo_extract_particlestacks (reference
tomo_calculate_landmark_residuals.{h,cpp},
tomo_detect_misalignment_residuals.{h,cpp},
tomo_extract_particlestacks.{h,cpp}).

The directional enhancement of the series and the particle patches'
contrast and normalisation run on the card unless `--device cpu` is
given. The reprojection of the landmarks (one host product), the window
search around each reprojection, the Mahalanobis statistics and the
metadata stay on the host, as in the reference.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from xmipp3_tpu_torch.core.image import save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import resolve_device
from xmipp3_tpu_torch.programs.tomo_misc import _load_ts


def project_landmarks(coords3d, tilts_deg, shape_xy, swap_xy=False):
    """Reproject centered 3D landmark coordinates into each tilt image.

    Single-axis (y-axis) tilt geometry: x' = x cos(t) + z sin(t), y' = y,
    with image coordinates offset so the volume center maps to the image
    center (reference tomo_calculate_landmark_residuals.cpp projection
    model). coords3d: (L, 3) with X/Y centered-positive convention and Z
    centered. Returns (L, T, 2) array of (x, y) pixel positions."""
    X, Y = shape_xy
    c = np.asarray(coords3d, np.float64)
    t = np.deg2rad(np.asarray(tilts_deg, np.float64))[None, :]
    xc, yc, zc = c[:, 0:1] - X / 2.0, c[:, 1:2] - Y / 2.0, c[:, 2:3]
    if swap_xy:
        xc, yc = yc, xc
    xproj = xc * np.cos(t) + zc * np.sin(t) + X / 2.0
    yproj = np.broadcast_to(yc, xproj.shape) + Y / 2.0
    return np.stack([xproj, yproj], axis=-1)


def _coords(md):
    return np.stack([np.asarray(md.getColumn(k), np.float64)
                     for k in ("xcoor", "ycoor", "zcoor")], axis=1)


class ProgTomoCalculateLandmarkResiduals(XmippProgram):
    name = "xmipp_tomo_calculate_landmark_residuals"

    def defineParams(self):
        self.addUsageLine("Calculate residual vectors between detected "
                          "landmarks and reprojected 3D coordinates over a "
                          "tilt series.")
        self.addParamsLine("   -i <ts>            : Tilt series (stack or metadata)")
        self.addParamsLine("   --tlt <tlt_file>   : Tilt angles (.tlt text or .xmd)")
        self.addParamsLine("   --inputCoord <md>  : 3D landmark coordinates (xcoor/ycoor/zcoor)")
        self.addParamsLine("  [-o <md=alignmentReport.xmd>] : Output residual report")
        self.addParamsLine("  [--samplingRate <s=1>]  : Sampling rate (A/px)")
        self.addParamsLine("  [--fiducialSize <f=100>] : Fiducial size (A)")
        self.addParamsLine("  [--thrSDHCC <t=5>] : SDs over the mean for a "
                           "window peak to count as a high-contrast feature")
        self.addParamsLine("  [--targetLMsize <t=8>] : Target landmark size "
                           "(px) for the directional enhancement scale")
        self.addParamsLine("  [--numberFTdirOfDirections <n=8>] : Fourier "
                           "directional-filter cone count")
        self.addParamsLine("  [--swapXY]          : Tomogram X/Y axes swapped vs tilt series")

    def run(self):
        from xmipp3_tpu_torch.ops.tomo_landmarks import directional_enhance
        self.refuse_unread("--targetLMsize", item=24)
        dev = resolve_device(self.getParam("--device"))
        imgs, _ = _load_ts(self.getParam("-i"))
        fn_tlt = self.getParam("--tlt")
        if fn_tlt.endswith(".xmd"):
            tmd = MetaData(fn_tlt)
            tilts = np.asarray(tmd.getColumn(
                "tiltAngle" if tmd.containsLabel("tiltAngle")
                else "angleTilt"), np.float64)
        else:
            tilts = np.loadtxt(fn_tlt, ndmin=1).astype(np.float64)
        T, H, W = imgs.shape
        tilts = tilts[:T]
        fid_px = max(int(round(self.getDoubleParam("--fiducialSize")
                               / max(self.getDoubleParam("--samplingRate"),
                                     1e-6))), 4)
        coords = _coords(MetaData(self.getParam("--inputCoord")))
        proj = project_landmarks(coords, tilts, (W, H),
                                 swap_xy=self.checkParam("--swapXY"))
        thr_sd = self.getDoubleParam("--thrSDHCC")
        # the series directionally enhanced at the fiducial size (full
        # resolution) drives the high-contrast gate
        with timed_phase("enhance"):
            x = torch.as_tensor(imgs, device=dev)
            enh = directional_enhance(
                -(x - x.mean(dim=(1, 2), keepdim=True)), float(fid_px),
                self.getIntParam("--numberFTdirOfDirections")).cpu().numpy()
        # robust per-frame background stats (median/MAD): the sparse
        # fiducials would inflate a plain stddev and defeat the gate
        enh_mu = np.median(enh, axis=(1, 2))
        enh_sd = 1.4826 * np.median(
            np.abs(enh - enh_mu[:, None, None]), axis=(1, 2)) + 1e-12

        # observed landmark = darkest-blob centroid in a search window around
        # the reprojection (fiducials are high-contrast dark features)
        half = max(fid_px, 6)
        rows = []
        for li in range(coords.shape[0]):
            for ti in range(T):
                px, py = proj[li, ti]
                x0, y0 = int(round(px)) - half, int(round(py)) - half
                if not (0 <= x0 and x0 + 2 * half < W and 0 <= y0
                        and y0 + 2 * half < H):
                    continue
                win = imgs[ti, y0:y0 + 2 * half, x0:x0 + 2 * half]
                resp = win.mean() - win          # dark blobs -> positive
                # peak first, then centroid in a tight neighborhood: a plain
                # window centroid gets pulled by neighboring fiducials
                peak = np.unravel_index(np.argmax(resp), resp.shape)
                rad = max(half // 2, 2)
                wy0 = max(peak[0] - rad, 0)
                wx0 = max(peak[1] - rad, 0)
                sub = resp[wy0:peak[0] + rad + 1, wx0:peak[1] + rad + 1]
                sub = np.clip(sub - sub.mean(), 0, None)
                tot = sub.sum()
                # high-contrast gate: the directional response at the peak
                # must clear thrSDHCC SDs over the frame mean
                ewin = enh[ti, y0:y0 + 2 * half, x0:x0 + 2 * half]
                hc = ewin.max() > enh_mu[ti] + thr_sd * enh_sd[ti]
                if tot <= 0 or resp[peak] < resp.std() or not hc:
                    ox, oy = px, py              # no feature: zero residual
                else:
                    yy, xx = np.mgrid[0:sub.shape[0], 0:sub.shape[1]]
                    ox = x0 + wx0 + (sub * xx).sum() / tot
                    oy = y0 + wy0 + (sub * yy).sum() / tot
                rows.append({
                    "x": float(ox), "y": float(oy), "z": 0.0,
                    "xcoor": int(coords[li, 0]), "ycoor": int(coords[li, 1]),
                    "zcoor": int(coords[li, 2]),
                    "shiftX": float(ox - px), "shiftY": float(oy - py),
                    "frameId": ti + 1, "itemId": li + 1,
                    "tiltAngle": float(tilts[ti]),
                })
        MetaData.fromRows(rows).write(self.getParam("-o"))
        if self.verbose and rows:
            res = np.array([[r["shiftX"], r["shiftY"]] for r in rows])
            print(f"{len(rows)} residuals, rms "
                  f"{float(np.sqrt((res ** 2).sum(1).mean())):.2f} px")


class ProgTomoDetectMisalignmentResiduals(XmippProgram):
    """Per-image verdicts from the Mahalanobis distances of the residual
    vectors (host numpy on a few hundred rows, as in the reference)."""
    name = "xmipp_tomo_detect_misalignment_residuals"

    def defineParams(self):
        self.addUsageLine("Detect misaligned tilt images from landmark "
                          "residual vectors (Mahalanobis statistics).")
        self.addParamsLine("   --inputResInfo <md> : Residual report (from "
                          "tomo_calculate_landmark_residuals)")
        self.addParamsLine("  [-o <md=alignmentReport.xmd>] : Output per-image verdicts")
        self.addParamsLine("  [--samplingRate <s=1>]   : Sampling rate (A/px)")
        self.addParamsLine("  [--fiducialSize <f=100>] : Fiducial size (A)")
        self.addParamsLine("  [--thrRatioMahalanobis <t=0.8>] : Max ratio of "
                          "residuals with Mahalanobis distance > 1 before an "
                          "image/chain is flagged misaligned")
        self.addParamsLine("  [--removeOutliers]  : Trim the worst 10% before fitting")

    def run(self):
        self.refuse_unread("--samplingRate", "--fiducialSize", item=24)
        md = MetaData(self.getParam("--inputResInfo"))
        rx = np.asarray(md.getColumn("shiftX"), np.float64)
        ry = np.asarray(md.getColumn("shiftY"), np.float64)
        frames = np.asarray(md.getColumn("frameId"), int)
        res = np.stack([rx, ry], axis=1)
        thr = self.getDoubleParam("--thrRatioMahalanobis")
        fit = res
        if self.checkParam("--removeOutliers") and len(res) >= 10:
            norm = np.hypot(rx, ry)
            fit = res[norm <= np.quantile(norm, 0.9)]
        icov = np.linalg.inv(np.cov(fit.T) + 1e-9 * np.eye(2))
        d = res - fit.mean(axis=0)
        maha = np.sqrt(np.einsum("ni,ij,nj->n", d, icov, d))
        rows = []
        for f in np.unique(frames):
            m = maha[frames == f]
            ratio = float((m > 1.0).mean()) if len(m) else 0.0
            rows.append({"frameId": int(f), "enabled": 1 if ratio <= thr
                         else -1, "cost": ratio,
                         "maxCC": float(m.mean()) if len(m) else 0.0})
        global_ok = all(r["enabled"] == 1 for r in rows)
        omd = MetaData.fromRows(rows)
        omd.comment = ("globalAlignment=1" if global_ok
                       else "globalAlignment=-1")
        omd.write(self.getParam("-o"))
        if self.verbose:
            bad = [r["frameId"] for r in rows if r["enabled"] == -1]
            print(f"global alignment {'OK' if global_ok else 'BAD'}; "
                  f"misaligned frames: {bad if bad else 'none'}")


class ProgTomoExtractParticlestacks(XmippProgram):
    """Per-particle 2-D tilt stacks at the reprojected coordinates; a
    particle's patches are inverted and normalised together on the
    card."""
    name = "xmipp_tomo_extract_particlestacks"

    def defineParams(self):
        self.addUsageLine("Extract per-particle 2D tilt stacks from a tilt "
                          "series at reprojected 3D coordinates.")
        self.addParamsLine("   --tiltseries <md>   : Tilt series metadata (tiltAngle per image)")
        self.addParamsLine("   --coordinates <md>  : 3D coordinates (xcoor/ycoor/zcoor)")
        self.addParamsLine("   --boxsize <b=100>   : Particle box size (px)")
        self.addParamsLine("   -o <dir>            : Output directory")
        self.addParamsLine("  [--sampling <s=1>]   : Sampling rate (A/px)")
        self.addParamsLine("  [--invertContrast]   : Invert contrast")
        self.addParamsLine("  [--normalize]        : Zero-mean/unit-std per patch")
        self.addParamsLine("  [--setCTF]           : Tilt-series metadata carries CTF columns; compute and set the local per-particle defocus (tomo_extract_particlestacks.cpp:320-331)")
        self.addParamsLine("  [--defocusPositive]  : Defocus increases along +z (handedness of the local defocus correction)")
        self.addParamsLine("  [--swapXY]           : Swap X/Y of the coordinates")

    def run(self):
        dev = resolve_device(self.getParam("--device"))
        imgs, tilts = _load_ts(self.getParam("--tiltseries"))
        if tilts is None:
            tilts = np.zeros(len(imgs), np.float32)
        T, H, W = imgs.shape
        ts_def = None
        if self.checkParam("--setCTF"):
            ts_def = np.array(
                [[float(r.get(k, 0)) for k in
                  ("ctfDefocusU", "ctfDefocusV", "ctfDefocusAngle")]
                 for r in MetaData(self.getParam("--tiltseries")).iterRows()],
                np.float64)
        sampling = self.getDoubleParam("--sampling")
        handness = 1.0 if self.checkParam("--defocusPositive") else -1.0
        coords = _coords(MetaData(self.getParam("--coordinates")))
        b = self.getIntParam("--boxsize")
        half = b // 2
        outdir = self.getParam("-o")
        os.makedirs(outdir, exist_ok=True)
        proj = project_landmarks(coords, tilts, (W, H),
                                 swap_xy=self.checkParam("--swapXY"))
        all_rows = []
        n_out = 0
        for pi in range(coords.shape[0]):
            patches, rows = [], []
            for ti in range(T):
                x, y = int(round(proj[pi, ti, 0])), int(round(proj[pi, ti, 1]))
                if not (half <= x < W - half and half <= y < H - half):
                    continue
                patches.append(imgs[ti, y - half:y - half + b,
                                    x - half:x - half + b])
                row = {"tiltAngle": float(tilts[ti]),
                       "angleTilt": float(tilts[ti]),
                       "xcoor": int(coords[pi, 0]),
                       "ycoor": int(coords[pi, 1]),
                       "zcoor": int(coords[pi, 2]),
                       "frameId": ti + 1, "particleId": pi + 1}
                if ts_def is not None and ti < len(ts_def):
                    # local defocus: Df = (x cos t + z sin t) * Ts * sin t
                    # (tomo_extract_particlestacks.cpp:322-327), sign by
                    # --defocusPositive
                    t_rad = np.deg2rad(float(tilts[ti]))
                    Df = (((coords[pi, 0] - W / 2.0) * np.cos(t_rad)
                           + coords[pi, 2] * np.sin(t_rad))
                          * sampling * np.sin(t_rad))
                    row["ctfDefocusU"] = float(ts_def[ti, 0] + handness * Df)
                    row["ctfDefocusV"] = float(ts_def[ti, 1] + handness * Df)
                    row["ctfDefocusAngle"] = float(ts_def[ti, 2])
                rows.append(row)
            if not patches:
                continue
            p = torch.as_tensor(np.stack(patches).astype(np.float32),
                                device=dev)
            if self.checkParam("--invertContrast"):
                p = -p
            if self.checkParam("--normalize"):
                mu = p.mean(dim=(1, 2), keepdim=True)
                sd = p.std(dim=(1, 2), keepdim=True, correction=0)
                p = (p - mu) / sd.clamp(min=1e-8)
            stk = os.path.join(outdir, f"particle_{pi + 1:05d}.mrcs")
            save_image(stk, p.cpu().numpy())
            all_rows.extend(dict(r, image=f"{k + 1:06d}@{stk}")
                            for k, r in enumerate(rows))
            n_out += 1
        MetaData.fromRows(all_rows).write(
            os.path.join(outdir, "particlestacks.xmd"))
        if self.verbose:
            print(f"Extracted {n_out} particle stacks -> {outdir}")
