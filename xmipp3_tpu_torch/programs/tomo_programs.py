"""Tomography programs of the reference package's programs/tomo_programs.py:
xmipp_tomo_project, xmipp_tomo_simulate_tilt_series,
xmipp_tomo_extract_subtomograms, xmipp_tomo_average_subtomos,
xmipp_tomo_tiltseries_dose_filter and xmipp_tomo_detect_missing_wedge
(reference libraries/tomo/ set).

Each runs on the card unless `--device cpu` is given: the projections,
Fourier resizes, affine warps, dose weights and the wedge fit's 3-D FFT
and plane scores. The per-particle cubic-spline rotation of the simulator
(scipy.ndimage.affine_transform), the pasting, the numpy draws of the
poses and the noise, and the metadata stay on the host, as in the
reference.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import resolve_device


def _tilt_range(prog):
    """The tilt angles arange(t0, tF, step) (float32) of --tiltRange."""
    t0, tF, step = (prog.getDoubleParam("--tiltRange", i) for i in range(3))
    return np.arange(t0, tF + 1e-6, step).astype(np.float32)


class ProgTomoProject(XmippProgram):
    name = "xmipp_tomo_project"

    def defineParams(self):
        self.addUsageLine("Generate a tilt series from a volume "
                          "(single-axis tilt about Y).")
        self.addParamsLine("   -i <volume>  : Input volume")
        self.addParamsLine("   -o <root>    : Output rootname (.mrcs + .xmd)")
        self.addParamsLine("  [--tiltRange <t0=-60> <tF=60> <step=3>] : Tilt scheme")

    def run(self):
        from xmipp3_tpu_torch.ops.project import FourierProjector
        dev = resolve_device(self.getParam("--device"))
        vol = np.squeeze(Image(self.getParam("-i")).data).astype(np.float32)
        tilts = _tilt_range(self)
        # single-axis tilt about Y: rot=90, tilt=theta, psi=-90
        imgs = FourierProjector(vol, device=dev).project_euler(
            np.full(len(tilts), 90.0, np.float32), tilts,
            np.full(len(tilts), -90.0, np.float32)).cpu().numpy()
        root = self.getParam("-o")
        save_image(root + ".mrcs", imgs)
        MetaData.fromRows([
            {"image": f"{i + 1:06d}@{root}.mrcs", "angleRot": 90.0,
             "angleTilt": float(tilts[i]), "anglePsi": -90.0,
             "tiltAngle": float(tilts[i]), "itemId": i + 1}
            for i in range(len(tilts))]).write(root + ".xmd")


class ProgTomoSimulateTiltSeries(XmippProgram):
    """Full reference surface (tomo_simulate_tilt_series.{h,cpp}): plants
    oriented copies of a particle volume into a ground-truth tomogram,
    projects each particle at every tilt (one batched Fourier projection a
    particle on the card) into the tilt series at its tilted position,
    adds gold fiducials and noise. As in the reference package, the
    fiducials are placed in both the tomogram and the tilt series (the
    reference C++ program builds them and never inserts them,
    cpp:224-230)."""
    name = "xmipp_tomo_simulate_tilt_series"

    def defineParams(self):
        self.addUsageLine("Simulate a tilt series + ground-truth tomogram "
                          "from coordinates and a particle volume.")
        self.addParamsLine("   --coordinates <md> : xcoor/ycoor/zcoor "
                           "(+ optional rot/tilt/psi) of particles")
        self.addParamsLine("   --vol <particle>   : Particle volume to plant")
        self.addParamsLine("  [-o <root=\"\">]      : Output rootname "
                           "(legacy; else use --tiltseries/--tomogram)")
        self.addParamsLine("  [--tiltseries <mrc=\"\">] : Output tilt series")
        self.addParamsLine("  [--tomogram <mrc=\"\">]   : Output tomogram")
        self.addParamsLine("  [--xdim <x=256>]    : Tilt-image/tomogram X size")
        self.addParamsLine("  [--ydim <y=256>]    : Tilt-image/tomogram Y size")
        self.addParamsLine("  [--thickness <z=64>] : Tomogram thickness (px)")
        self.addParamsLine("   alias --zdim;")
        self.addParamsLine("  [--minTilt <t=-60>] : Minimum tilt angle")
        self.addParamsLine("  [--maxTilt <t=60>]  : Maximum tilt angle")
        self.addParamsLine("  [--tiltStep <t=3>]  : Tilt angle step")
        self.addParamsLine("  [--tiltRange <t0=-60> <tF=60> <step=3>] : "
                           "Legacy combined tilt scheme")
        self.addParamsLine("  [--sampling <s=1>]  : Sampling rate (A/px)")
        self.addParamsLine("  [--fiducialCoordinates <md=\"\">] : Fiducial "
                           "coordinates in the tomogram")
        self.addParamsLine("  [--fiducialDiameter <d=100>] : Fiducial "
                           "diameter (A)")
        self.addParamsLine("  [--sigmaNoise <s=-1>] : Noise stddev")
        self.addParamsLine("   alias --noise;")

    def run(self):
        from scipy.ndimage import affine_transform

        from xmipp3_tpu_torch.core.geometry import euler_matrix
        from xmipp3_tpu_torch.ops.project import FourierProjector
        dev = resolve_device(self.getParam("--device"))
        md = MetaData(self.getParam("--coordinates"))
        part = np.squeeze(Image(self.getParam("--vol")).data
                          ).astype(np.float32)
        X = self.getIntParam("--xdim")
        Y = self.getIntParam("--ydim")
        Z = self.getIntParam("--thickness")
        if self.checkParam("--tiltRange"):
            tilts = _tilt_range(self)
        else:
            tilts = np.arange(self.getDoubleParam("--minTilt"),
                              self.getDoubleParam("--maxTilt") + 1e-6,
                              self.getDoubleParam("--tiltStep")
                              ).astype(np.float32)
        sigma = self.getDoubleParam("--sigmaNoise")
        root = self.getParam("-o")
        fn_ts = self.getParam("--tiltseries") or root + ".mrcs"
        fn_tomo = self.getParam("--tomogram") or root + "_tomogram.mrc"

        box = part.shape[-1]
        half = box // 2
        tomo = np.zeros((Z, Y, X), np.float32)
        series = np.zeros((len(tilts), Y, X), np.float32)
        # spherical mask with a smooth rim (maskingRotatedSubtomo)
        zz, yy, xx = np.mgrid[0:box, 0:box, 0:box].astype(np.float32) - half
        sph = np.clip((half - np.sqrt(zz * zz + yy * yy + xx * xx)) / 2.0,
                      0.0, 1.0)
        rng = np.random.default_rng(0)
        ct = np.cos(np.deg2rad(tilts))
        st = np.sin(np.deg2rad(tilts))
        zero = np.zeros_like(tilts)

        def paste2d(img, patch, xc, yc):
            b = patch.shape[0]
            x0, y0 = int(xc) - b // 2, int(yc) - b // 2
            if x0 < 0 or y0 < 0 or x0 + b > X or y0 + b > Y:
                return
            img[y0:y0 + b, x0:x0 + b] += patch

        c = np.asarray(part.shape) // 2
        for row in md.iterRows():
            xc, yc = int(row["xcoor"]), int(row["ycoor"])
            zc = int(row.get("zcoor", 0))
            if "anglePsi" in row or "angleRot" in row:
                # the reference reads (theta,phi,xi) = (psi,tilt,rot),
                # tomo_simulate_tilt_series.cpp:283-287
                theta = float(row.get("anglePsi", 0.0))
                phi = float(row.get("angleTilt", 0.0))
                xi = float(row.get("angleRot", 0.0))
            else:
                theta = 360.0 * rng.random()
                phi = np.degrees(np.arccos(2 * rng.random() - 1.0))
                xi = 360.0 * rng.random()
            R = np.asarray(euler_matrix(theta, phi, xi), np.float64)
            Rinv = np.linalg.inv(R[::-1, ::-1])  # (x,y,z) in (z,y,x) order
            with timed_phase("rotate particles"):
                rot_part = affine_transform(
                    part, Rinv, offset=c - Rinv @ c, order=3,
                    mode="constant").astype(np.float32) * sph
            # ground-truth tomogram (negated densities, placeSubtomoInTomo)
            z0, y0, x0 = Z // 2 + zc - half, Y // 2 + yc - half, \
                X // 2 + xc - half
            if (0 <= z0 and z0 + box <= Z and 0 <= y0 and y0 + box <= Y
                    and 0 <= x0 and x0 + box <= X):
                tomo[z0:z0 + box, y0:y0 + box, x0:x0 + box] = -rot_part
            # every tilt's projection at the tilted particle position
            with timed_phase("project particles"):
                imgs = FourierProjector(rot_part, 2.0, device=dev
                                        ).project_euler(zero, tilts, zero
                                                        ).cpu().numpy()
            for idx in range(len(tilts)):
                paste2d(series[idx], imgs[idx],
                        int(xc * ct[idx] + zc * st[idx]) + X // 2,
                        yc + Y // 2)

        # fiducials: disk in projections, ball in the tomogram
        fn_fid = self.getParam("--fiducialCoordinates")
        if fn_fid:
            fid_px = max(int(round(self.getDoubleParam("--fiducialDiameter")
                                   / self.getDoubleParam("--sampling"))), 3)
            amp = 5.0 * max(sigma, 1.0)
            fy, fx = np.mgrid[0:fid_px, 0:fid_px] - fid_px // 2
            disk = np.where(fx * fx + fy * fy < (fid_px / 2) ** 2, amp,
                            0.0).astype(np.float32)
            fz, fy, fx = np.mgrid[0:fid_px, 0:fid_px, 0:fid_px] \
                - fid_px // 2
            ball = np.where(fx * fx + fy * fy + fz * fz < (fid_px / 2) ** 2,
                            amp, 0.0).astype(np.float32)
            for row in MetaData(fn_fid).iterRows():
                xc, yc = int(row["xcoor"]), int(row["ycoor"])
                zc = int(row.get("zcoor", 0))
                z0 = Z // 2 + zc - fid_px // 2
                y0 = Y // 2 + yc - fid_px // 2
                x0 = X // 2 + xc - fid_px // 2
                if (0 <= z0 and z0 + fid_px <= Z and 0 <= y0
                        and y0 + fid_px <= Y and 0 <= x0
                        and x0 + fid_px <= X):
                    tomo[z0:z0 + fid_px, y0:y0 + fid_px,
                         x0:x0 + fid_px] -= ball
                for idx in range(len(tilts)):
                    paste2d(series[idx], disk,
                            int(xc * ct[idx] + zc * st[idx]) + X // 2,
                            yc + Y // 2)

        series = -series                        # cryo contrast convention
        if sigma > 0:
            with timed_phase("noise"):
                series = series + rng.normal(0, sigma, series.shape
                                             ).astype(np.float32)
                tomo = tomo + rng.normal(0, sigma / box, tomo.shape
                                         ).astype(np.float32)
        save_image(fn_ts, series)
        save_image(fn_tomo, tomo)
        MetaData.fromRows([
            {"image": f"{i + 1:06d}@{fn_ts}", "angleTilt": float(tilts[i]),
             "tiltAngle": float(tilts[i]), "itemId": i + 1}
            for i in range(len(tilts))]).write(
            os.path.splitext(fn_ts)[0] + ".xmd")


class ProgTomoExtractSubtomograms(XmippProgram):
    """Full reference surface (tomo_extract_subtomograms.cpp:44-330):
    --downsample Fourier-crops each subtomogram by the factor,
    --fixedBoxSize enlarges the extraction window to boxsize*factor so
    the downsampled output is exactly boxsize, --invertContrast negates,
    --normalize zero-means/unit-stds using the outside-sphere background
    statistics (createSphere). The boxes are cut on the host and resized,
    inverted and normalised together on the card."""
    name = "xmipp_tomo_extract_subtomograms"

    def defineParams(self):
        self.addUsageLine("Extract cubic subtomograms at coordinates.")
        self.addParamsLine("   --tomogram <vol> : Input tomogram")
        self.addParamsLine("   --coordinates <md> : xcoor/ycoor/zcoor metadata")
        self.addParamsLine("   --boxsize <b>    : Subtomogram box size "
                           "(before downsampling)")
        self.addParamsLine("   -o <root>        : Output rootname")
        self.addParamsLine("  [--invertContrast] : Invert contrast")
        self.addParamsLine("   alias --invert;")
        self.addParamsLine("  [--normalize]     : Zero mean / unit std "
                           "from the outside-sphere background")
        self.addParamsLine("  [--downsample <factor=1.0>] : Scale factor "
                           "(>1 shrinks the subtomogram by the factor)")
        self.addParamsLine("  [--fixedBoxSize]  : Extract boxsize*factor "
                           "so the downsampled box is exactly boxsize")

    def run(self):
        from xmipp3_tpu_torch.ops.resize import fourier_resize_3d
        dev = resolve_device(self.getParam("--device"))
        tomo = np.squeeze(Image(self.getParam("--tomogram")).data
                          ).astype(np.float32)
        md = MetaData(self.getParam("--coordinates"))
        b = self.getIntParam("--boxsize")
        factor = self.getDoubleParam("--downsample")
        # extraction window / output size (reference extractSubtomoFixedSize)
        if self.checkParam("--fixedBoxSize") and factor != 1.0:
            b_ext, b_out = int(round(b * factor)), b
        else:
            b_ext = b
            b_out = int(round(b / factor)) if factor != 1.0 else b
        b_ext += b_ext % 2
        b_out += b_out % 2
        half = b_ext // 2
        Z, Y, X = tomo.shape
        boxes, rows = [], []
        for i in md:
            r = md.getRow(i)
            x, y = int(r["xcoor"]), int(r["ycoor"])
            z = int(r.get("zcoor", Z // 2))
            if (half <= x < X - half and half <= y < Y - half and
                    half <= z < Z - half):
                boxes.append(tomo[z - half:z - half + b_ext,
                                  y - half:y - half + b_ext,
                                  x - half:x - half + b_ext])
                rows.append((x, y, z))
        root = self.getParam("-o")
        if boxes:
            s = torch.as_tensor(np.stack(boxes), device=dev)
            if b_out != b_ext:
                s = torch.stack([fourier_resize_3d(v, b_out, b_out, b_out)
                                 for v in s])
            if self.checkParam("--invertContrast"):
                s = -s
            if self.checkParam("--normalize"):
                # background sphere mask at the OUTPUT size (createSphere)
                zz, yy, xx = np.mgrid[0:b_out, 0:b_out, 0:b_out] - b_out // 2
                bg = torch.as_tensor(np.sqrt(zz ** 2 + yy ** 2 + xx ** 2)
                                     > b_out // 2, device=dev)
                sb = s[:, bg]
                mu = sb.mean(dim=1)
                sd = sb.std(dim=1, correction=0).clamp(min=1e-12)
                s = (s - mu[:, None, None, None]) / sd[:, None, None, None]
            s = s.cpu().numpy()
            for k in range(len(rows)):
                save_image(f"{root}_{k + 1:06d}.mrc", s[k])
        MetaData.fromRows(
            {"subtomoName": f"{root}_{k + 1:06d}.mrc", "xcoor": x,
             "ycoor": y, "zcoor": z, "itemId": k + 1}
            for k, (x, y, z) in enumerate(rows)).write(root + ".xmd")
        if self.verbose:
            print(f"Extracted {len(rows)} subtomograms of {b_out}^3")
        self.n_extracted = len(rows)


class ProgTomoAverageSubtomos(XmippProgram):
    """Full reference surface (tomo_average_subtomos.cpp:38-165): by
    default each subtomogram is rotated/shifted by its row geometry
    (geo2TransformationMatrix) before averaging; --notApplyAlignment
    averages raw; --goldStandard also writes halfMap_1/halfMap_2 from a
    random even split (numpy's permutation). The warps and sums run on
    the card."""
    name = "xmipp_tomo_average_subtomos"

    def defineParams(self):
        self.addUsageLine("Average a set of subtomograms, applying their "
                          "alignment.")
        self.addParamsLine("   -i <md>  : Metadata with subtomoName/image "
                           "column")
        self.addParamsLine("   -o <vol> : Output average (with "
                           "--goldStandard, also halfMap_1/2 next to it)")
        self.addParamsLine("  [--notApplyAlignment] : Plain average "
                           "(ignore row geometry)")
        self.addParamsLine("  [--goldStandard] : Also write two half maps "
                           "from a random split")
        self.addParamsLine("  [--sampling <Ts=1>] : Pixel size (A) "
                           "recorded in the output headers")
        self.addParamsLine("  [--seed <s=0>] : Random split seed")

    def run(self):
        from xmipp3_tpu_torch.core.geometry import euler_matrix
        from xmipp3_tpu_torch.ops.geo import apply_affine_3d
        dev = resolve_device(self.getParam("--device"))
        rows = list(MetaData(self.getParam("-i")).iterRows())
        vols = torch.as_tensor(np.stack([
            np.squeeze(Image(str(r.get("subtomoName") or r["image"])).data)
            for r in rows]).astype(np.float32), device=dev)
        n = len(vols)
        if not self.checkParam("--notApplyAlignment"):
            col = lambda k: np.float32([float(r.get(k, 0)) for r in rows])
            mats = np.transpose(np.asarray(euler_matrix(
                col("angleRot"), col("angleTilt"), col("anglePsi")),
                np.float32), (0, 2, 1))
            shifts = np.stack([col("shiftX"), col("shiftY"), col("shiftZ")],
                              axis=1)
            mats = np.concatenate([mats, shifts[:, :, None]], axis=2)
            vols = torch.stack([apply_affine_3d(v, M[None])[0]
                                for v, M in zip(vols, mats)])
        Ts = self.getDoubleParam("--sampling")
        fn_out = self.getParam("-o")
        save_image(fn_out, vols.mean(dim=0).cpu().numpy(), sampling=Ts)
        if self.checkParam("--goldStandard"):
            rng = np.random.default_rng(self.getIntParam("--seed"))
            in_h2 = np.zeros(n, bool)
            in_h2[rng.permutation(n)[:n // 2]] = True
            d = os.path.dirname(fn_out) or "."
            for k, sel in ((1, ~in_h2), (2, in_h2)):
                half = vols[torch.as_tensor(np.flatnonzero(sel), device=dev)]
                save_image(os.path.join(d, f"halfMap_{k}.mrc"),
                           (half.sum(dim=0) / (n * 0.5)).cpu().numpy(),
                           sampling=Ts)


class ProgTomoTiltseriesDoseFilter(XmippProgram):
    """Dose weighting of a tilt series on the card. The weights take the
    images' own width (ops.movie.dose_filter's `width`); the reference
    builds square H x H weights, which do not fit the spectra of a
    non-square series (ROADMAP.md section 3, item 7)."""
    name = "xmipp_tomo_tiltseries_dose_filter"

    def defineParams(self):
        self.addUsageLine("Dose-weight a tilt series (Grant & Grigorieff, "
                          "accumulated dose per tilt image).")
        self.addParamsLine("   -i <md_or_stack> : Tilt series (ordered by acquisition)")
        self.addParamsLine("   -o <stack>       : Output filtered series")
        self.addParamsLine("   --dosePerImage <d> : e/A^2 per tilt image")
        self.addParamsLine("  [--sampling <Ts=1>] : Pixel size")
        self.addParamsLine("  [--voltage <kV=300>] : Voltage")

    def run(self):
        from xmipp3_tpu_torch.core.metadata_program import (is_metadata_file,
                                                            load_image_rows)
        from xmipp3_tpu_torch.ops.movie import dose_filter, filter_frames
        dev = resolve_device(self.getParam("--device"))
        fn = self.getParam("-i")
        if is_metadata_file(fn):
            imgs = load_image_rows(list(MetaData(fn).iterRows()))
        else:
            imgs = Image.read_stack(fn)
        F, H, W = imgs.shape
        q = dose_filter(H, F, self.getDoubleParam("--dosePerImage"),
                        self.getDoubleParam("--sampling"),
                        voltage=self.getDoubleParam("--voltage"),
                        device=dev, width=W)
        save_image(self.getParam("-o"),
                   filter_frames(imgs, q, device=dev).cpu().numpy())


class ProgTomoDetectMissingWedge(XmippProgram):
    """Full reference surface (tomo_detect_missing_wedge.cpp:30-346): fit
    TWO planes through the Fourier origin, each maximizing the dB-
    magnitude difference between a +-(--width) probe slab's two sides
    within --maxFreq; the second plane is constrained >=20 deg away from
    the first. --saveMarks writes the magnitude with both probe slabs
    marked; --saveMask writes the wedge mask (1 = missing wedge,
    drawWedge convention z_pos<0 or z_neg>0). The 3-D FFT, the dB
    magnitudes and every refinement level's (rot, tilt) candidates (one
    product of the kept frequencies with the candidates' normals, in
    chunks of frequencies) run on the card; the coarse-to-fine search
    walks on the host."""
    name = "xmipp_tomo_detect_missing_wedge"

    def defineParams(self):
        self.addUsageLine("Detect the orientation of the missing wedge in "
                          "a tomogram (two bounding planes).")
        self.addParamsLine("   -i <file> : Input tomogram")
        self.addParamsLine("  [--maxFreq <f=0.25>] : Maximum frequency for "
                           "the fit (normalized to 0.5)")
        self.addParamsLine("  [--width <w=2>] : Width of the probe plane "
                           "(Fourier samples)")
        self.addParamsLine("  [--saveMarks] : Save the FFT magnitude with "
                           "the two planes marked (<root>_marks.vol)")
        self.addParamsLine("  [--saveMask] : Save the missing-wedge mask "
                           "(<root>_mask.vol, 1 = missing wedge)")

    @staticmethod
    def _normals(rot_deg, tilt_deg):
        r = np.deg2rad(np.asarray(rot_deg, np.float64))
        t = np.deg2rad(np.asarray(tilt_deg, np.float64))
        # plane normal = Euler(rot, tilt, 0) z-row direction
        return np.stack([np.sin(t) * np.cos(r), np.sin(t) * np.sin(r),
                         np.cos(t)], axis=-1)

    def run(self):
        dev = resolve_device(self.getParam("--device"))
        fn_in = self.getParam("-i")
        vol = np.squeeze(Image(fn_in).data).astype(np.float32)
        D, H, W = vol.shape
        max_freq = self.getDoubleParam("--maxFreq")
        slab = self.getDoubleParam("--width") * 0.5 / max(D, H, W)
        with timed_phase("spectrum"):
            mag_db = 20.0 * torch.log10(torch.fft.fftn(torch.as_tensor(
                vol, device=dev)).abs().clamp(min=1e-12))
        fz, fy, fx = (torch.as_tensor(np.fft.fftfreq(n), device=dev)
                      for n in (D, H, W))
        FZ, FY, FX = torch.meshgrid(fz, fy, fx, indexing="ij")
        r2 = FZ ** 2 + FY ** 2 + FX ** 2
        # hermitian fold: the full-FFT magnitude is centrosymmetric, so a
        # through-origin plane always balances; restrict to the fx>0
        # half-space like the reference's `inverted` XOR (evaluatePlane)
        sel = (r2 <= max_freq * max_freq) & (r2 > 0) & (FX > 1e-9)
        pts = torch.stack([FX[sel], FY[sel], FZ[sel]], dim=1).float()
        vals = mag_db[sel]
        chunk = max(1, (1 << 26) // 512)

        def score(normals):
            n = torch.as_tensor(normals, dtype=torch.float32, device=dev).T
            s_pos = s_neg = c_pos = c_neg = 0.0
            for s in range(0, len(pts), chunk):
                dots = pts[s:s + chunk] @ n                       # (p, C)
                v = vals[s:s + chunk, None]
                pos = (dots > 0) & (dots <= slab)
                neg = (dots < 0) & (dots >= -slab)
                s_pos = s_pos + (v * pos).sum(0)
                s_neg = s_neg + (v * neg).sum(0)
                c_pos = c_pos + pos.sum(0)
                c_neg = c_neg + neg.sum(0)
            return (s_pos / torch.clamp(c_pos, min=1)
                    - s_neg / torch.clamp(c_neg, min=1)).cpu().numpy()

        def fit(direction=1.0, exclude=None):
            rot_c, tilt_c, span_r, span_t = 180.0, 0.0, 180.0, 90.0
            best = (0.0, 0.0)
            for _ in range(4):
                rots = np.linspace(rot_c - span_r, rot_c + span_r, 25)
                tilts = np.clip(np.linspace(tilt_c - span_t,
                                            tilt_c + span_t, 19), -90, 90)
                rr, tt = np.meshgrid(rots, tilts)
                n = self._normals(rr.ravel(), tt.ravel())
                s = direction * score(n)
                if exclude is not None:
                    ang = np.degrees(np.arccos(
                        np.clip(np.abs(n @ exclude), -1, 1)))
                    s = np.where(ang < 20.0, -np.inf, s)
                k = int(np.argmax(s))
                best = (float(rr.ravel()[k]), float(tt.ravel()[k]))
                rot_c, tilt_c = best
                span_r /= 6.0
                span_t /= 6.0
            return best

        with timed_phase("fit"):
            rot_pos, tilt_pos = fit(direction=1.0)
            n_pos = self._normals(rot_pos, tilt_pos)
            rot_neg, tilt_neg = fit(direction=-1.0, exclude=n_pos)
            n_neg = self._normals(rot_neg, tilt_neg)
        print(f"Plane1: {rot_pos} {tilt_pos}")
        print(f"Plane2: {rot_neg} {tilt_neg}")
        self.planes = ((rot_pos, tilt_pos), (rot_neg, tilt_neg))
        # y-axis wedge bound angles from the plane normals: a boundary
        # plane at wedge angle th (about y) has normal (-sin th, 0, cos th)
        ths = []
        for n in (n_pos, n_neg):
            nn = n if n[2] >= 0 else -n       # normal sign is ambiguous
            ths.append(float(np.degrees(np.arctan2(-nn[0], nn[2]))))
        th0, thF = min(ths), max(ths)
        self.wedge = (th0, thF)
        print(f"Missing wedge (deg, about y): [{th0:.1f}, {thF:.1f}]")
        root = fn_in.rsplit(".", 1)[0]
        dot = lambda n: FX * n[0] + FY * n[1] + FZ * n[2]
        if self.checkParam("--saveMarks"):
            marks = mag_db.clone()
            for n in (n_pos, n_neg):
                in_slab = (dot(n).abs() <= slab) & sel
                marks = torch.where(in_slab, 2.0 * marks.abs(), marks)
            save_image(root + "_marks.vol", marks.cpu().numpy())
        if self.checkParam("--saveMask"):
            mask = (dot(n_pos) < 0) | (dot(n_neg) > 0)
            save_image(root + "_mask.vol",
                       mask.to(torch.float32).cpu().numpy())


PROGRAM = None
