"""More tomography programs of the reference package's programs/tomo_misc.py:
xmipp_tomogram_reconstruction (Fourier inversion of a tilt series),
xmipp_tomo_detect_landmarks, xmipp_tomo_filter_coordinates,
xmipp_tomo_map_back, xmipp_tomo_ctf_wiener2d_correction and
xmipp_subtomo_subtraction.

Each runs on the card unless `--device cpu` is given: the tomogram's
gridding (one K3 launch for the whole tilt series), the resizes and the
directional filter of the landmark search, the coordinates' neighbourhood
statistics, the rotated references, the Wiener correction of the whole
series in one batch and the POCS adjustment. The greedy peak picking, the
smoothing of the subtraction mask (scipy) and the metadata stay on the
host, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import (is_metadata_file,
                                                    load_image_rows)
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import resolve_device


def _load_ts(fn):
    """(images (F, H, W) float32, tilt angles or None) of a tilt series:
    a metadata with tiltAngle (or angleTilt) per row, or a stack."""
    if is_metadata_file(fn):
        rows = list(MetaData(fn).iterRows())
        tilts = np.array([float(r.get("tiltAngle", r.get("angleTilt", 0.0)))
                          for r in rows], np.float32)
        return load_image_rows(rows), tilts
    return Image.read_stack(fn), None


class ProgTomogramReconstruction(XmippProgram):
    """Direct Fourier inversion of a single-axis tilt series: every tilt
    image gridded in one batch (Kaiser-Bessel, K3), the N^3 map cropped
    to --thickness planes. The images must be square: the reference takes
    N from the image width, and its gridding raises a TypeError on a
    non-square series (ROADMAP.md section 3, item 23); the port refuses
    one with a message."""
    name = "xmipp_tomogram_reconstruction"

    def defineParams(self):
        self.addUsageLine("Reconstruct a tomogram from a single-axis tilt "
                          "series (Fourier inversion / WBP).")
        self.addParamsLine("   -i <ts>      : Tilt series (stack or metadata with tiltAngle)")
        self.addParamsLine("  [-o <tomogram=tomogram.mrc>] : Output")
        self.addParamsLine("  [--tiltRange <t0=-60> <tF=60> <step=3>] : Tilts if stack input")
        self.addParamsLine("  [--thickness <z=-1>] : Output thickness (crop; -1 = full)")

    def run(self):
        from xmipp3_tpu_torch.ops.reconstruct import reconstruct_fourier
        from xmipp3_tpu_torch.programs.tomo_programs import _tilt_range
        dev = resolve_device(self.getParam("--device"))
        with timed_phase("read"):
            imgs, tilts = _load_ts(self.getParam("-i"))
        F, H, W = imgs.shape
        if H != W:
            raise XmippError(
                ErrCode.VALUE_INCORRECT,
                f"tomogram_reconstruction takes square tilt images; these "
                f"are {H} x {W} (a non-square series has no reconstruction "
                f"in the reference either: ROADMAP.md section 3, item 23)")
        if tilts is None:
            tilts = _tilt_range(self)[:F]
        with timed_phase("reconstruct"):
            vol = reconstruct_fourier(imgs, np.full(F, 90.0, np.float32),
                                      tilts, np.full(F, -90.0, np.float32),
                                      batch=F, device=dev)
        z = self.getIntParam("--thickness")
        if z > 0:
            D = vol.shape[0]
            vol = vol[D // 2 - z // 2: D // 2 - z // 2 + z]
        save_image(self.getParam("-o"), vol.cpu().numpy())


class ProgTomoDetectLandmarks(XmippProgram):
    """Full reference surface (tomo_detect_landmarks.cpp:35-900):
    fiducialSize (A) / samplingRate (A/px) give the landmark size in
    pixels; each tilt image is downsampled so landmarks measure
    --targetLMsize px, directionally enhanced over
    --numberFTdirOfDirections Fourier cones (ops.tomo_landmarks: every
    frame and direction in one pass on the card), and peaks more than
    --thrSD sigmas above the mean are reported, scaled back to the
    original pixel grid (the greedy peak loop on the host)."""
    name = "xmipp_tomo_detect_landmarks"

    def defineParams(self):
        self.addUsageLine("Detect high-contrast fiducial landmarks in a "
                          "tilt series.")
        self.addParamsLine("   -i <ts>      : Tilt series")
        self.addParamsLine("  [-o <md_file=landmarkCoordinates.xmd>] : "
                           "Landmark coordinates")
        self.addParamsLine("  [--samplingRate <s=1>] : Pixel size (A/px)")
        self.addParamsLine("  [--fiducialSize <f=100>] : Fiducial size (A)")
        self.addParamsLine("  [--targetLMsize <t=8>] : Target landmark "
                           "size (px) after downsampling")
        self.addParamsLine("  [--thrSD <t=5>] : Peak threshold (SDs over "
                           "the mean)")
        self.addParamsLine("   alias --thr;")
        self.addParamsLine("  [--numberFTdirOfDirections <n=8>] : Fourier "
                           "directional-filter cone count")

    def run(self):
        from xmipp3_tpu_torch.ops.resize import fourier_resize_2d
        from xmipp3_tpu_torch.ops.tomo_landmarks import (directional_enhance,
                                                         downsample_factor)
        dev = resolve_device(self.getParam("--device"))
        imgs, _ = _load_ts(self.getParam("-i"))
        Ts = self.getDoubleParam("--samplingRate")
        fid_px = max(self.getDoubleParam("--fiducialSize") / max(Ts, 1e-6),
                     4.0)
        target = self.getDoubleParam("--targetLMsize")
        thr = self.getDoubleParam("--thrSD")
        H, W = imgs.shape[-2:]
        ds = downsample_factor(fid_px, target)
        Hd, Wd = max(int(round(H / ds)), 32), max(int(round(W / ds)), 32)
        Hd -= Hd % 2
        Wd -= Wd % 2
        ds_y, ds_x = H / Hd, W / Wd
        with timed_phase("enhance"):
            small = fourier_resize_2d(imgs.astype(np.float32), Hd, Wd,
                                      device=dev)
            # fiducials are dark: negate, then directionally enhance
            enhanced = directional_enhance(
                -(small - small.mean(dim=(1, 2), keepdim=True)),
                float(target),
                self.getIntParam("--numberFTdirOfDirections")).cpu().numpy()
        rows = []
        half = max(int(round(target)), 3)
        with timed_phase("peaks"):
            for f in range(len(enhanced)):
                s = enhanced[f].copy()
                mu, sd = s.mean(), s.std()
                for _ in range(80):
                    y, x = divmod(int(np.argmax(s)), Wd)
                    if s[y, x] < mu + thr * sd:
                        break
                    rows.append({"xcoor": int(round(x * ds_x)),
                                 "ycoor": int(round(y * ds_y)),
                                 "frameId": f + 1, "cost": float(s[y, x])})
                    s[max(y - half, 0):min(y + half, Hd),
                      max(x - half, 0):min(x + half, Wd)] = -np.inf
        MetaData.fromRows(rows).write(self.getParam("-o"))
        self.n_landmarks = len(rows)
        if self.verbose:
            print(f"Detected {len(rows)} landmarks")


class ProgTomoFilterCoordinates(XmippProgram):
    """Full reference surface (tomo_filter_coordinates.cpp:40-232):
    optional mask filtering (coordinates whose mask voxel is 0 are
    erased), then per-coordinate statistics from --inTomo: mean and
    stddev over the r2 <= radius neighborhood (the reference compares the
    SQUARED distance against the radius — kept as it is), written as
    avg/stddev columns; near-border coordinates are dropped with a
    warning. Extension kept: --minScore cost filtering. The statistics of
    every coordinate are one float64 gather on the card."""
    name = "xmipp_tomo_filter_coordinates"

    def defineParams(self):
        self.addUsageLine("Filter subtomogram coordinates by a mask volume "
                          "and score them against a density/resolution "
                          "tomogram.")
        self.addParamsLine("   --coordinates <md> : Input coordinates")
        self.addParamsLine("   -o <md=filteredCoordinates3D.xmd> : Output "
                           "filtered/scored coordinates")
        self.addParamsLine("  [--inTomo <tomo=\"\">] : Tomogram (density or "
                           "local resolution) for the per-coordinate "
                           "statistics")
        self.addParamsLine("  [--radius <radius=50>] : Neighbourhood radius "
                           "(px) for the statistics")
        self.addParamsLine("  [--mask <vol=\"\">]   : Keep coords inside this mask")
        self.addParamsLine("  [--minScore <s=-1e30>] : Keep cost >= this")

    def run(self):
        dev = resolve_device(self.getParam("--device"))
        md = MetaData(self.getParam("--coordinates"))
        mask = None
        if self.getParam("--mask"):
            mask = np.squeeze(Image(self.getParam("--mask")).data) > 0.5
        min_score = self.getDoubleParam("--minScore")
        rows = []
        for i in md:
            r = md.getRow(i)
            if float(r.get("cost", 0.0)) < min_score:
                continue
            if mask is not None:
                x, y = int(r["xcoor"]), int(r["ycoor"])
                z = int(r.get("zcoor", mask.shape[0] // 2))
                if not (0 <= z < mask.shape[0] and 0 <= y < mask.shape[1]
                        and 0 <= x < mask.shape[2] and mask[z, y, x]):
                    continue
            rows.append(r)
        if self.getParam("--inTomo"):
            tomo = torch.as_tensor(np.squeeze(Image(
                self.getParam("--inTomo")).data), dtype=torch.float64,
                device=dev)
            Z, Y, X = tomo.shape
            radius = int(self.getDoubleParam("--radius"))
            # the reference's ball is r2 <= radius (squared distance
            # against the radius, calculateCoordinateStatistics): an
            # effective sqrt(radius) voxel ball
            rr = int(np.floor(np.sqrt(radius))) + 1
            off = np.mgrid[-rr:rr + 1, -rr:rr + 1, -rr:rr + 1]
            ball = (off[0] ** 2 + off[1] ** 2 + off[2] ** 2) <= radius
            dz, dy, dx = (torch.as_tensor(o[ball], device=dev) for o in off)
            kept = []
            for r in rows:
                x, y = int(r["xcoor"]), int(r["ycoor"])
                z = int(r.get("zcoor", Z // 2))
                if (z - radius < 0 or z + radius > Z - 1
                        or y - radius < 0 or y + radius > Y - 1
                        or x - radius < 0 or x + radius > X - 1):
                    print(f"WARNING: Coordinate at (x={x}, y={y}, z={z}) "
                          "masked out.")
                    continue
                kept.append((r, (z, y, x)))
            rows = [r for r, _ in kept]
            if kept:
                c = torch.as_tensor([p for _, p in kept], device=dev)
                v = tomo[c[:, 0, None] + dz, c[:, 1, None] + dy,
                         c[:, 2, None] + dx]
                avg = v.mean(dim=1).cpu().numpy()
                std = v.std(dim=1, correction=0).cpu().numpy()
                rows = [dict(r, avg=float(a), stddev=float(s))
                        for r, a, s in zip(rows, avg, std)]
        MetaData.fromRows(rows).write(self.getParam("-o"))
        self.n_kept = len(rows)


class ProgTomoMapBack(XmippProgram):
    """Full reference surface (tomo_map_back.cpp:38-150): paint the
    reference subtomogram into the tomogram at each --geom row's
    (xcoor, ycoor, zcoor) after applying the row's geometry (Euler
    angles, geo2TransformationMatrix); painting modes copy, avg (region
    set to its tomogram average inside the thresholded reference),
    highlight (+= K*ref) and copy_binary. Every rotated reference comes
    from one batched warp on the card, and the rows paint the tomogram
    there in order."""
    name = "xmipp_tomo_map_back"

    def defineParams(self):
        self.addUsageLine("Place a reference subtomogram on a tomogram at "
                          "given locations (map back).")
        self.addParamsLine("   -i <tomogram>    : Original tomogram")
        self.addParamsLine("   alias --tomogram;")
        self.addParamsLine("  [-o <tomogram=\"\">] : Output tomogram")
        self.addParamsLine("   --geom <geometry> : Coordinates and rotation "
                           "angles metadata")
        self.addParamsLine("   alias --coordinates;")
        self.addParamsLine("   --ref <reference> : Subtomogram reference")
        self.addParamsLine("  [--method <mode=copy>] : Painting mode")
        self.addParamsLine("     where <mode>")
        self.addParamsLine("        copy")
        self.addParamsLine("        avg <threshold=0.5>")
        self.addParamsLine("        highlight <K=1>")
        self.addParamsLine("        copy_binary <threshold=0.5>")

    def run(self):
        from xmipp3_tpu_torch.core.geometry import euler_matrix
        from xmipp3_tpu_torch.ops.geo import apply_affine_3d
        dev = resolve_device(self.getParam("--device"))
        out = torch.as_tensor(np.squeeze(Image(self.getParam("-i")).data
                                         ).astype(np.float32), device=dev)
        ref = np.squeeze(Image(self.getParam("--ref")).data
                         ).astype(np.float32)
        rows = list(MetaData(self.getParam("--geom")).iterRows())
        mode = self.getParam("--method")
        thr, K = 0.5, 1.0
        if self.checkParam("--method") and mode != "copy":
            try:
                arg = self.getDoubleParam("--method", 1)
            except Exception:
                arg = None
            if arg is not None:
                if mode == "highlight":
                    K = arg
                else:
                    thr = arg
        if mode in ("avg", "copy_binary"):
            ref = (ref > thr).astype(np.float32)
        col = lambda k: np.float32([float(r.get(k, 0)) for r in rows])
        # geo2TransformationMatrix: the inverse Euler rotation places the
        # reference in the tomogram frame
        mats = np.transpose(np.asarray(euler_matrix(
            col("angleRot"), col("angleTilt"), col("anglePsi")),
            np.float32), (0, 2, 1))
        with timed_phase("rotate"):
            rot_refs = apply_affine_3d(ref, mats, device=dev)
        pz, py, px = ref.shape
        Z, Y, X = out.shape
        for n, r in enumerate(rows):
            x0 = int(r["xcoor"]) - px // 2
            y0 = int(r["ycoor"]) - py // 2
            z0 = int(r.get("zcoor", Z // 2)) - pz // 2
            zs = slice(max(z0, 0), min(z0 + pz, Z))
            ys = slice(max(y0, 0), min(y0 + py, Y))
            xs = slice(max(x0, 0), min(x0 + px, X))
            rr = rot_refs[n][zs.start - z0:zs.stop - z0,
                             ys.start - y0:ys.stop - y0,
                             xs.start - x0:xs.stop - x0]
            region = out[zs, ys, xs]
            if mode == "avg":
                # the region average is taken over the tomogram voxels
                # under the whole reference box (reference mode==2 loop)
                avg = region.mean() if region.numel() else 0.0
                out[zs, ys, xs] = torch.where(rr > 0, avg, region)
            elif mode == "highlight":
                out[zs, ys, xs] = region + K * rr
            else:                       # copy / copy_binary
                out[zs, ys, xs] = rr
        save_image(self.getParam("-o") or "mapback.mrc", out.cpu().numpy())


class ProgTomoCtfWiener2DCorrection(XmippProgram):
    """Wiener CTF correction of a tilt series with one CTF a row, every
    image in one batch on the card."""
    name = "xmipp_tomo_ctf_wiener2d_correction"

    def defineParams(self):
        self.addUsageLine("Wiener CTF correction of tilt-series images "
                          "(defocus varies with tilt).")
        self.addParamsLine("   -i <md>  : Tilt series metadata (ctf columns per image)")
        self.addParamsLine("   -o <stack> : Corrected series")
        self.addParamsLine("  [--sampling <Ts=1>] : Pixel size")
        self.addParamsLine("  [--wc <w=0.1>] : Wiener constant")

    def run(self):
        from xmipp3_tpu_torch.ops.ctf import wiener_filter_2d
        from xmipp3_tpu_torch.programs.ctf_correct import _row_ctf
        dev = resolve_device(self.getParam("--device"))
        rows = list(MetaData(self.getParam("-i")).iterRows())
        Ts = self.getDoubleParam("--sampling")
        out = wiener_filter_2d(load_image_rows(rows),
                               [_row_ctf(r, Ts) for r in rows],
                               self.getDoubleParam("--wc"), device=dev)
        save_image(self.getParam("-o"), out.cpu().numpy())


class ProgSubtomoSubtraction(XmippProgram):
    """Full reference surface subtomo_subtraction.cpp:48-494: per-subtomo
    POCS adjustment of the aligned particle to the reference (amplitude /
    min-max / mask / phase / nonnegativity / std projections via
    ops.pocs.volume_adjust, on the card), optional subtraction, alignment
    recovered on output."""
    name = "xmipp_subtomo_subtraction"

    def defineParams(self):
        self.addUsageLine("Adjust each subtomogram to a reference volume "
                          "by POCS iteration and optionally subtract.")
        self.addParamsLine("   -i <md>    : Metadata with the subtomograms")
        self.addParamsLine("   --ref <volume> : Reference volume")
        self.addParamsLine("  [--oroot <root=\"\">] : Output rootname")
        self.addParamsLine("  [-o <out=\"\">] : Output metadata (alias of "
                           "--oroot)")
        self.addParamsLine("  [--sub] : Perform the subtraction; the "
                           "output is the difference")
        self.addParamsLine("  [--sigma <s=3>] : Decay of the filter to "
                           "smooth the mask transition")
        self.addParamsLine("  [--iter <n=5>] : Adjustment iterations")
        self.addParamsLine("  [--mask1 <mask=\"\">] : Mask for volume 1")
        self.addParamsLine("  [--mask2 <mask=\"\">] : Mask for volume 2")
        self.addParamsLine("  [--maskSub <mask=\"\">] : Mask for the "
                           "subtraction region")
        self.addParamsLine("  [--cutFreq <f=0>] : Low-pass both volumes at "
                           "this cutoff frequency (<0.5)")
        self.addParamsLine("  [--lambda <l=1>] : Relaxation factor for the "
                           "Fourier amplitude POCS")
        self.addParamsLine("  [--radavg] : Match radially averaged Fourier "
                           "amplitudes instead of direct ones")
        self.addParamsLine("  [--computeEnergy] : Print the energy "
                           "difference between iterations")
        self.addParamsLine("  [--saveV1 <structure=\"\">] : Save the "
                           "filtered reference (with --sub)")
        self.addParamsLine("  [--saveV2 <structure=\"\">] : Save the "
                           "adjusted subtomogram (with --sub)")

    def run(self):
        from scipy.ndimage import gaussian_filter

        from xmipp3_tpu_torch.core.geometry import euler_matrix
        from xmipp3_tpu_torch.ops import pocs
        from xmipp3_tpu_torch.ops.geo import apply_affine_3d
        dev = resolve_device(self.getParam("--device"))
        ref_np = np.squeeze(Image(self.getParam("--ref")).data
                            ).astype(np.float32)
        ref = torch.as_tensor(ref_np, device=dev)
        md = MetaData(self.getParam("-i"))
        root = self.getParam("--oroot") or self.getParam("-o")
        if root.endswith(".xmd"):
            root = root[:-4]
        iters = self.getIntParam("--iter")
        cut = self.getDoubleParam("--cutFreq")
        adjust = dict(lam=self.getDoubleParam("--lambda"),
                      radavg=self.checkParam("--radavg"), cut_freq=cut)
        fn_v1f = self.getParam("--saveV1") or "volume1_filtered.mrc"
        fn_v2a = self.getParam("--saveV2") or "volume2_adjusted.mrc"

        # createMask (subtomo_subtraction.cpp:371-375): mask1*mask2 or all-1
        mask = None
        if self.getParam("--mask1") and self.getParam("--mask2"):
            m1 = np.squeeze(Image(self.getParam("--mask1")).data)
            m2 = np.squeeze(Image(self.getParam("--mask2")).data)
            mask = ((m1 > 0) & (m2 > 0)).astype(np.float32)
        if self.getParam("--maskSub"):
            masksub = np.squeeze(Image(self.getParam("--maskSub")).data
                                 ).astype(np.float32)
        else:
            base = np.ones(ref_np.shape, np.float32) if mask is None \
                else mask
            masksub = gaussian_filter(base, self.getIntParam("--sigma"))
        if mask is not None:
            mask = torch.as_tensor(mask, device=dev)
        masksub = torch.as_tensor(masksub, device=dev)

        rows = []
        for k, i in enumerate(md, start=1):
            r = md.getRow(i)
            label = "image" if "image" in r else "subtomoName"
            v = torch.as_tensor(np.squeeze(Image(str(r[label])).data
                                           ).astype(np.float32), device=dev)
            rot, tilt, psi = (float(r.get(a, 0.0)) for a in
                              ("angleRot", "angleTilt", "anglePsi"))
            s = np.array([float(r.get(a, 0.0)) for a in
                          ("shiftX", "shiftY", "shiftZ")], np.float32)
            aligned_pose = rot or tilt or psi or s.any()
            E = np.asarray(euler_matrix(rot, tilt, psi), np.float32)
            if aligned_pose:
                # Euler_rotate + selfTranslate (cpp:399-407): content at p
                # moves to E^T p + s
                M1 = np.concatenate([E.T, s[:, None]], axis=1)
                v = apply_affine_3d(v, M1[None])[0]
            with timed_phase("adjust"):
                if self.checkParam("--computeEnergy"):
                    adj = v
                    for it in range(iters):
                        prev = adj
                        adj = pocs.volume_adjust(ref, prev, mask=mask,
                                                 iters=1, **adjust)
                        e = float(((adj - prev) ** 2).mean())
                        print(f"Energy difference iteration {it}: {e:.6g}")
                else:
                    adj = pocs.volume_adjust(ref, v, mask=mask, iters=iters,
                                             **adjust)
            if self.checkParam("--sub"):
                save_image(fn_v2a, adj.cpu().numpy())
                v1f = pocs.lowpass_volume(ref, cut) if cut else ref
                save_image(fn_v1f, v1f.cpu().numpy().astype(np.float32))
                out = pocs.subtract_adjusted(ref, adj, masksub, cut)
            else:
                out = adj
            if aligned_pose:
                # recover original alignment (cpp:479-487)
                M2 = np.concatenate([E, -(E @ s)[:, None]], axis=1)
                out = apply_affine_3d(out, M2[None])[0]
            fn = f"{root}_{k:06d}.mrc"
            save_image(fn, out.cpu().numpy().astype(np.float32))
            rows.append(dict(r, **{label: fn}))
        MetaData.fromRows(rows).write(root + ".xmd")


PROGRAM = None
