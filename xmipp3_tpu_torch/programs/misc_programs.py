"""The remaining utility programs of the reference package's
programs/misc_programs.py: xmipp_transform_dimred,
xmipp_angular_distribution_show, xmipp_image_odd_even,
xmipp_transform_adjust_image_grey_levels, xmipp_local_volume_adjust,
xmipp_volume_local_sharpening, xmipp_transform_morphology and
xmipp_transform_center_image.

Each runs on the card unless `--device cpu` is given: the alignment before
the dimension reduction, the grey-level fit (FourierProjector views and
the closed-form (a, b) fit, batched), the block sums of the local
adjustment (one reshape-reduce), the LocalDeblur band sweeps and the
centring. The angular histogram, the odd/even split and the morphology
(scipy.ndimage) stay on the host, as in the reference.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import (XmippMetadataProgram,
                                                    is_metadata_file,
                                                    load_image_rows)
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import as_tensor, resolve_device


class ProgTransformDimred(XmippProgram):
    name = "xmipp_transform_dimred"

    def defineParams(self):
        self.addUsageLine("Dimensionality reduction of an image set "
                          "(vectorize + reduce).")
        self.addParamsLine("   -i <md_or_stack> : Input images")
        self.addParamsLine("   -o <md_file>     : Output metadata with coords")
        self.addParamsLine("  [--method <m=PCA>] : PCA|pPCA|kPCA|LE|LPP|LLE|NPE|LTSA|LLTSA|HLLE|DM|Sammon|SPE|NCA|GPLVM")
        self.addParamsLine("  [--dout <d=2>]     : Output dimension")
        self.addParamsLine("  [--distance <d=Correlation>] : Image distance")
        self.addParamsLine("    where <d>")
        self.addParamsLine("      Euclidean   : Euclidean distance, no alignment")
        self.addParamsLine("      Correlation : Correlation after alignment (images are normalized and rotation/shift-aligned to the set average before vectorizing)")
        self.addParamsLine("  [--randomSample <file=\"\"> <num=3>] : Write a metadata sampling the reduced map on a num x num grid (nearest image per cell)")

    def run(self):
        from xmipp3_tpu_torch.models.dimred import reduce_dimensionality
        dev = resolve_device(self.getParam("--device"))
        fn = self.getParam("-i")
        if is_metadata_file(fn):
            md = MetaData(fn)
            rows = list(md.iterRows())
            imgs = load_image_rows(rows)
        else:
            imgs = Image.read_stack(fn)
            rows = [{"image": f"{i + 1:06d}@{fn}", "itemId": i + 1}
                    for i in range(len(imgs))]
        dist = (self.getParam("--distance")
                if self.checkParam("--distance") else "Correlation")
        if dist == "Correlation" and imgs.ndim == 3:
            # correlation distance = Euclidean on normalized ALIGNED images
            # (transform_dimred.cpp:61-64); align everything to the average
            from xmipp3_tpu_torch.ops.align import iterative_align
            ref = imgs.mean(axis=0)
            with timed_phase("align"):
                imgs = iterative_align(ref, imgs,
                                       device=dev)[-1].cpu().numpy()
            flat = imgs.reshape(len(imgs), -1).astype(np.float64)
            flat -= flat.mean(axis=1, keepdims=True)
            nrm = np.linalg.norm(flat, axis=1, keepdims=True)
            X = flat / np.maximum(nrm, 1e-12)
        else:
            X = imgs.reshape(len(imgs), -1).astype(np.float64)
        with timed_phase("reduce"):
            Y = reduce_dimensionality(X, self.getParam("--method"),
                                      self.getIntParam("--dout"), device=dev)
        out = []
        for i, r in enumerate(rows):
            d = dict(r)
            d["dimred"] = np.asarray(Y[i], np.float32)
            out.append(d)
        MetaData.fromRows(out).write(self.getParam("-o"))
        if self.checkParam("--randomSample") and \
                self.getParam("--randomSample", 0):
            fn_s = self.getParam("--randomSample", 0)
            num = self.getIntParam("--randomSample", 1)
            Y2 = np.asarray(Y)[:, :2]
            lo, hi = Y2.min(axis=0), Y2.max(axis=0)
            picked = []
            for gy in range(num):
                for gx in range(num):
                    c = lo + (np.array([gx, gy]) + 0.5) / num * (hi - lo)
                    k = int(np.argmin(((Y2 - c) ** 2).sum(axis=1)))
                    if k not in picked:
                        picked.append(k)
            MetaData.fromRows([out[k] for k in picked]).write(fn_s)


class ProgAngularDistributionShow(XmippProgram):
    name = "xmipp_angular_distribution_show"

    def defineParams(self):
        self.addUsageLine("Summarize an angular distribution (direction "
                          "histogram over a sphere sampling).")
        self.addParamsLine("   -i <md_file>  : Metadata with angles")
        self.addParamsLine("   -o <md_file>  : Output distribution metadata")
        self.addParamsLine("  [--sampling <s=10>] : Bin size (deg)")
        self.addParamsLine("  [--up_down_correction] : Fold directions to "
                           "the upper hemisphere before binning")

    def run(self):
        from xmipp3_tpu_torch.core.sampling import (Sampling,
                                                    directions_from_angles)
        md = MetaData(self.getParam("-i"))
        angles = np.stack([md.getColumn("angleRot").astype(float),
                           md.getColumn("angleTilt").astype(float)], axis=1)
        d_exp = directions_from_angles(angles)
        if self.checkParam("--up_down_correction"):
            d_exp = np.where(d_exp[:, 2:3] < 0, -d_exp, d_exp)
        grid = Sampling(self.getDoubleParam("--sampling"), "c1")
        d_ref = grid.directions
        nearest = np.argmax(d_exp @ d_ref.T, axis=1)
        counts = np.bincount(nearest, minlength=len(d_ref))
        rows = []
        for k in range(len(d_ref)):
            rows.append({"angleRot": float(grid.angles[k, 0]),
                         "angleTilt": float(grid.angles[k, 1]),
                         "weight": float(counts[k]),
                         "X": d_ref[k, 0], "Y": d_ref[k, 1],
                         "Z": d_ref[k, 2]})
        MetaData.fromRows(rows).write(self.getParam("-o"))
        self.counts = counts


class ProgImageOddEven(XmippProgram):
    name = "xmipp_image_odd_even"

    def defineParams(self):
        self.addUsageLine("Split a stack/metadata into odd and even subsets "
                          "(gold-standard halves; reference image_odd_even "
                          "--img/--type/-o/-e grammar).")
        self.addParamsLine("  [-i <md_or_stack=\"\">] : Input")
        self.addParamsLine("     alias --img;")
        self.addParamsLine("  [--type <split_type=images>] : frames or "
                           "images (both split along the stack axis)")
        self.addParamsLine("  [--oroot <root=\"\">]   : Output rootname (_odd/_even)")
        self.addParamsLine("  [-o <odd=\"\">]  : Odd-half output (overrides --oroot)")
        self.addParamsLine("  [-e <even=\"\">] : Even-half output")
        self.addParamsLine("  [--sum_frames]    : Also write the two averages")

    def run(self):
        # --type frames|images: both split along the stack axis, and the
        # reference never reads the value (ROADMAP.md section 3, item 19)
        self.refuse_unread("--type", item=19)
        fn = self.getParam("-i")
        root = self.getParam("--oroot")
        if is_metadata_file(fn):
            md = MetaData(fn)
            rows = list(md.iterRows())
        else:
            imgs = Image.read_stack(fn)
            rows = [{"image": f"{i + 1:06d}@{fn}", "itemId": i + 1}
                    for i in range(len(imgs))]
        odd = [r for i, r in enumerate(rows) if i % 2 == 0]
        even = [r for i, r in enumerate(rows) if i % 2 == 1]
        fn_odd = self.getParam("-o") or (root + "_odd.xmd")
        fn_even = self.getParam("-e") or (root + "_even.xmd")
        if fn_odd.endswith((".xmd", ".sel", ".star")):
            MetaData.fromRows(odd).write(fn_odd)
            MetaData.fromRows(even).write(fn_even)
        else:
            imgs = load_image_rows(rows)
            save_image(fn_odd, imgs[0::2])
            save_image(fn_even, imgs[1::2])
        if self.checkParam("--sum_frames"):
            imgs = load_image_rows(rows)
            base_o = fn_odd.rsplit(".", 1)[0]
            base_e = fn_even.rsplit(".", 1)[0]
            save_image(base_o + "_avg.mrc", imgs[0::2].mean(axis=0))
            save_image(base_e + "_avg.mrc", imgs[1::2].mean(axis=0))


class ProgAdjustGreyLevels(XmippMetadataProgram):
    """Full reference surface (transform_adjust_image_grey_levels.cpp:
    43-245): fit (a, b) minimizing ||a*P(rot,tilt,psi) + b -
    lowpass(I)||^2 subject to |a-1| <= --max_gray_scale and |b| <=
    --max_gray_shift * std(I); output image = (I - b)/a; a/b recorded
    as continuousA/continuousB.  The low-pass cutoff is
    --sampling/--max_resolution (raised cosine 0.02); --padding feeds
    the Fourier projector.  --Rmax is accepted for grammar parity: the
    reference builds its mask2D but both uses are dead code (cost loop
    and apply loop have the mask test commented/|| true), so the port
    accepts it too (ROADMAP.md section 3, item 19). On the card the
    constrained fit is a batched closed-form least squares (the per-image
    Powell AB/BA dance solves the same quadratic)."""
    name = "xmipp_transform_adjust_image_grey_levels"

    def defineProcessParams(self):
        self.addUsageLine("Adjust image grey levels to match reference "
                          "projections.")
        self.addParamsLine(" --ref <volume> : Reference volume")
        self.addParamsLine(" [--max_resolution <f=4>] : Maximum resolution (A)")
        self.addParamsLine(" [--max_gray_scale <a=0.05>] : Maximum gray scale change")
        self.addParamsLine(" [--max_gray_shift <b=0.05>] : Maximum gray shift as a factor of the image stddev")
        self.addParamsLine(" [--sampling <Ts=1>] : Sampling rate (A/px)")
        self.addParamsLine(" [--Rmax <R=-1>] : Maximum radius (px); dead in the reference cost (kept for parity)")
        self.addParamsLine(" [--padding <p=2>] : Projector padding factor")

    def readProcessParams(self):
        self.fn_ref = self.getParam("--ref")
        self.max_res = self.getDoubleParam("--max_resolution") \
            if self.checkParam("--max_resolution") else 4.0
        self.maxA = self.getDoubleParam("--max_gray_scale") \
            if self.checkParam("--max_gray_scale") else 0.05
        self.maxB = self.getDoubleParam("--max_gray_shift") \
            if self.checkParam("--max_gray_shift") else 0.05
        self.Ts = self.getDoubleParam("--sampling") \
            if self.checkParam("--sampling") else 1.0
        self.pad = self.getDoubleParam("--padding") \
            if self.checkParam("--padding") else 2.0
        self._proj = None

    def processBatch(self, imgs, rows):
        """One batch on the card: the views at the rows' angles, the
        low-passed images, the closed-form least squares for a P + b ~
        lowpass(I) clipped to its box, and (I - b) / a. a and b are read
        back once a batch, for the rows."""
        from xmipp3_tpu_torch.ops.fourier_filter import low_pass_mask
        from xmipp3_tpu_torch.ops.project import FourierProjector
        dev = self.device
        if self._proj is None:
            vol = np.squeeze(Image(self.fn_ref).data).astype(np.float32)
            self._proj = FourierProjector(vol, pad_factor=self.pad,
                                          device=dev)
        get = lambda k: np.array([float(r.get(k, 0.0)) for r in rows],
                                 np.float32)
        proj = self._proj.project_euler(
            get("angleRot"), get("angleTilt"), get("anglePsi"))
        I = as_tensor(imgs, dev)
        H, W = I.shape[-2:]
        w1 = min(self.Ts / self.max_res, 0.5)
        lp = as_tensor(low_pass_mask(H, W, w1, 0.02), dev)
        ifilt = torch.fft.irfft2(torch.fft.rfft2(I) * lp[None], s=(H, W))
        # closed-form LSQ for a P + b ~ Ifiltered, then the box clipping
        ax = (1, 2)
        pmean = proj.mean(dim=ax)
        imean = ifilt.mean(dim=ax)
        pvar = torch.clamp_min((proj ** 2).mean(dim=ax) - pmean ** 2,
                               1e-12)
        cov = (proj * ifilt).mean(dim=ax) - pmean * imean
        a = cov / pvar
        istd = torch.clamp_min(I.std(dim=ax, correction=0), 1e-12)
        a = torch.clamp(a, 1.0 - self.maxA, 1.0 + self.maxA)
        b = torch.minimum(torch.maximum(imean - a * pmean,
                                        -self.maxB * istd),
                          self.maxB * istd)
        ab = torch.stack([a, b]).cpu().numpy()
        for i, r in enumerate(rows):
            r["continuousA"] = float(ab[0, i])
            r["continuousB"] = float(ab[1, i])
        return (I - b[:, None, None]) / a[:, None, None]


class ProgLocalVolumeAdjust(XmippProgram):
    """Full reference surface (local_volume_adjust.cpp:38-183): tile the
    volume into non-overlapping (neighborhood/sampling)^3 blocks; per
    block c = sum(V*Vref | mask==1) / sum(Vref^2 | mask==1); V /= c
    inside the mask; --save writes the per-voxel c occupancy volume;
    --sub outputs Vref*(1-M) + (Vref - min(V', Vref))*M.  On the card the
    per-block sums are one reshape-reduce instead of the reference's
    serial block scan."""
    name = "xmipp_local_volume_adjust"

    def defineParams(self):
        self.addUsageLine("Locally adjust the grey levels of a volume to "
                          "match a reference (per-block scale).")
        self.addParamsLine("   --i1 <volume> : Reference volume")
        self.addParamsLine("   --i2 <volume> : Volume to adjust")
        self.addParamsLine("  [-o <out=output_volume.mrc>] : Output "
                           "(adjusted volume, or difference with --sub)")
        self.addParamsLine("  [--mask <mask=\"\">] : Mask for volume 1 "
                           "(adjustment happens where mask==1)")
        self.addParamsLine("  [--sampling <s=1>] : Sampling rate (A/px)")
        self.addParamsLine("  [--neighborhood <n=5>] : Side length (A) of "
                           "the cubic adjustment region")
        self.addParamsLine("  [--sub] : Output the subtraction "
                           "Vref - min(V', Vref) inside the mask")
        self.addParamsLine("  [--save <dir=\"\">] : Directory for the "
                           "Occupancy.mrc per-voxel scale volume")

    def run(self):
        dev = resolve_device(self.getParam("--device"))
        v1 = np.squeeze(Image(self.getParam("--i1")).data).astype(np.float32)
        v2 = np.squeeze(Image(self.getParam("--i2")).data).astype(np.float32)
        if self.checkParam("--mask") and self.getParam("--mask"):
            mask = (np.squeeze(Image(self.getParam("--mask")).data)
                    > 0.5).astype(np.float32)
        else:
            mask = np.ones_like(v1)
        Ts = self.getDoubleParam("--sampling")
        npx = max(int(round(self.getDoubleParam("--neighborhood") / Ts)), 1)
        D, H, W = v2.shape
        pz, py, px = [(-s) % npx for s in (D, H, W)]
        pad = lambda x: as_tensor(np.pad(x, ((0, pz), (0, py), (0, px))),
                                  dev)
        nz, ny, nx = (D + pz) // npx, (H + py) // npx, (W + px) // npx
        with timed_phase("adjust"):
            v, vr, m = pad(v2), pad(v1), pad(mask)
            blk = lambda x: x.reshape(nz, npx, ny, npx, nx, npx)
            s_vvr = blk(v * vr * m).sum(dim=(1, 3, 5))
            s_vr2 = blk(vr * vr * m).sum(dim=(1, 3, 5))
            c = torch.where(s_vr2 > 0,
                            s_vvr / torch.clamp_min(s_vr2, 1e-30), 0.0)
            c_full = c.repeat_interleave(npx, 0).repeat_interleave(
                npx, 1).repeat_interleave(npx, 2)
            v_adj = torch.where((m == 1) & (c_full != 0), v / c_full, v)
            occup = torch.where(m == 1, c_full, 0.0)
            v_adj = v_adj[:D, :H, :W].cpu().numpy()
            occup = occup[:D, :H, :W].cpu().numpy()
        if self.checkParam("--save") and self.getParam("--save"):
            save_image(os.path.join(self.getParam("--save"),
                                    "Occupancy.mrc"), occup)
        out = v_adj
        if self.checkParam("--sub"):
            out = (v1 * (1 - mask)
                   + (v1 - np.minimum(v_adj, v1)) * mask)
        fn_out = self.getParam("-o") or "output_volume.mrc"
        save_image(fn_out, out.astype(np.float32))


def _localdeblur_sweep(vol, resvol, res_list, wl_list, K, Ts):
    """One LocalDeblur local-filtering sweep (volume_local_sharpening.cpp
    localfiltering:222-283) on vol's device: cosine bands centred at
    sampling/res with upper edge wL, per-voxel Gaussian weights
    exp(-K (res - res_map)^2) in resolution space (zero where res_map <
    2 Ts), normalised by the accumulated weight. One rfftn of the volume,
    then one irfftn and one weight a band. res_list and wl_list are
    float32 numpy arrays; each band's edges are computed from them in
    float32, as the reference computes them."""
    D, H, W = vol.shape
    dev = vol.device
    F = torch.fft.rfftn(vol)
    f32 = lambda f: torch.as_tensor(f.astype(np.float32), device=dev)
    fz = f32(np.fft.fftfreq(D))[:, None, None]
    fy = f32(np.fft.fftfreq(H))[None, :, None]
    fx = f32(np.fft.rfftfreq(W))[None, None, :]
    un = torch.sqrt(fz ** 2 + fy ** 2 + fx ** 2)
    inside = resvol >= 2.0 * Ts
    acc = torch.zeros_like(vol)
    wsum = torch.zeros_like(vol)
    for res, wL in zip(res_list, wl_list):
        w = np.float32(Ts) / res
        delta = np.maximum(wL - w, np.float32(1e-6))
        w_inf = w - delta
        h = torch.where((un >= float(w_inf)) & (un <= float(wL)),
                        0.5 * (1 + torch.cos((un - float(w)) * np.pi
                                             / float(delta))), 0.0)
        band = torch.fft.irfftn(F * h, s=(D, H, W))
        weight = torch.where(inside,
                             torch.exp(-K * (float(res) - resvol) ** 2), 0.0)
        acc = acc + band * weight
        wsum = wsum + weight
    return torch.where(wsum > 0, acc / torch.clamp_min(wsum, 1e-38), 0.0)


class ProgVolumeLocalSharpening(XmippProgram):
    """Full reference surface (volume_local_sharpening.cpp:46-55) and
    algorithm (run:286-407): LocalDeblur iterations — subtract the
    locally-filtered map, re-filter the residual, take a lambda step with
    a -4*sigma_outside floor, stop when the filtered-norm percentage
    stabilizes (<1% change after iteration 2); --md records the iteration
    count and the (possibly auto-set) lambda."""
    name = "xmipp_volume_local_sharpening"

    def defineParams(self):
        self.addUsageLine("Local sharpening driven by a local-resolution map "
                          "(LocalDeblur).")
        self.addParamsLine("   --vol <volume>  : Map to sharpen")
        self.addParamsLine("  [--resolution_map <res=\"\">] : Local "
                           "resolution map (Å)")
        self.addParamsLine("  [--resvol <res=\"\">] : Alias of "
                           "--resolution_map")
        self.addParamsLine("  [-o <out=sharpened.vol>] : Output")
        self.addParamsLine("  [--md <out=params.xmd>] : Sharpening params "
                           "metadata (iterations, lambda)")
        self.addParamsLine("  [--sampling <Ts=1>] : Pixel size")
        self.addParamsLine("  [-l <lambda=1>] : Regularization (1 = "
                           "auto-set from the first-iteration norm ratio)")
        self.addParamsLine("  [-k <K=0.025>]  : Resolution-weight width")
        self.addParamsLine("  [-i <Niter=50>] : Max iterations")
        self.addParamsLine("  [-n <threads=1>] : Host threads (device "
                           "batching replaces the thread pool)")

    def run(self):
        dev = resolve_device(self.getParam("--device"))
        fn_res = self.getParam("--resolution_map") \
            if self.checkParam("--resolution_map") and \
            self.getParam("--resolution_map") else self.getParam("--resvol")
        vol = np.squeeze(Image(self.getParam("--vol")).data).astype(np.float32)
        res = np.squeeze(Image(fn_res).data).astype(np.float32)
        Ts = self.getDoubleParam("--sampling")
        lam = self.getDoubleParam("-l")
        K = self.getDoubleParam("-k") if self.checkParam("-k") else 0.025
        niter = self.getIntParam("-i") if self.checkParam("-i") else 50
        shape = vol.shape

        res = np.where((res > 0) & (res < 2 * Ts), 2 * Ts, res)
        max_res = float(res.max()) + 2.0
        min_res = 2.0 * Ts
        # dedup band list by Fourier index like the reference (idx skip)
        step = 0.2
        res_vals, wl_vals, lastidx = [], [], -1
        r = min_res
        while r < max_res:
            idx = int(round(Ts / r * shape[0]))
            if idx != lastidx:
                res_vals.append(r)
                wl_vals.append(Ts / max(r - step, 1e-3))
                lastidx = idx
            r += step
        res_list = np.asarray(res_vals, np.float32)
        wl_list = np.asarray(wl_vals, np.float32)
        resvol_j = as_tensor(res, dev)

        outside = res < 2 * Ts
        desv_outside = float(vol[outside].std()) if outside.any() else 0.0

        v_orig = as_tensor(vol, dev)
        filtered = v_orig
        sharpened = v_orig
        norm_orig = float(np.linalg.norm(vol))
        last_norm, last_porc = 0.0, 1.0
        converged = False
        iters_done = 0
        for i in range(1, niter + 1):
            with timed_phase("sweep"):
                operated = _localdeblur_sweep(filtered, resvol_j, res_list,
                                              wl_list, K, Ts)
                residual = v_orig - operated
                norm = float(torch.linalg.norm(operated))
            porc = last_norm * 100.0 / max(norm, 1e-38)
            if (porc - last_porc) < 1 and i > 2:
                converged = True
            last_norm, last_porc = norm, porc
            if i == 1 and lam == 1:
                lam = (norm_orig / max(norm, 1e-38)) / 12.0
                if self.verbose:
                    print(f"  lambda {lam}")
            with timed_phase("sweep"):
                filtered = _localdeblur_sweep(residual, resvol_j, res_list,
                                              wl_list, K, Ts)
                vk = v_orig if i == 1 else sharpened
                sharpened = torch.clamp_min(vk + lam * filtered,
                                            -4.0 * desv_outside)
            filtered = sharpened
            iters_done = i
            if converged:
                break

        save_image(self.getParam("-o"), sharpened.cpu().numpy(),
                   sampling=Ts)
        MetaData.fromRows([{"iterationNumber": iters_done,
                            "cost": float(lam)}]).write(
            self.getParam("--md"))


class ProgTransformMorphology(XmippMetadataProgram):
    name = "xmipp_transform_morphology"

    def defineProcessParams(self):
        self.addUsageLine("Morphological operations on binary or gray "
                          "images (transform_morphology.cpp:61-91).")
        self.addParamsLine("[--binaryOperation <op>] : Morphological operation on binary images")
        self.addParamsLine("    where <op>")
        self.addParamsLine("       dilation : Dilate white region")
        self.addParamsLine("       erosion  : Erode white region")
        self.addParamsLine("       closing  : Dilation+Erosion, removes black spots")
        self.addParamsLine("       opening  : Erosion+Dilation, removes white spots")
        self.addParamsLine("       keepBiggest : Keep the biggest connected component")
        self.addParamsLine("       removeSmall <size=10> : Remove components smaller than this size")
        self.addParamsLine("[--grayOperation <op>] : Morphological operation on gray images")
        self.addParamsLine("    where <op>")
        self.addParamsLine("       sharpening <w=1> <s=0.5> : Morphological toggle sharpening with width w and strength s")
        self.addParamsLine("[--neigh2D <n=Neigh8>] : 2D neighbourhood: Neigh4|Neigh8")
        self.addParamsLine("     requires --binaryOperation;")
        self.addParamsLine("[--neigh3D <n=Neigh18>] : 3D neighbourhood: Neigh6|Neigh18|Neigh26")
        self.addParamsLine("     requires --binaryOperation;")
        self.addParamsLine("[--size <s=1>] : Size of the structural element")
        self.addParamsLine("     requires --binaryOperation;")
        self.addParamsLine("[--count <c=0>] : Minimum required neighbors with distinct value")
        self.addParamsLine("     requires --binaryOperation;")

    def readProcessParams(self):
        self.op = None
        self.gray_op = None
        if self.checkParam("--binaryOperation"):
            toks = self.getListParam("--binaryOperation")
            self.op = toks[0]
            self.small_size = int(float(toks[1])) if len(toks) > 1 else 10
        elif self.checkParam("--grayOperation"):
            toks = self.getListParam("--grayOperation")
            self.gray_op = toks[0]
            self.gray_w = int(float(toks[1])) if len(toks) > 1 else 1
            self.gray_s = float(toks[2]) if len(toks) > 2 else 0.5
        else:
            raise XmippError(ErrCode.ARG_MISSING,
                             "--binaryOperation or --grayOperation required")
        self.size = (self.getIntParam("--size")
                     if self.checkParam("--size") else 1)
        self.count = (self.getIntParam("--count")
                      if self.checkParam("--count") else 0)
        self.neigh2d = (self.getParam("--neigh2D")
                        if self.checkParam("--neigh2D") else "Neigh8")
        self.neigh3d = (self.getParam("--neigh3D")
                        if self.checkParam("--neigh3D") else "Neigh18")

    def _structure(self, ndim):
        from scipy import ndimage
        if ndim == 2:
            conn = 1 if self.neigh2d == "Neigh4" else 2
        else:
            conn = {"Neigh6": 1, "Neigh18": 2, "Neigh26": 3}.get(
                self.neigh3d, 2)
        return ndimage.generate_binary_structure(ndim, conn)

    def _binary(self, b):
        from scipy import ndimage
        st = self._structure(b.ndim)
        it = self.size

        def dil(x):
            if self.count > 0:
                # reference dilate2D/3D count semantics: a black pixel turns
                # white only when >= count neighbors are white
                for _ in range(it):
                    xi = x.astype(np.int32)
                    nb = ndimage.convolve(xi, st.astype(np.int32),
                                          mode="constant") - xi
                    x = x | (nb >= self.count)
                return x
            return ndimage.binary_dilation(x, st, iterations=it)

        def ero(x):
            if self.count > 0:
                for _ in range(it):
                    inv = (~x).astype(np.int32)
                    nb = ndimage.convolve(inv, st.astype(np.int32),
                                          mode="constant") - inv
                    x = x & ~(nb >= self.count)
                return x
            return ndimage.binary_erosion(x, st, iterations=it)

        if self.op == "dilation":
            return dil(b)
        if self.op == "erosion":
            return ero(b)
        if self.op == "opening":
            return dil(ero(b))
        if self.op == "closing":
            return ero(dil(b))
        if self.op == "keepBiggest":
            lab, n = ndimage.label(b, structure=st)
            if n == 0:
                return b
            sizes = ndimage.sum_labels(np.ones_like(lab), lab,
                                       index=np.arange(1, n + 1))
            return lab == (1 + int(np.argmax(sizes)))
        if self.op == "removeSmall":
            lab, n = ndimage.label(b, structure=st)
            if n == 0:
                return b
            sizes = ndimage.sum_labels(np.ones_like(lab), lab,
                                       index=np.arange(1, n + 1))
            keep = np.concatenate([[False], sizes >= self.small_size])
            return keep[lab]
        raise ValueError(f"unknown binaryOperation {self.op}")

    def _sharpen(self, img):
        """Morphological toggle sharpening (Schavemaker et al. 2000):
        replace each voxel by its dilation or erosion, whichever is closer,
        blended by the strength."""
        from scipy import ndimage
        sz = 2 * self.gray_w + 1
        D = ndimage.grey_dilation(img, size=(sz,) * img.ndim)
        E = ndimage.grey_erosion(img, size=(sz,) * img.ndim)
        toggle = np.where(D - img < img - E, D, E)
        return (1.0 - self.gray_s) * img + self.gray_s * toggle

    def processBatch(self, imgs, rows):
        out = np.empty_like(imgs)
        for i in range(len(imgs)):
            if self.gray_op == "sharpening":
                out[i] = self._sharpen(imgs[i].astype(np.float64))
            else:
                out[i] = self._binary(imgs[i] > 0.5).astype(np.float32)
        return out


class ProgTransformCenterImage(XmippMetadataProgram):
    name = "xmipp_transform_center_image"

    def defineProcessParams(self):
        self.addUsageLine("Center images by the symmetry of their "
                          "autocorrelation (180° self-alignment).")
        self.addParamsLine("[--iter <n=10>] : Number of centering iterations")
        self.addParamsLine("[--limit <l=-1>] : Maximum shift allowed per iteration")
        self.addParamsLine("[--save_metadata_transform] : Save the applied shifts in the output metadata")

    def readProcessParams(self):
        self.n_iter = (self.getIntParam("--iter")
                       if self.checkParam("--iter") else 10)
        self.limit = (self.getDoubleParam("--limit")
                      if self.checkParam("--limit") else -1.0)
        self.save_transform = self.checkParam("--save_metadata_transform")

    def processBatch(self, imgs, rows):
        """The batch on the card: each iteration shifts every image by
        half its shift against its own 180-degree rotation (one host read
        of the largest step, the reference's stop test)."""
        from xmipp3_tpu_torch.ops.fourier import fourier_shift_2d
        from xmipp3_tpu_torch.ops.shift import best_shift
        I = as_tensor(imgs, self.device)
        total_sx = torch.zeros(len(I), device=I.device)
        total_sy = torch.zeros(len(I), device=I.device)
        cur = I
        for _ in range(max(1, self.n_iter)):
            rot180 = torch.flip(cur, dims=(-2, -1))
            sx, sy, _ = best_shift(cur, rot180)
            dx, dy = -sx / 2, -sy / 2
            if self.limit > 0:
                dx = torch.clamp(dx, -self.limit, self.limit)
                dy = torch.clamp(dy, -self.limit, self.limit)
            step = torch.stack([dx.abs().max(), dy.abs().max()]).cpu()
            if float(step[0]) < 0.05 and float(step[1]) < 0.05:
                break
            total_sx = total_sx + dx
            total_sy = total_sy + dy
            cur = fourier_shift_2d(I, total_sx, total_sy)
        if self.save_transform:
            sxy = torch.stack([total_sx, total_sy]).cpu().numpy()
            for i, r in enumerate(rows):
                r["shiftX"] = float(sxy[0, i])
                r["shiftY"] = float(sxy[1, i])
        return cur


PROGRAM = None
