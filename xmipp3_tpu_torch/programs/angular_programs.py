"""Angular programs: continuous_assign2, continuous_assign, class_average,
neighbourhood, subtract_projection, image_residuals.

Contracts: the reference package's programs/angular_programs.py (reference
angular_continuous_assign2 (angular_continuous_assign2.h:46),
angular_continuous_assign, angular_class_average, angular_neighbourhood,
subtract_projection (subtract_projection.h:47), image_residuals). The
images, volumes and projections live on the card (--device; the card by
default), and so do image_residuals' float64 covariance chain; metadata,
the --pcaSorting SVD, the Wiener filter of the averages and the
noise-estimation crops stay host numpy, as in the reference.

angular_class_average --mesh dp (parallel/engines.py::parallel_class_sums)
draws its --split halves as the serial path does, one permutation a class
from the same Generator, so that mesh and serial halves are the same
images; the reference's mesh path draws them otherwise (ROADMAP §3).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import load_image_rows
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import resolve_device
from xmipp3_tpu_torch.parallel.cli import MeshProgram, add_mesh_params


def _load_md(fn):
    md = MetaData(fn)
    md.removeDisabled()
    rows = list(md.iterRows())
    with timed_phase("read images"):
        imgs = load_image_rows(rows)
    get = lambda k, d=0.0: np.array([float(r.get(k, d)) for r in rows],
                                    np.float32)
    return md, rows, imgs, get


def _ncc_rows(P, I):
    """Per-image correlation coefficient of two (B, N, N) tensors."""
    Pc = P - P.mean(dim=(1, 2), keepdim=True)
    Ic = I - I.mean(dim=(1, 2), keepdim=True)
    den = (Pc.std(dim=(1, 2), correction=0)
           * Ic.std(dim=(1, 2), correction=0)).clamp(min=1e-12)
    return (Pc * Ic).mean(dim=(1, 2)) / den


class ProgAngularContinuousAssign2(XmippProgram):
    """Reference grammar: angular_continuous_assign2.cpp:120-142."""
    name = "xmipp_angular_continuous_assign2"

    def defineParams(self):
        self.addUsageLine("Continuous refinement of angular assignment "
                          "(gradient ascent on correlation through the "
                          "differentiable projector).")
        self.addParamsLine("   -i <md_file>  : Particles with initial poses")
        self.addParamsLine("   -o <md_file>  : Refined poses")
        self.addParamsLine("   --ref <volume> : Reference volume")
        self.addParamsLine("  [--optimizeAngles] : Refine the Euler angles")
        self.addParamsLine("  [--optimizeShift] : Refine shifts")
        self.addParamsLine("  [--optimizeScale] : Refine magnification")
        self.addParamsLine("  [--optimizeGray]  : Optimize gray scale a and shift b (reference continuous2cost a,b terms)")
        self.addParamsLine("  [--optimizeDefocus] : Optimize per-particle defocus (requires CTF columns in the metadata)")
        self.addParamsLine("  [--max_shift <s=-1>] : Maximum shift allowed (px; -1 = unbounded)")
        self.addParamsLine("  [--max_scale <s=0.02>] : Maximum scale change")
        self.addParamsLine("  [--max_angular_change <a=5>] : Maximum angular change (deg)")
        self.addParamsLine("  [--max_defocus_change <d=500>] : Maximum defocus change (Angstrom)")
        self.addParamsLine("  [--max_resolution <f=4>] : Maximum resolution (Angstrom)")
        self.addParamsLine("  [--max_gray_scale <a=0.05>] : Maximum gray scale change")
        self.addParamsLine("  [--max_gray_shift <b=0.05>] : Maximum gray shift as a factor of the image stddev")
        self.addParamsLine("  [--Rmax <R=-1>]   : Evaluation radius (px; -1 = half the image size)")
        self.addParamsLine("  [--ignoreCTF]     : Ignore CTF columns even if present")
        self.addParamsLine("  [--sameDefocus]   : Force defocusU = defocusV during refinement")
        self.addParamsLine("  [--applyTo <label=image>] : Image column the final in-plane transform is applied to")
        self.addParamsLine("  [--oresiduals <stack=\"\">] : Output stack for the residuals")
        self.addParamsLine("  [--oprojections <stack=\"\">] : Output stack for the model projections")
        self.addParamsLine("  [--phaseFlipped]  : Images have been phase flipped")
        self.addParamsLine("  [--sampling <Ts=1>] : Pixel size (Angstrom)")
        self.addParamsLine("  [--steps <n=60>] : Optimization steps")
        self.addParamsLine("  [--padding <p=2>] : Projector padding")

    def run(self):
        from xmipp3_tpu_torch.ops.continuous import (continuous_assign,
                                                     continuous_assign_full)
        dev = resolve_device(self.getParam("--device"))
        md, rows, imgs, get = _load_md(self.getParam("-i"))
        vol = np.squeeze(Image(self.getParam("--ref")).data).astype(np.float32)
        opt_ang = self.checkParam("--optimizeAngles")
        opt_shift = self.checkParam("--optimizeShift")
        opt_scale = self.checkParam("--optimizeScale")
        opt_gray = self.checkParam("--optimizeGray")
        opt_def = self.checkParam("--optimizeDefocus")
        Ts = self.getDoubleParam("--sampling")
        max_freq = min(Ts / self.getDoubleParam("--max_resolution"), 0.5) \
            if self.checkParam("--max_resolution") else 0.35
        ms = self.getDoubleParam("--max_shift")
        max_shift = ms if ms >= 0 else None
        mac = self.getDoubleParam("--max_angular_change") \
            if self.checkParam("--max_angular_change") else None
        Rmax = self.getDoubleParam("--Rmax")
        fn_res = self.getParam("--oresiduals")
        fn_proj = self.getParam("--oprojections")
        full_needed = (opt_gray or opt_def or opt_scale or Rmax > 0
                       or bool(fn_res) or bool(fn_proj))
        sx0 = get("shiftX") if opt_shift else None
        sy0 = get("shiftY") if opt_shift else None
        imgs_d = torch.as_tensor(imgs, device=dev)
        if full_needed:
            has_ctf = (not self.checkParam("--ignoreCTF")
                       and any("ctfDefocusU" in r for r in rows[:1]))
            with timed_phase("refine (full)"):
                res = continuous_assign_full(
                    vol, imgs_d, get("angleRot"), get("angleTilt"),
                    get("anglePsi"), sx0, sy0,
                    defU0=get("ctfDefocusU") if has_ctf else None,
                    defV0=get("ctfDefocusV") if has_ctf else None,
                    def_ang=get("ctfDefocusAngle") if has_ctf else None,
                    Ts=Ts, optimize_gray=opt_gray, optimize_defocus=opt_def,
                    optimize_angles=opt_ang, optimize_shift=opt_shift,
                    optimize_scale=opt_scale,
                    phase_flipped=self.checkParam("--phaseFlipped"),
                    same_defocus=self.checkParam("--sameDefocus"),
                    n_steps=self.getIntParam("--steps"),
                    pad_factor=self.getDoubleParam("--padding"),
                    max_freq=max_freq, Rmax=Rmax if Rmax > 0 else None,
                    max_angular_change=mac, max_shift=max_shift,
                    max_scale=self.getDoubleParam("--max_scale")
                    if opt_scale else None,
                    max_defocus_change=self.getDoubleParam(
                        "--max_defocus_change") if opt_def else None,
                    max_gray_scale=self.getDoubleParam("--max_gray_scale")
                    if opt_gray else None,
                    max_gray_shift=self.getDoubleParam("--max_gray_shift")
                    if opt_gray else None,
                    compute_outputs=bool(fn_res) or bool(fn_proj),
                    verbose=self.verbose, device=dev)
            if fn_res:
                save_image(fn_res, res["residuals"])
            if fn_proj:
                save_image(fn_proj, res["projections"])
        else:
            with timed_phase("refine"):
                res = continuous_assign(
                    vol, imgs_d, get("angleRot"), get("angleTilt"),
                    get("anglePsi"), sx0, sy0,
                    lr_angles=0.5 if opt_ang else 0.0,
                    lr_shifts=0.2 if opt_shift else 0.0,
                    n_steps=self.getIntParam("--steps"),
                    pad_factor=self.getDoubleParam("--padding"),
                    max_freq=max_freq, max_angular_change=mac,
                    max_shift=max_shift, verbose=self.verbose, device=dev)
        # maxCC must be a true correlation; the full path's cost is a
        # (negated) residual ratio, so recompute NCC against the final
        # model projections when they are available
        if "projections" in res:
            maxcc = _ncc_rows(torch.as_tensor(res["projections"],
                                              device=dev),
                              imgs_d).cpu().numpy()
        else:
            maxcc = np.asarray(res["cost"])
        self.result = res
        out_rows = []
        for i, r in enumerate(rows):
            d = dict(r)
            d.update({"angleRot": float(res["rot"][i]),
                      "angleTilt": float(res["tilt"][i]),
                      "anglePsi": float(res["psi"][i]),
                      "shiftX": float(res["sx"][i]),
                      "shiftY": float(res["sy"][i]),
                      "cost": float(res["cost"][i]),
                      "maxCC": float(maxcc[i])})
            if "scale" in res:
                d["scale"] = float(res["scale"][i])
            if "grayA" in res:
                d["continuousA"] = float(res["grayA"][i])
                d["continuousB"] = float(res["grayB"][i])
            if "defocusU" in res:
                d["ctfDefocusU"] = float(res["defocusU"][i])
                d["ctfDefocusV"] = float(res["defocusV"][i])
            out_rows.append(d)
        # --applyTo: write the images (from the given column) registered
        # by the refined in-plane pose (angular_continuous_assign2.cpp:599)
        if self.checkParam("--applyTo"):
            from xmipp3_tpu_torch.ops.geo import (apply_affine_2d,
                                                  metadata_alignment_matrices)
            label = self.getParam("--applyTo")
            src = imgs_d if label == "image" else torch.as_tensor(
                load_image_rows([dict(r, image=r[label]) for r in rows]),
                device=dev)
            A = metadata_alignment_matrices(
                res["psi"], res["sx"], res["sy"], scale=res.get("scale"),
                device=dev)
            reg = apply_affine_2d(src, A).cpu().numpy()
            stem = os.path.splitext(self.getParam("-o"))[0]
            fn_stk = stem + "_aligned.stk"
            save_image(fn_stk, reg)
            for i, d in enumerate(out_rows):
                d["image"] = f"{i + 1:06d}@{fn_stk}"
        MetaData.fromRows(out_rows).write(self.getParam("-o"))
        self.mean_cost = float(np.asarray(res["cost"]).mean())


class ProgAngularContinuousAssign(XmippProgram):
    """Wavelet-space continuous angular assignment — the ORIGINAL
    algorithm (reference angular_continuous_assign.{h,cpp}:39, Jonic 2005:
    image/projection matching in DWT space), distinct from assign2's
    Fourier-weighted NCC. The residual is evaluated on the multi-level
    Haar coefficient pyramid with the finest band down-weighted."""
    name = "xmipp_angular_continuous_assign"

    def defineParams(self):
        self.addUsageLine("Continuous angular assignment in wavelet space "
                          "(multiscale DWT-domain matching).")
        self.addParamsLine("   -i <md_file>  : Particles with initial poses")
        self.addParamsLine("   -o <md_file>  : Refined poses")
        self.addParamsLine("   --ref <volume> : Reference volume")
        self.addParamsLine("  [--optimizeShift] : Also refine shifts")
        self.addParamsLine("  [--steps <n=60>] : Optimization steps")
        self.addParamsLine("     alias --max_iter;")
        self.addParamsLine("  [--padding <p=2>] : Projector padding")
        self.addParamsLine("  [--gaussian_Fourier <s=0.5>] : Weighting "
                           "sigma in Fourier space")
        self.addParamsLine("  [--gaussian_Real <s=0.5>] : Weighting sigma "
                           "in real space (fraction of the image size)")
        self.addParamsLine("  [--zerofreq_weight <s=0.>] : Zero-frequency "
                           "weight")
        self.addParamsLine("  [--max_angular_change <a=-1>] : Maximum "
                           "angular change (deg; -1 = unbounded)")
        self.addParamsLine("  [--max_shift <s=-1>] : Maximum shift (px; "
                           "-1 = unbounded)")

    def run(self):
        from xmipp3_tpu_torch.ops.continuous import continuous_assign
        dev = resolve_device(self.getParam("--device"))
        md, rows, imgs, get = _load_md(self.getParam("-i"))
        vol = np.squeeze(Image(self.getParam("--ref")).data).astype(np.float32)
        mac = self.getDoubleParam("--max_angular_change")
        ms = self.getDoubleParam("--max_shift")
        shift = self.checkParam("--optimizeShift")
        with timed_phase("refine"):
            res = continuous_assign(
                vol, imgs, get("angleRot"), get("angleTilt"),
                get("anglePsi"), get("shiftX") if shift else None,
                get("shiftY") if shift else None,
                n_steps=self.getIntParam("--steps"),
                pad_factor=self.getDoubleParam("--padding"),
                verbose=self.verbose, domain="wavelet",
                max_angular_change=mac if mac >= 0 else None,
                max_shift=ms if ms >= 0 else None,
                gaussian_fourier=self.getDoubleParam("--gaussian_Fourier"),
                gaussian_real=self.getDoubleParam("--gaussian_Real"),
                zerofreq_weight=self.getDoubleParam("--zerofreq_weight"),
                device=dev)
        self.result = res
        out_rows = []
        for i, r in enumerate(rows):
            d = dict(r)
            d.update({"angleRot": float(res["rot"][i]),
                      "angleTilt": float(res["tilt"][i]),
                      "anglePsi": float(res["psi"][i]),
                      "shiftX": float(res["sx"][i]),
                      "shiftY": float(res["sy"][i]),
                      "cost": float(res["cost"][i]),
                      "maxCC": float(res["cost"][i])})
            out_rows.append(d)
        MetaData.fromRows(out_rows).write(self.getParam("-o"))
        self.mean_cost = float(res["cost"].mean())


class ProgAngularClassAverage(MeshProgram):
    name = "xmipp_angular_class_average"

    def defineParams(self):
        self.addUsageLine("Compute class averages from an angular assignment "
                          "(one average per reference; full reference "
                          "grammar, mpi_angular_class_average.cpp).")
        self.addParamsLine("   -i <md_file>  : Assignment metadata (ref/psi/shift/flip)")
        self.addParamsLine("   --lib <md_file> : Gallery metadata (ref angles)")
        self.addParamsLine("   -o <root>     : Output rootname")
        self.addParamsLine("  [--split] : Also output averages of random "
                           "halves of the data (_split1/_split2)")
        self.addParamsLine("  [--wien <img=\"\">] : Apply this Wiener "
                           "filter image to the averages")
        self.addParamsLine("  [--pad <factor=1.>] : Padding factor for the "
                           "Wiener correction")
        self.addParamsLine("  [--save_images_assigned_to_classes] : Save "
                           "per-class image blocks in <root>_images.xmd")
        self.addParamsLine("     alias --siatc;")
        self.addParamsLine("  [--select <col=maxCC>] : Column used for "
                           "image selection")
        self.addParamsLine("  [--limit0 <l0=-1e30>] : Discard images below")
        self.addParamsLine("  [--limitF <lF=1e30>] : Discard images above")
        self.addParamsLine("  [--limitRclass <lRc=0>] : Discard the lowest "
                           "(>0) / highest (<0) percent in each class")
        self.addParamsLine("  [--limitRper <lRp=0>] : Discard the lowest "
                           "(>0) / highest (<0) percent globally")
        self.addParamsLine("  [--pcaSorting] : Reject first-PC outliers "
                           "(|z|>2.5) before averaging")
        self.addParamsLine("  [--iter <nr_iter=0>] : Re-alignment "
                           "iterations of each class against its average")
        self.addParamsLine("  [--Ri <ri=1>] : Inner radius of the "
                           "rotational search")
        self.addParamsLine("  [--Ro <r0=-1>] : Outer radius (-1 = dim/2-1)")
        add_mesh_params(self)

    def readParams(self):
        from xmipp3_tpu_torch.parallel.cli import read_mesh_params
        self.device_arg = self.getParam("--device")
        read_mesh_params(self)

    def _selection(self, rows, assign):
        """The --select/--limit* keep mask (B,) and the score column."""
        col = self.getParam("--select")
        score = np.array([float(r.get(col, 0.0)) for r in rows])
        keep = ((score >= self.getDoubleParam("--limit0"))
                & (score <= self.getDoubleParam("--limitF")))
        lRp = self.getDoubleParam("--limitRper")
        if 0 < abs(lRp) < 100:
            thr = np.percentile(score, abs(lRp))
            keep &= (score >= thr) if lRp > 0 else (
                score <= np.percentile(score, 100 - abs(lRp)))
        lRc = self.getDoubleParam("--limitRclass")
        if 0 < abs(lRc) < 100:
            for k in np.unique(assign):
                sel = np.where(assign == k)[0]
                if len(sel) < 2:
                    continue
                thr = np.percentile(score[sel], abs(lRc))
                if lRc > 0:
                    keep[sel] &= score[sel] >= thr
                else:
                    keep[sel] &= score[sel] <= np.percentile(
                        score[sel], 100 - abs(lRc))
        return keep

    def _run(self, mesh):
        from xmipp3_tpu_torch.ops.geo import apply_md_geometry
        dev = self.device
        md, rows, imgs, get = _load_md(self.getParam("-i"))
        md_lib = MetaData(self.getParam("--lib"))
        refs = md_lib.getColumn("ref") if md_lib.containsLabel("ref") else \
            np.arange(1, md_lib.size() + 1)
        assign = get("ref").astype(int)
        keep = self._selection(rows, assign)
        n_iter = self.getIntParam("--iter")
        pca = self.checkParam("--pcaSorting")
        split = self.checkParam("--split")
        save_assigned = self.checkParam("--save_images_assigned_to_classes")
        use_mesh_sums = (mesh is not None and n_iter == 0 and not pca
                         and not save_assigned)
        root = self.getParam("-o")
        n_refs = int(refs.max())
        H = imgs.shape[-1]
        Ri = self.getIntParam("--Ri")
        Ro = self.getIntParam("--Ro")
        if Ro <= 0:
            Ro = H // 2 - 1
        rng = np.random.default_rng(0)
        avgs = torch.zeros((n_refs, H, H), device=dev)
        counts = np.zeros(n_refs, int)
        splits = torch.zeros((2, n_refs, H, H), device=dev)
        scounts = np.zeros((2, n_refs), int)
        flip = np.array([bool(r.get("flip", 0)) for r in rows])
        if use_mesh_sums:
            from xmipp3_tpu_torch.parallel.engines import parallel_class_sums
            if self.verbose:
                print(f"mesh: dp class accumulation over {mesh.size} ranks")
            halves = np.zeros((2, len(rows)), np.float32)
            if split:
                # the serial path's halves: one permutation a non-empty
                # class, from the same Generator, in class order
                for k in range(1, n_refs + 1):
                    sel = np.where((assign == k) & keep)[0]
                    if len(sel):
                        half = rng.permutation(len(sel))
                        halves[0, sel[half[: len(sel) // 2]]] = 1.0
                        halves[1, sel[half[len(sel) // 2:]]] = 1.0
            weights = [keep.astype(np.float32)] + (list(halves) if split
                                                   else [])
            with timed_phase("class sums"):
                for j, w in enumerate(weights):
                    sums, cnts = parallel_class_sums(
                        mesh, imgs, get("anglePsi"), get("shiftX"),
                        get("shiftY"), flip.astype(np.float32), assign - 1,
                        n_refs, sel_weights=w)
                    nz = cnts > 0
                    out = avgs if j == 0 else splits[j - 1]
                    out[torch.as_tensor(nz, device=dev)] = torch.as_tensor(
                        sums[nz] / cnts[nz, None, None], device=dev)
                    (counts if j == 0 else scounts[j - 1])[:] = \
                        cnts.astype(int)
        else:
            with timed_phase("register"):
                registered = apply_md_geometry(
                    imgs, get("anglePsi"), get("shiftX"), get("shiftY"),
                    flip, device=dev)
            with timed_phase("class averages", sync=registered):
                self._serial(registered, rows, assign, keep, rng, avgs,
                             counts, splits, scounts, n_iter, Ri, Ro, root)
        if self.writer:
            self._write(md_lib, root, avgs.cpu().numpy(),
                        splits.cpu().numpy() if split else None, counts, H)

    def _serial(self, registered, rows, assign, keep, rng, avgs, counts,
                splits, scounts, n_iter, Ri, Ro, root):
        first_block = True
        dev = registered.device
        for k in range(1, len(avgs) + 1):
            sel = np.where((assign == k) & keep)[0]
            if len(sel) == 0:
                continue
            members = registered[torch.as_tensor(sel, device=dev)]
            if self.checkParam("--pcaSorting") and len(sel) > 2:
                flat = members.reshape(len(sel), -1).cpu().numpy()
                flat0 = flat - flat.mean(0)
                _, _, vt = np.linalg.svd(flat0, full_matrices=False)
                pc = flat0 @ vt[0]
                z = (pc - pc.mean()) / max(pc.std(), 1e-12)
                inliers = np.abs(z) <= 2.5
                members = members[torch.as_tensor(inliers, device=dev)]
                sel = sel[inliers]
            avg = members.mean(dim=0)
            if n_iter > 0 and len(members) > 1:
                from xmipp3_tpu_torch.ops.align import iterative_align
                for _ in range(n_iter):
                    _, _, _, _, members = iterative_align(
                        avg, members, n_iters=2, radius_min=max(Ri, 1),
                        radius_max=Ro)
                    avg = members.mean(dim=0)
            avgs[k - 1] = avg
            counts[k - 1] = len(members)
            if self.checkParam("--split"):
                half = rng.permutation(len(members))
                h1 = half[: len(members) // 2]
                h2 = half[len(members) // 2:]
                for hi, hs in enumerate((h1, h2)):
                    if len(hs):
                        splits[hi, k - 1] = members[
                            torch.as_tensor(hs, device=dev)].mean(dim=0)
                        scounts[hi, k - 1] = len(hs)
            if self.checkParam("--save_images_assigned_to_classes") and \
                    self.writer:
                MetaData.fromRows([dict(rows[i]) for i in sel]).write(
                    root + "_images.xmd", block=f"class{k:06d}_images",
                    append=not first_block)
                first_block = False

    def _write(self, md_lib, root, avgs, splits, counts, H):
        if self.checkParam("--wien") and self.getParam("--wien"):
            wien = np.squeeze(Image(self.getParam("--wien")).data
                              ).astype(np.float32)
            pad = max(1.0, self.getDoubleParam("--pad"))
            P = int(round(H * pad))
            spec = np.fft.rfft2(avgs, s=(P, P))
            if wien.shape[-1] != spec.shape[-1]:
                # center-crop/pad the filter to the padded rfft grid
                full = np.fft.fftshift(wien)
                fy = np.fft.fftfreq(P)[:, None]
                fx = np.fft.rfftfreq(P)[None, :]
                wy = (np.clip((fy + 0.5) * wien.shape[0], 0,
                              wien.shape[0] - 1)).astype(int)
                wx = (np.clip((np.abs(fx)) * wien.shape[1], 0,
                              wien.shape[1] - 1)).astype(int)
                wgrid = full[wy, wx]
            else:
                wgrid = wien
            avgs = np.fft.irfft2(spec * wgrid, s=(P, P)
                                 )[:, :H, :H].astype(np.float32)
        save_image(root + ".stk", avgs)
        if splits is not None:
            save_image(root + "_split1.stk", splits[0])
            save_image(root + "_split2.stk", splits[1])
        out_rows = []
        for k in range(len(avgs)):
            d = {"ref": k + 1, "image": f"{k + 1:06d}@{root}.stk",
                 "classCount": int(counts[k])}
            lib_row = md_lib.getRow(k) if k < md_lib.size() else {}
            for key in ("angleRot", "angleTilt"):
                if key in lib_row:
                    d[key] = lib_row[key]
            out_rows.append(d)
        MetaData.fromRows(out_rows).write(root + ".xmd")


class ProgAngularNeighbourhood(XmippProgram):
    name = "xmipp_angular_neighbourhood"

    def defineParams(self):
        self.addUsageLine("For each reference direction, list experimental "
                          "images within an angular neighbourhood.")
        self.addParamsLine("   --i1 <md_exp>  : Experimental angles")
        self.addParamsLine("   --i2 <md_ref>  : Reference directions")
        self.addParamsLine("   -o <md_file>   : Output neighborhood metadata")
        self.addParamsLine("  [--dist <d=10>] : Neighbourhood radius (deg)")
        self.addParamsLine("  [--sym <s=c1>]  : Symmetry")
        self.addParamsLine("  [--check_mirrors] : Also accept antipodal "
                           "(mirrored) directions")

    def run(self):
        from xmipp3_tpu_torch.core.sampling import compute_neighbors
        from xmipp3_tpu_torch.core.sym import SymList
        md_exp = MetaData(self.getParam("--i1"))
        md_ref = MetaData(self.getParam("--i2"))
        a_exp = np.stack([md_exp.getColumn("angleRot").astype(float),
                          md_exp.getColumn("angleTilt").astype(float)], axis=1)
        a_ref = np.stack([md_ref.getColumn("angleRot").astype(float),
                          md_ref.getColumn("angleTilt").astype(float)], axis=1)
        sym = SymList(self.getParam("--sym"))
        nbrs = compute_neighbors(a_ref, a_exp, self.getDoubleParam("--dist"),
                                 sym,
                                 check_mirrors=self.checkParam(
                                     "--check_mirrors"))
        rows = []
        for k, nb in enumerate(nbrs):
            rows.append({"ref": k + 1, "neighbors": np.asarray(nb + 1,
                                                               np.float64),
                         "count": len(nb)})
        MetaData.fromRows(rows).write(self.getParam("-o"))
        self.neighbors = nbrs


def _subtract_adjust_batch(I, P, Pmask, iM, wi, maxwi):
    """Frequency-transfer adjustment + subtraction for one batch (tensors).

    Reference subtract_projection.cpp:636-812: background level b, then
    order-0 (T(w)=beta00) and order-1 (T(w)=beta01+beta1*w) multiplicative
    fits of the projection's spectrum against the particle's over rings
    0<w<maxwi, adjusted-R2 model selection per particle. Returns the
    adjusted projection spectrum (rfft), b, betas and R2.
    """
    inside = (iM > 0) & (Pmask > 0)
    n_in = inside.sum(dim=(1, 2)).clamp(min=1)
    b = torch.where(inside, I - P, 0.0).sum(dim=(1, 2)) / n_in
    I = I - b[:, None, None]
    IF = torch.fft.rfft2(I)
    PF = torch.fft.rfft2(P)
    IiM = torch.fft.rfft2(I * iM)
    PiM = torch.fft.rfft2(P * iM)
    sel = ((wi > 0) & (wi < maxwi))[None]
    p2 = torch.where(sel, (PiM * torch.conj(PiM)).real, 0.0)
    ip = torch.where(sel, (IiM * torch.conj(PiM)).real, 0.0)
    w = wi[None].to(torch.float32)
    # order 0
    beta00 = ip.sum(dim=(1, 2)) / p2.sum(dim=(1, 2)).clamp(min=1e-20)
    # order 1: least squares of IiM ~ (b0 + b1*w)*PiM (real coefficients)
    a00 = p2.sum(dim=(1, 2))
    a01 = (w * p2).sum(dim=(1, 2))
    a11 = (w * w * p2).sum(dim=(1, 2))
    r0 = ip.sum(dim=(1, 2))
    r1 = (w * ip).sum(dim=(1, 2))
    det = a00 * a11 - a01 * a01
    safe = torch.abs(det) > 1e-20
    sdet = torch.where(safe, det, 1.0)
    beta01 = torch.where(safe, (r0 * a11 - r1 * a01) / sdet, beta00)
    beta1 = torch.where(safe, (a00 * r1 - a01 * r0) / sdet, 0.0)
    # candidate adjusted spectra (order 0 applies only inside the fit band,
    # subtract_projection.cpp:745-752; order 1 everywhere + DC pinned)
    band = (wi < maxwi)[None]
    PF0 = torch.where(band, PF * beta00[:, None, None], PF)
    T1 = beta01[:, None, None] + beta1[:, None, None] * w
    PF1 = PF * T1
    PF1[:, 0, 0] = IiM[:, 0, 0]
    # adjusted R2 against the particle spectrum (evaluateFitting,
    # subtract_projection.cpp:324-341)
    N2 = 2.0 * IF.shape[1] * IF.shape[2]
    meanY = (IF.real + IF.imag).sum(dim=(1, 2)) / N2
    varY = ((IF.real ** 2 + IF.imag ** 2).sum(dim=(1, 2)) / N2
            - meanY ** 2).clamp(min=1e-20)

    def r2(PFa):
        e2 = ((IF - PFa).abs() ** 2).sum(dim=(1, 2))
        return 1.0 - (e2 / N2) / varY

    R20 = r2(PF0)
    R21 = 1.0 - (1.0 - r2(PF1)) * (N2 - 1.0) / (N2 - 2.0)
    use1 = R21 > R20
    PFbest = torch.where(use1[:, None, None], PF1, PF0)
    R2 = torch.where(use1, R21, R20)
    beta0 = torch.where(use1, beta01, beta00)
    beta1 = torch.where(use1, beta1, 0.0)
    T = torch.where(use1[:, None, None], T1,
                    torch.where(band, beta00[:, None, None],
                                torch.ones_like(T1)))
    return I, IF, PFbest, T, b, beta00, beta0, beta1, R2


class ProgSubtractProjection(XmippProgram):
    """Reference grammar subtract_projection.cpp:125-147; algorithm
    subtract_projection.cpp:600-826 (order-0/1 frequency-transfer fit with
    adjusted-R2 model selection, boosting, noise estimation). The CTFs of
    a batch are made in one pass on the card (ops/ctf.py::
    generate_2d_rows)."""
    name = "xmipp_subtract_projection"

    batch = 128

    def defineParams(self):
        self.addUsageLine("Subtract the adjusted reference projection from "
                          "each particle (focused analysis).")
        self.addParamsLine("   -i <md_file>  : Particles with poses")
        self.addParamsLine("   --ref <volume> : Reference volume")
        self.addParamsLine("   -o <root>     : Output rootname")
        self.addParamsLine("  [--mask_roi <m=\"\">] : 3D mask of the region "
                           "of interest to keep (or subtract, with "
                           "--subtract); empty = subtract whole images")
        self.addParamsLine("  [--cirmaskrad <c=-1.0>] : Circular mask radius "
                           "for the projected particles (-1 = fit a sphere "
                           "in the reference volume)")
        self.addParamsLine("  [--mask <mask=\"\">] : 3D mask volume; density "
                           "outside its projection is removed from the "
                           "analysis (alternative to --cirmaskrad)")
        self.addParamsLine("  [--sampling <sampling=1>] : Pixel size (A/px)")
        self.addParamsLine("  [--max_resolution <f=-1>] : Maximum resolution "
                           "(A) up to which the subtraction is fit "
                           "(-1 = sampling rate, i.e. Nyquist)")
        self.addParamsLine("  [--padding <p=2>] : Padding factor for the "
                           "Fourier projector")
        self.addParamsLine("  [--sigma <s=1>] : Decay of the mask-transition "
                           "smoothing filter")
        self.addParamsLine("  [--nonNegative] : Disable particles with "
                           "negative beta0 or R2")
        self.addParamsLine("  [--boost] : Boost original particles by the "
                           "inverse transfer instead of subtracting")
        self.addParamsLine("  [--save <structure=\"\">] : Path for saving "
                           "intermediate files (adjusted projections)")
        self.addParamsLine("  [--subtract] : The ROI mask contains the "
                           "region to SUBTRACT (default: region to keep)")
        self.addParamsLine("  [--realSpaceProjection] : Project the volume "
                           "in real space (avoid Fourier artifacts)")
        self.addParamsLine("  [--ignoreCTF] : Do not consider CTF in the "
                           "subtraction (CTF-corrected particles)")
        self.addParamsLine("  [--noise_est] : Estimate the noise power "
                           "spectrum from the subtracted region "
                           "(writes noisePower.mrc next to the output)")

    @staticmethod
    def _projected_mask(vol, rot, tilt, psi, sx, sy):
        """The binary projection of a 3-D mask at the batch's poses."""
        from xmipp3_tpu_torch.ops.fourier import fourier_shift_2d
        from xmipp3_tpu_torch.ops.project import project_real_space
        Pm = fourier_shift_2d(project_real_space(vol, rot, tilt, psi),
                              -sx, -sy)
        return (Pm > 0.5).to(torch.float32)

    def run(self):
        from xmipp3_tpu_torch.ops.ctf import generate_2d_rows
        from xmipp3_tpu_torch.ops.fourier import fourier_shift_2d
        from xmipp3_tpu_torch.ops.geo import centered_flip
        from xmipp3_tpu_torch.ops.mask import circular_mask
        from xmipp3_tpu_torch.ops.project import (FourierProjector,
                                                  project_real_space)
        from xmipp3_tpu_torch.programs.ctf_correct import _row_ctf

        self.refuse_unread("--sigma", item=13)
        dev = resolve_device(self.getParam("--device"))
        md, rows, imgs, get = _load_md(self.getParam("-i"))
        V = np.squeeze(Image(self.getParam("--ref")).data).astype(np.float32)
        N = V.shape[-1]
        Ts = self.getDoubleParam("--sampling")
        pad = self.getDoubleParam("--padding")
        max_res = self.getDoubleParam("--max_resolution")
        if max_res <= 0:
            max_res = Ts
        subtract_roi = self.checkParam("--subtract")
        boost = self.checkParam("--boost")
        real_space = self.checkParam("--realSpaceProjection")
        ignore_ctf = self.checkParam("--ignoreCTF")
        non_negative = self.checkParam("--nonNegative")
        noise_est = self.checkParam("--noise_est")

        # ROI mask: the volume is multiplied by ivM BEFORE projecting
        # (createMask + preProcess, subtract_projection.cpp:177-198,602-607)
        fn_roi = self.getParam("--mask_roi") if \
            self.checkParam("--mask_roi") else ""
        vM = None
        if fn_roi:
            vM = (np.squeeze(Image(fn_roi).data) > 0).astype(np.float32)
            ivM = vM if subtract_roi else 1.0 - vM
        else:
            ivM = np.ones_like(V)
        Vm = V * ivM
        Vm_d = torch.as_tensor(Vm, device=dev)
        vM_d = None if vM is None else torch.as_tensor(vM, device=dev)

        projector = None if real_space else FourierProjector(Vm, pad,
                                                             device=dev)

        # particle-region mask: projected 3-D mask or raised-cosine circle
        # (preProcess, subtract_projection.cpp:530-546)
        fn_maskvol = self.getParam("--mask") if \
            self.checkParam("--mask") else ""
        cirmaskrad = self.getDoubleParam("--cirmaskrad")
        mask_vol = None
        if fn_maskvol:
            mask_vol = torch.as_tensor(np.squeeze(Image(fn_maskvol).data)
                                       .astype(np.float32), device=dev)
        else:
            if cirmaskrad <= 0:
                cirmaskrad = N / 2.0
            circ = torch.as_tensor(np.asarray(circular_mask(
                (N, N), cirmaskrad, mode="raised_cosine"), np.float32),
                device=dev)

        rot, tilt, psi = get("angleRot"), get("angleTilt"), get("anglePsi")
        sx, sy = get("shiftX"), get("shiftY")
        flip = np.array([bool(r.get("flip", 0)) for r in rows])
        has_ctf = (not ignore_ctf) and rows and (
            "ctfDefocusU" in rows[0] or "ctfModel" in rows[0])
        ctf_cache = {}

        # ring index map and fit band (preProcess,
        # subtract_projection.cpp:556-583)
        fy = np.fft.fftfreq(N).astype(np.float32)[:, None]
        fx = np.fft.rfftfreq(N).astype(np.float32)[None, :]
        wi = torch.as_tensor(np.round(np.sqrt(fx * fx + fy * fy) * N)
                             .astype(np.int32), device=dev)
        maxwi = int(round((Ts / max_res) / np.sqrt(2.0) * N))

        B = len(rows)
        save_proj = self.checkParam("--save") and self.getParam("--save")
        keys = ("out", "proj", "R2", "beta0", "beta1", "b", "beta00")
        parts = {k: [] for k in keys}
        noise_power = np.zeros((N, N // 2 + 1), np.float64)
        crop = 11

        for s in range(0, B, self.batch):
            sl = slice(s, min(s + self.batch, B))
            nb = sl.stop - sl.start
            # model = shift_{-s}(M_x^flip proj) — flip acts before the
            # translation, so flipped rows project with +sx and mirror after
            fb = torch.as_tensor(flip[sl], device=dev)[:, None, None]
            with timed_phase("project"):
                if real_space:
                    P = project_real_space(Vm_d, rot[sl], tilt[sl], psi[sl])
                    P = torch.where(fb, centered_flip(P, axis=2), P)
                    P = fourier_shift_2d(P, -sx[sl], -sy[sl])
                else:
                    shifts = np.stack([np.where(flip[sl], sx[sl], -sx[sl]),
                                       -sy[sl]], axis=1).astype(np.float32)
                    P = projector.project_euler(rot[sl], tilt[sl], psi[sl],
                                                shifts=shifts)
                    P = torch.where(fb, centered_flip(P, axis=2), P)
                if has_ctf:
                    ctfs = generate_2d_rows(
                        [_row_ctf(rows[i], Ts, ctf_cache)
                         for i in range(sl.start, sl.stop)], N, N,
                        device=dev)
                    P = torch.fft.irfft2(torch.fft.rfft2(P) * ctfs, s=(N, N))
            Ib = torch.as_tensor(imgs[sl], device=dev)
            # particle-region mask
            if mask_vol is not None:
                Pm = self._projected_mask(mask_vol, rot[sl], tilt[sl],
                                          psi[sl], sx[sl], sy[sl])
            else:
                Pm = circ.expand(nb, N, N)
            P = torch.where(Pm > 0, P, 0.0)
            Ib = torch.where(Pm > 0, Ib, 0.0)
            # projected ROI mask (processImage,
            # subtract_projection.cpp:643-668)
            if vM_d is not None:
                Mb = self._projected_mask(vM_d, rot[sl], tilt[sl], psi[sl],
                                          sx[sl], sy[sl])
                iM = Mb if subtract_roi else 1.0 - Mb
            else:
                Mb = torch.zeros((nb, N, N), device=dev)
                iM = torch.ones((nb, N, N), device=dev)
            with timed_phase("adjust"):
                (Ib, IF, PFbest, T, b, beta00, beta0, beta1,
                 R2) = _subtract_adjust_batch(Ib, P, Pm, iM, wi, maxwi)
                Padj = torch.fft.irfft2(PFbest, s=(N, N))
                if boost:
                    Idiff = torch.fft.irfft2(
                        IF / torch.where(torch.abs(T) > 1e-12, T, 1.0),
                        s=(N, N))
                else:
                    Idiff = Ib - Padj
            for k, v in zip(keys, (Idiff, Padj if save_proj else None, R2,
                                   beta0, beta1, b, beta00)):
                if v is not None:
                    parts[k].append(v.cpu().numpy())
            if noise_est:
                noise_power += self._noise_power(
                    Pm.cpu().numpy(), Mb.cpu().numpy(), parts["out"][-1],
                    N, crop)
        out, R2a, beta0s, beta1s, bsave, beta00s = (
            np.concatenate(parts[k]) for k in ("out", "R2", "beta0",
                                               "beta1", "b", "beta00"))
        self.subtracted = out
        root = self.getParam("-o")
        save_image(root + ".mrcs", out)
        if save_proj:
            save_image(self.getParam("--save"), np.concatenate(parts["proj"]))
        if noise_est:
            noise_power /= max(B, 1)
            out_dir = os.path.dirname(os.path.abspath(root))
            save_image(os.path.join(out_dir, "noisePower.mrc"),
                       noise_power.astype(np.float32))
        out_rows = []
        for i, r in enumerate(rows):
            d = dict(r)
            d["image"] = f"{i + 1:06d}@{root}.mrcs"
            d["subtractionR2"] = float(R2a[i])
            d["subtractionBeta0"] = float(beta0s[i])
            d["subtractionBeta1"] = float(beta1s[i])
            d["subtractionB"] = float(bsave[i])
            if non_negative and (beta00s[i] < 0 or R2a[i] < 0):
                d["enabled"] = -1
            out_rows.append(d)
        MetaData.fromRows(out_rows).write(root + ".xmd")

    @staticmethod
    def _noise_power(Pm, Mb, Id, N, crop):
        """Deterministic analog of noiseEstimation()
        (subtract_projection.cpp:418-510): the first valid crop of each
        image (inside the particle mask, outside the ROI projection) on a
        coarse grid, its power accumulated at canvas center (host)."""
        acc = np.zeros((N, N // 2 + 1), np.float64)
        scale = (N * N) / float(crop * crop)
        for k in range(len(Id)):
            placed = False
            for y0 in range(0, N - crop, crop):
                for x0 in range(0, N - crop, crop):
                    reg_m = Pm[k, y0:y0 + crop, x0:x0 + crop]
                    reg_r = Mb[k, y0:y0 + crop, x0:x0 + crop]
                    if (reg_m > 0).all() and not (reg_r > 0).any():
                        canvas = np.zeros((N, N), np.float32)
                        c0 = N // 2 - crop // 2
                        canvas[c0:c0 + crop, c0:c0 + crop] = \
                            scale * Id[k, y0:y0 + crop, x0:x0 + crop]
                        spec = np.fft.rfft2(canvas)
                        acc += (spec * spec.conj()).real
                        placed = True
                        break
                if placed:
                    break
        return acc


class ProgImageResiduals(XmippProgram):
    """Full reference surface (program_image_residuals.cpp:37-186):
    per-residual column-covariance matrices (covarianceMatrix,
    data/filters.cpp:1582) written as an output stack, the Jensen-Bregman
    LogDet covariance centroid (10 harmonic-mean iterations, formula (25)
    of Cherian et al. 2013), per-image JBLD divergence to the centroid
    (half the eigenvalues, firstEigs convention), residual mean/stddev
    z-scores, and --normalizeDivergence (d/minD - 1). The (B, W, W)
    covariance batch is one einsum on the card, and the centroid and the
    divergences batched float64 linear algebra there (the reference runs
    the eigen/inverse chain on the host, one image at a time).
    Convenience extension: --ref computes the residuals first via
    subtract_projection."""
    name = "xmipp_image_residuals"

    def defineParams(self):
        self.addUsageLine("Analyze image residuals (covariance divergence "
                          "screening).")
        self.addParamsLine("   -i <md_file>  : Residual images (or "
                          "particles with poses when --ref is given)")
        self.addParamsLine("   -o <root>     : Output rootname "
                          "(root.stk covariances + root.xmd)")
        self.addParamsLine("  [--ref <volume=\"\">] : Reference volume; "
                          "compute residuals first (subtract_projection)")
        self.addParamsLine("  [--normalizeDivergence] : Normalize the "
                          "divergence measure (d/min(d) - 1)")

    @staticmethod
    def _jbld(C1, covs):
        """JBLD divergence of C1 (W, W) to each of covs (B, W, W), float64
        tensors, using only the largest half of the eigenvalues (reference
        computeCovarianceMatrixDivergence). The eigenvalues of C1 @ C2 are
        those of the symmetric L^T C2 L with C1 = L L^T (C1 is the positive
        definite centroid, C2 a covariance), so both spectra come from
        batched eigvalsh."""
        half = C1.shape[0] // 2

        def top_log_sum(lam):
            lam = torch.sort(torch.abs(lam), dim=-1, descending=True)[0]
            lam = lam[..., :half]
            return torch.where(lam > 1e-14, torch.log(lam.clamp(min=1e-300)),
                               0.0).sum(dim=-1)

        L = torch.linalg.cholesky(C1)
        d = top_log_sum(torch.linalg.eigvalsh(0.5 * (C1 + covs)))
        return d - 0.5 * top_log_sum(torch.linalg.eigvalsh(L.T @ covs @ L))

    def run(self):
        from xmipp3_tpu_torch.core.metadata_program import is_metadata_file
        dev = resolve_device(self.getParam("--device"))
        fn_in = self.getParam("-i")
        root = self.getParam("-o")
        if root.endswith((".xmd", ".stk")):
            root = root[:-4]
        if self.checkParam("--ref") and self.getParam("--ref"):
            prog = ProgSubtractProjection()
            prog.read([prog.name, "-i", fn_in,
                       "--ref", self.getParam("--ref"), "-o", root,
                       "--device", str(dev)])
            prog.verbose = 0
            prog.run()
            fn_in = root + ".xmd"
        if is_metadata_file(fn_in):
            md = MetaData(fn_in)
            rows = list(md.iterRows())
            if rows and "imageResidual" in rows[0]:
                imgs = load_image_rows([dict(r, image=r["imageResidual"])
                                        for r in rows])
            else:
                imgs = load_image_rows(rows)
        else:
            imgs = Image.read_stack(fn_in)
            rows = [{"image": f"{i + 1:06d}@{fn_in}"}
                    for i in range(len(imgs))]
        B, H, W = imgs.shape
        f64 = torch.float64
        with timed_phase("covariances"):
            x = torch.as_tensor(imgs, device=dev)
            xc = x - x.mean(dim=1, keepdim=True)       # column means
            covs = torch.einsum("bhi,bhj->bij", xc, xc).to(f64) / (H - 1.0)
            resmean = x.mean(dim=(1, 2)).cpu().numpy()
            resvar = x.std(dim=(1, 2), correction=0).cpu().numpy()

        with timed_phase("divergences", sync=covs):
            # JBLD centroid: 10 harmonic-mean iterations (updateRavg), and
            # each image's divergence to it; float64 on the card
            Ravg = torch.eye(W, dtype=f64, device=dev)
            eye = 1e-12 * torch.eye(W, dtype=f64, device=dev)
            for _ in range(10):
                Rinv = torch.linalg.inv(0.5 * (covs + Ravg) + eye)
                Ravg = torch.linalg.inv(Rinv.mean(dim=0) + eye)
            div = self._jbld(Ravg, covs).cpu().numpy()
            covs = covs.cpu().numpy()
        if self.checkParam("--normalizeDivergence"):
            minD = div.min()
            if abs(minD) > 1e-300:
                div = div / minD - 1.0
        zm = (resmean - resmean.mean()) / max(resmean.std(), 1e-12)
        zv = (resvar - resvar.mean()) / max(resvar.std(), 1e-12)

        fn_stk = root + ".stk"
        save_image(fn_stk, covs.astype(np.float32))
        out_rows = []
        for i, r in enumerate(rows):
            d = dict(r)
            d["imageCovariance"] = f"{i + 1:06d}@{fn_stk}"
            d["zScoreResMean"] = float(abs(zm[i]))
            d["zScoreResVar"] = float(abs(zv[i]))
            d["zScoreResCov"] = float(div[i])
            out_rows.append(d)
        MetaData.fromRows(out_rows).write(root + ".xmd")
        self.divergence = div


PROGRAM = None
