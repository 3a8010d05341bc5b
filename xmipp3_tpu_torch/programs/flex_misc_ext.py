"""The flexibility programs of the reference package's
programs/flex_misc_ext.py: xmipp_nma_alignment, xmipp_flexible_alignment,
xmipp_forward_zernike_subtomos, xmipp_art_zernike3d,
xmipp_forward_art_zernike3d_subtomos and
xmipp_cuda11_forward_art_zernike3d (reference nma_alignment.{h,cpp},
flexible_alignment.cpp, forward_zernike_subtomos.cpp,
forward_art_zernike3d*.cpp, redesigned in the reference package as
cluster-wise SIRT in undeformed frames), and the module's other eight:
xmipp_classify_FTTRI, xmipp_classify_CLTomo_prog,
xmipp_volume_initial_simulated_annealing, xmipp_phantom_transform,
xmipp_volume_to_web, xmipp_resolution_pdb_bfactor,
xmipp_performance_test and xmipp_write_test.

Each runs on the card unless `--device cpu` is given: the per-particle
NMA fits (the warp by the mode fields, the padded cube's FFT and one
central slice a particle, Adam), the --projMatch gallery and its matching
(K4 through ops.match), the subtomogram splat fits, the CTF sign
correction, each cluster's SIRT (its passes grid through K3) and the
undeforming warp. The k-means over the coefficients, the modes and the
metadata stay on the host, as in the reference.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import load_image_rows
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import resolve_device
from xmipp3_tpu_torch.parallel.cli import MeshProgram
from xmipp3_tpu_torch.programs.zernike_programs import _ctf_constants


class ProgNMAAlignment(XmippProgram):
    name = "xmipp_nma_alignment"

    def defineParams(self):
        self.addUsageLine("Align particle images against an atomic/pseudo-"
                          "atomic structure, fitting normal-mode amplitudes "
                          "plus pose (nma_alignment role; batched "
                          "differentiable fitting replaces per-image "
                          "Powell).")
        self.addParamsLine("   -i <md>         : Particles (with initial poses if available)")
        self.addParamsLine("   --pdb <pdb>     : Reference structure")
        self.addParamsLine("   --modes <file>  : Mode list file (one mode filename per line)")
        self.addParamsLine("   -o <md>         : Output with nmaDisplacements")
        self.addParamsLine("  [--odir <outputDir=\".\">] : Output directory")
        self.addParamsLine("  [--resume]       : Resume processing (rows "
                           "already in the output are kept, not re-fit)")
        self.addParamsLine("  [--sampling_rate <Ts=1>] : Pixel size (A)")
        self.addParamsLine("  [--steps <n=60>] : Optimization steps")
        self.addParamsLine("  [--centerPDB]    : Center the structure first")
        self.addParamsLine("  [--filterVol <cutoff=15.>] : Low-pass the "
                           "deformed volume at this cutoff (A) before "
                           "matching")
        self.addParamsLine("  [--fixed_Gaussian <std=-1>] : Rasterize "
                           "pseudo-atoms with this fixed Gaussian sigma "
                           "(A; -1 = default)")
        self.addParamsLine("  [--trustradius_scale <s=1>] : Scales the "
                           "optimizer's initial step sizes")
        self.addParamsLine("  [--mask <m=\"\">] : 2D mask applied to the "
                           "projections of the deformed volume")
        self.addParamsLine("  [--projMatch]    : Initialize poses by "
                           "discrete real-space projection matching "
                           "against the undeformed volume")
        self.addParamsLine("  [--discrAngStep <ang=10>] : Angular step of "
                           "the --projMatch gallery")
        self.addParamsLine("  [--gaussian_Fourier <s=0.5>] : Weighting "
                           "sigma in Fourier space (central-slice method)")
        self.addParamsLine("  [--gaussian_Real <s=0.5>] : Weighting sigma "
                           "in real space")
        self.addParamsLine("  [--zerofreq_weight <s=0.>] : Zero-frequency "
                           "weight")

    def _out_path(self, fn: str) -> str:
        odir = self.getParam("--odir") if self.checkParam("--odir") else "."
        return fn if os.path.isabs(fn) or odir in ("", ".") \
            else os.path.join(odir, fn)

    def _initial_poses(self, vol, imgs, rows, dev):
        """(rot, tilt, psi) tensors: the rows' own, or with --projMatch the
        best gallery direction and in-plane angle of each image."""
        if not self.checkParam("--projMatch"):
            get = lambda k: torch.tensor([float(r.get(k, 0.0))
                                          for r in rows], device=dev)
            return get("angleRot"), get("angleTilt"), get("anglePsi")
        # global discrete matching against the undeformed volume
        # initializes the pose (reference's projMatch / wavelet global
        # stage, nma_alignment.cpp performCompleteSearch); the reference
        # package reads the winner as mres["best_ref"], a key its
        # match_to_gallery does not return (ROADMAP.md section 3, item 22)
        from xmipp3_tpu_torch.core.sampling import compute_sampling_points
        from xmipp3_tpu_torch.ops.match import match_to_gallery
        from xmipp3_tpu_torch.ops.project import FourierProjector
        ang = compute_sampling_points(self.getDoubleParam("--discrAngStep"))
        with timed_phase("projmatch"):
            gal = FourierProjector(vol, device=dev).project_euler(
                ang[:, 0].astype(np.float32), ang[:, 1].astype(np.float32),
                np.zeros(len(ang), np.float32))
            mres = match_to_gallery(gal, imgs)
        best = mres["ref_idx"].cpu().numpy().astype(int)
        return (torch.as_tensor(ang[best, 0].astype(np.float32), device=dev),
                torch.as_tensor(ang[best, 1].astype(np.float32), device=dev),
                mres["psi"].to(torch.float32))

    def run(self):
        from xmipp3_tpu_torch.core.pdb import rasterize, read_pdb
        from xmipp3_tpu_torch.models.nma import (mode_field, read_mode,
                                                 unit_fields,
                                                 warp_volume_field)
        from xmipp3_tpu_torch.ops.continuous import _euler_t
        from xmipp3_tpu_torch.ops.project import (extract_central_slices,
                                                  prepare_fourier_volume,
                                                  slices_to_projections)
        dev = resolve_device(self.getParam("--device"))
        md = MetaData(self.getParam("-i"))
        md.removeDisabled()
        rows = list(md.iterRows())
        fn_out = self._out_path(self.getParam("-o"))
        done_rows = []
        if self.checkParam("--resume") and os.path.exists(fn_out):
            prev = MetaData(fn_out)
            done_ids = {r.get("itemId") for r in prev.iterRows()}
            done_rows = list(prev.iterRows())
            rows = [r for r in rows if r.get("itemId") not in done_ids]
            if not rows:
                return
        imgs = torch.as_tensor(load_image_rows(rows), device=dev)
        B, N, _ = imgs.shape
        Ts = self.getDoubleParam("--sampling_rate")
        model = read_pdb(self.getParam("--pdb"))
        if self.checkParam("--centerPDB"):
            model = model.centered()
        fixed_std = self.getDoubleParam("--fixed_Gaussian")
        vol = np.asarray(rasterize(model, N, Ts,
                                   sigma_a=fixed_std if fixed_std > 0
                                   else 1.0), np.float32)
        modes = np.stack([read_mode(ln.strip()) for ln in
                          open(self.getParam("--modes")) if ln.strip()])
        M = len(modes)
        with timed_phase("fields"):
            uf = torch.as_tensor(unit_fields(model.coords, modes, N, Ts),
                                 device=dev)
        vr = torch.as_tensor(vol, device=dev)
        rot0, tilt0, psi0 = self._initial_poses(vol, imgs, rows, dev)
        # matching-metric weights: low-pass at --filterVol (filtering the
        # deformed volume == filtering its central slices), Fourier/real
        # Gaussian weights, zero-frequency weight, 2-D mask
        spec_w = None
        if self.checkParam("--filterVol") or \
                self.checkParam("--gaussian_Fourier") or \
                self.checkParam("--zerofreq_weight"):
            fy = np.fft.fftfreq(N)[:, None]
            fx = np.fft.rfftfreq(N)[None, :]
            f2 = fy * fy + fx * fx
            w = np.ones_like(f2)
            if self.checkParam("--gaussian_Fourier"):
                sF = self.getDoubleParam("--gaussian_Fourier")
                w *= np.exp(-f2 / (2 * sF * sF))
            if self.checkParam("--filterVol"):
                fc = Ts / max(self.getDoubleParam("--filterVol"), 2 * Ts)
                w *= (np.sqrt(f2) <= fc)
            if self.checkParam("--zerofreq_weight"):
                w[0, 0] = self.getDoubleParam("--zerofreq_weight")
            spec_w = torch.as_tensor(w.astype(np.float32), device=dev)
        real_w = None
        if self.checkParam("--gaussian_Real"):
            yy, xx = np.mgrid[0:N, 0:N].astype(np.float32) - N // 2
            sR = self.getDoubleParam("--gaussian_Real") * N
            real_w = torch.as_tensor(np.exp(-(yy * yy + xx * xx)
                                            / (2 * sR * sR)
                                            ).astype(np.float32), device=dev)
        if self.checkParam("--mask") and self.getParam("--mask"):
            m2d = torch.as_tensor(np.squeeze(Image(
                self.getParam("--mask")).data).astype(np.float32),
                device=dev)
            real_w = m2d if real_w is None else real_w * m2d
        img_w = imgs
        if spec_w is not None:
            img_w = torch.fft.irfft2(torch.fft.rfft2(img_w) * spec_w,
                                     s=(N, N))
        if real_w is not None:
            img_w = img_w * real_w
        im = img_w - img_w.mean(dim=(1, 2), keepdim=True)

        def losses_of(amp, rot, tilt, psi):
            """Each particle's loss (B,): minus the NCC of its weighted
            projection with its weighted image."""
            warped = warp_volume_field(vr, mode_field(amp, uf))
            vf, _ = prepare_fourier_volume(warped, 2.0)
            proj = slices_to_projections(extract_central_slices(
                vf, _euler_t(rot, tilt, psi), N), N)
            if spec_w is not None:
                proj = torch.fft.irfft2(torch.fft.rfft2(proj) * spec_w,
                                        s=(N, N))
            if real_w is not None:
                proj = proj * real_w
            pm = proj - proj.mean(dim=(1, 2), keepdim=True)
            return -(pm * im).sum(dim=(1, 2)) / torch.sqrt(
                (pm ** 2).sum(dim=(1, 2))
                * (im ** 2).sum(dim=(1, 2))).clamp(min=1e-12)

        params = [torch.zeros((B, M), device=dev), rot0, tilt0, psi0]
        tr = self.getDoubleParam("--trustradius_scale") \
            if self.checkParam("--trustradius_scale") else 1.0
        lrs = [1.0 * tr, 0.5 * tr, 0.5 * tr, 0.5 * tr]
        m1 = [torch.zeros_like(p) for p in params]
        v1 = [torch.zeros_like(p) for p in params]
        n_steps = self.getIntParam("--steps") if self.checkParam("--steps") \
            else 60
        losses = None
        with timed_phase("fit"):
            for step in range(n_steps):
                ps = [p.detach().requires_grad_(True) for p in params]
                with torch.enable_grad():
                    losses = losses_of(*ps)
                    # the reference's batch mean, its gradient scaled by B
                    g = torch.autograd.grad(losses.mean(), ps)
                losses = losses.detach()
                params = [p.detach() for p in ps]
                for k in range(4):
                    gk = g[k] * B
                    m1[k] = 0.9 * m1[k] + 0.1 * gk
                    v1[k] = 0.999 * v1[k] + 0.001 * gk * gk
                    mh = m1[k] / (1 - 0.9 ** (step + 1))
                    vh = v1[k] / (1 - 0.999 ** (step + 1))
                    params[k] = params[k] - lrs[k] * mh / (torch.sqrt(vh)
                                                           + 1e-8)
        amp, rot, tilt, psi = (p.cpu().numpy() for p in params)
        cc = -losses.cpu().numpy()
        out = []
        for i, r in enumerate(rows):
            d = dict(r)
            d["nmaDisplacements"] = amp[i].astype(np.float64)
            d["angleRot"] = float(rot[i])
            d["angleTilt"] = float(tilt[i])
            d["anglePsi"] = float(psi[i])
            d["maxCC"] = float(cc[i])
            out.append(d)
        MetaData.fromRows(done_rows + out).write(fn_out)
        self.amplitudes = amp
        self.rows = out
        if self.verbose:
            print(f"NMA-aligned {B} images, mean CC {cc.mean():.4f}")


class ProgFlexibleAlignment(ProgNMAAlignment):
    """flexible_alignment: the older elastic+rigid alignment program; same
    model (NMA amplitudes + pose), same fitting core, with --max_iter as
    an alias of --steps. Its other grammar extras (flexible_alignment.cpp)
    are declared by the reference package and never read: the port
    refuses each given with a value other than its default (ROADMAP.md
    section 3, item 21)."""
    name = "xmipp_flexible_alignment"

    def defineParams(self):
        super().defineParams()
        g = self._grammar
        g._alias_map["--max_iter"] = "--steps"
        g.params["--steps"].aliases.append("--max_iter")
        self.addParamsLine("  [--maxdefamp <a=500>] : Maximum deformation "
                           "amplitude (trust bound on the mode amplitudes)")
        self.addParamsLine("  [--maxtransl <t=7>] : Maximum translation "
                           "(px; accepted — poses fit angles only here)")
        self.addParamsLine("  [--defampsampling <s=200>] : Deformation "
                           "sampling (scales the amplitude step size)")
        self.addParamsLine("  [--translsampling <s=2>] : Translation "
                           "sampling (accepted)")
        self.addParamsLine("  [--minAngularSampling <a=3>] : Minimum "
                           "angular sampling (scales the angle step size)")
        self.addParamsLine("  [--sigma <s=10>] : Noise sigma of the "
                           "likelihood (accepted; NCC objective here)")

    def run(self):
        self.refuse_unread("--maxdefamp", "--maxtransl", "--defampsampling",
                           "--translsampling", "--minAngularSampling",
                           "--sigma", item=21)
        super().run()


class ProgForwardZernikeSubtomos(XmippProgram):
    """Forward-splat 3-D Zernike3D fitting per subtomogram (reference
    forward_zernike_subtomos.cpp:113-134): the deformed masked voxel
    cloud of --ref is splat as a volume (trilinear or --blobr KB blob),
    missing-wedge filtered to the --t1/--t2 tilt range, optionally
    isotropic-CTF-attenuated (--useCTF), and fit against each subtomogram
    with the --optimize* gated Adam (pose/shift deltas clipped to
    --max_angular_change/--max_shift), a batch at a time on the card."""
    name = "xmipp_forward_zernike_subtomos"

    def defineParams(self):
        self.addUsageLine("Per-subtomogram Zernike3D deformation fitting "
                          "against a reference volume "
                          "(forward_zernike_subtomos role).")
        self.addParamsLine("   -i <md>        : Subtomograms")
        self.addParamsLine("   --ref <volume> : Reference volume")
        self.addParamsLine("   -o <md>        : Output with sphCoefficients")
        self.addParamsLine("  [--mask <m=\"\">] : Reference volume mask")
        self.addParamsLine("  [--odir <outputDir=\".\">] : Output directory")
        self.addParamsLine("  [--max_shift <s=-1>] : Max shift delta (px); "
                           "-1 = 20% of the box")
        self.addParamsLine("  [--max_angular_change <a=5>] : Max angular "
                           "delta (deg)")
        self.addParamsLine("  [--max_resolution <f=4>] : Low-pass (A); "
                           "<=0 disables")
        self.addParamsLine("  [--sampling <Ts=1>] : Pixel size (A)")
        self.addParamsLine("  [--Rmax <R=-1>] : Correlation sphere radius "
                           "(px); -1 = half the box")
        self.addParamsLine("  [--RDef <r=-1>] : Deformation sphere radius")
        self.addParamsLine("  [--l1 <l1=3>]   : Zernike radial depth")
        self.addParamsLine("  [--l2 <l2=2>]   : Spherical harmonic depth")
        self.addParamsLine("  [--step <step=1>] : Voxel index stride")
        self.addParamsLine("  [--useCTF] : Attenuate the model with the "
                           "rows' (isotropic) CTF")
        self.addParamsLine("  [--optimizeAlignment] : Optimize pose deltas")
        self.addParamsLine("  [--optimizeDeformation] : Optimize Zernike3D "
                           "coefficients")
        self.addParamsLine("  [--optimizeDefocus] : Optimize defocus deltas")
        self.addParamsLine("  [--phaseFlipped] : Inputs phase flipped")
        self.addParamsLine("  [--regularization <l=0.01>] : Deformation "
                           "penalty lambda")
        self.addParamsLine("  [--blobr <b=-1>] : Splat blob radius; <=0 = "
                           "trilinear splat (TPU-native default path)")
        self.addParamsLine("  [--t1 <t1=-60>] : First tilt angle of the "
                           "missing wedge")
        self.addParamsLine("  [--t2 <t2=60>] : Second tilt angle of the "
                           "missing wedge")
        self.addParamsLine("  [--resume] : Resume from the odir "
                           "sphDone.xmd ledger")
        self.addParamsLine("  [--steps <n=60>] : Optimization steps")
        self.addParamsLine("  [--batch <b=8>] : Subtomos per device batch")
        self.addParamsLine("  [--priors <md=\"\">] : Prior coefficients to start from")

    def run(self):
        from xmipp3_tpu_torch.ops.forward_zernike import (
            blob_splat_profile_3d, fit_forward_zernike_subtomos_batch,
            masked_voxel_basis)
        from xmipp3_tpu_torch.ops.fourier import freq_grid_3d
        from xmipp3_tpu_torch.ops.fourier_filter import wedge_mask_3d
        dev = resolve_device(self.getParam("--device"))
        odir = self.getParam("--odir")
        out_fn = self.getParam("-o")
        if odir and odir != "." and not os.path.isabs(out_fn):
            os.makedirs(odir, exist_ok=True)
            out_fn = os.path.join(odir, out_fn)
        md = MetaData(self.getParam("-i"))
        rows = list(md.iterRows())
        done_fn = os.path.join(odir, "sphDone.xmd")
        done_rows = []
        if self.checkParam("--resume") and os.path.exists(done_fn):
            done_rows = list(MetaData(done_fn).iterRows())
            done = {str(r.get("image", "")) for r in done_rows}
            rows = [r for r in rows if str(r.get("image", "")) not in done]
        if not rows:
            MetaData.fromRows(done_rows).write(out_fn)
            return
        ref = np.squeeze(Image(self.getParam("--ref")).data
                         ).astype(np.float32)
        L1, L2 = self.getIntParam("--l1"), self.getIntParam("--l2")
        mask = None
        if self.checkParam("--mask") and self.getParam("--mask"):
            mask = np.squeeze(Image(self.getParam("--mask")).data)
        rdef = float(self.getIntParam("--RDef"))
        with timed_phase("basis"):
            positions, values, Z = masked_voxel_basis(
                ref, L1, L2, value_threshold=float(np.abs(ref).max()) * 1e-3,
                mask=mask, rmax=rdef if rdef > 0 else None,
                step=max(1, self.getIntParam("--step")))
        K = Z.shape[0]
        subs = np.stack([np.squeeze(Image(r["image"]).data)
                         .astype(np.float32) for r in rows])
        n = subs.shape[-1]
        get = lambda k, d=0.0: np.array([float(r.get(k, d)) for r in rows],
                                        np.float32)
        rot, tilt, psi = get("angleRot"), get("angleTilt"), get("anglePsi")
        shifts = np.stack([get("shiftX"), get("shiftY"), get("shiftZ")], 1)

        # spectral mask: missing wedge (t1..t2) * low-pass
        t1 = float(self.getDoubleParam("--t1"))
        t2 = float(self.getDoubleParam("--t2"))
        spec_mask = wedge_mask_3d(n, n, n, t1, t2)
        Ts = float(self.getDoubleParam("--sampling"))
        max_res = float(self.getDoubleParam("--max_resolution"))
        if max_res > 0:
            fz, fy, fx = freq_grid_3d(n, n, n)
            r = np.sqrt(fx * fx + fy * fy + fz * fz)
            spec_mask = spec_mask * (r <= min(0.5, Ts / max_res)
                                     ).astype(np.float32)
        spec_mask = torch.as_tensor(spec_mask, device=dev)
        # subtomos already live in the wedge-filtered world; filter them
        # the same way so the masked model compares like-for-like
        dims = (-3, -2, -1)
        subs = torch.fft.irfftn(
            torch.fft.rfftn(torch.as_tensor(subs, device=dev), dim=dims)
            * spec_mask[None], s=(n, n, n), dim=dims)

        rmax2 = float(self.getIntParam("--Rmax"))
        if rmax2 <= 0:
            rmax2 = n / 2
        zz, yy, xx = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) - n // 2
        vol_mask = (zz * zz + yy * yy + xx * xx
                    <= rmax2 * rmax2).astype(np.float32)

        opt_align = self.checkParam("--optimizeAlignment")
        opt_deform = self.checkParam("--optimizeDeformation")
        opt_defocus = self.checkParam("--optimizeDefocus")
        if not (opt_align or opt_deform or opt_defocus):
            opt_deform = True
        use_ctf = self.checkParam("--useCTF")
        ctf_consts = (0.0, 0.0, 1.0, 0.0, max(Ts, 1e-6))
        defU = defV = None
        if use_ctf:
            ctf_consts = _ctf_constants(rows[0], Ts)
            defU, defV = get("ctfDefocusU"), get("ctfDefocusV")
        blobr = float(self.getDoubleParam("--blobr"))
        blob_profile, n_taps = (None, 0)
        if blobr > 0:
            blob_profile, n_taps = blob_splat_profile_3d(blobr)
        max_shift = float(self.getDoubleParam("--max_shift"))
        if max_shift < 0:
            max_shift = 0.2 * n
        steps = self.getIntParam("--steps")
        lam = float(self.getDoubleParam("--regularization"))
        bs = self.getIntParam("--batch")
        priors = None
        if self.checkParam("--priors") and self.getParam("--priors"):
            pmd = MetaData(self.getParam("--priors"))
            pc = [np.asarray(v, np.float32).reshape(3, -1)
                  for v in pmd.getColumnValues("sphCoefficients")]
            priors = (np.stack(pc * len(rows))[:len(rows)]
                      if len(pc) == 1 else np.stack(pc)[:len(rows)])
        cloud = [torch.as_tensor(a, device=dev)
                 for a in (positions, values, Z)]
        out = []
        for s in range(0, len(rows), bs):
            sl = slice(s, min(s + bs, len(rows)))
            nb = sl.stop - sl.start
            c0 = (np.zeros((nb, 3, K), np.float32) if priors is None
                  else np.asarray(priors[sl], np.float32))
            with timed_phase("fit"):
                c3, dp, cc, deform = fit_forward_zernike_subtomos_batch(
                    *cloud, subs[sl], rot[sl], tilt[sl], psi[sl], c0, lam,
                    n, steps, max_angular=float(
                        self.getDoubleParam("--max_angular_change")),
                    max_shift=max_shift, shifts=shifts[sl],
                    spec_mask=spec_mask, vol_mask=vol_mask,
                    blob_profile=blob_profile, n_taps=n_taps,
                    use_ctf=use_ctf,
                    phase_flipped=self.checkParam("--phaseFlipped"),
                    defU=None if defU is None else defU[sl],
                    defV=None if defV is None else defV[sl],
                    ctf_consts=ctf_consts, opt_align=opt_align,
                    opt_deform=opt_deform, opt_defocus=opt_defocus)
            c3, dp, cc, deform = (a.cpu().numpy()
                                  for a in (c3, dp, cc, deform))
            for i in range(nb):
                d = dict(rows[s + i])
                d["sphCoefficients"] = c3[i].ravel().astype(np.float64)
                d["sphDeformation"] = float(deform[i])
                d["maxCC"] = float(cc[i])
                if opt_align:
                    d["angleRot"] = float(rot[s + i] + dp[i, 0])
                    d["angleTilt"] = float(tilt[s + i] + dp[i, 1])
                    d["anglePsi"] = float(psi[s + i] + dp[i, 2])
                    d["shiftX"] = float(shifts[s + i, 0] + dp[i, 3])
                    d["shiftY"] = float(shifts[s + i, 1] + dp[i, 4])
                    d["shiftZ"] = float(shifts[s + i, 2] + dp[i, 5])
                if use_ctf and opt_defocus:
                    d["ctfDefocusU"] = float(defU[s + i] + dp[i, 6])
                    d["ctfDefocusV"] = float(defV[s + i] + dp[i, 7])
                out.append(d)
            if self.checkParam("--resume"):
                os.makedirs(odir or ".", exist_ok=True)
                MetaData.fromRows(done_rows + out).write(done_fn)
        MetaData.fromRows(done_rows + out).write(out_fn)
        self.rows = out
        if self.verbose:
            cc = np.mean([r["maxCC"] for r in out])
            print(f"fitted {len(out)} subtomos, mean CC {cc:.4f}")


def _kmeans_clusters(coeffs, C: int):
    """The reference's 25 k-means rounds over the coefficient rows (host
    float64), started from C distinct rows drawn by default_rng(0).
    Returns (labels, centres)."""
    rng = np.random.default_rng(0)
    if C > 1:
        cen = coeffs[rng.choice(len(coeffs), C, replace=False)].copy()
        for _ in range(25):
            lab = ((coeffs[:, None] - cen[None]) ** 2).sum(-1).argmin(1)
            for c in range(C):
                if (lab == c).any():
                    cen[c] = coeffs[lab == c].mean(0)
    else:
        lab = np.zeros(len(coeffs), int)
        cen = coeffs.mean(0, keepdims=True)
    return lab, cen


class ProgArtZernike3D(XmippProgram):
    """Full reference grammar (art_zernike3d.cpp:96-112): --useZernike
    gate on the heterogeneity correction, --useCTF per-row sign
    pre-correction, --regularization as Tikhonov shrinkage per iteration,
    --save_iter intermediates, --resume, --odir. --sort_last stays
    accepted: the batched SIRT update is order-free. --ref is loaded by
    the reference package and never used, so the port refuses it
    (ROADMAP.md section 3, item 21)."""
    name = "xmipp_art_zernike3d"

    def defineParams(self):
        self.addUsageLine("Deformation-aware reconstruction: particles "
                          "carrying Zernike3D coefficients are grouped into "
                          "conformational clusters, each cluster is SIRT-"
                          "reconstructed, and the cluster maps are undeformed "
                          "into the reference frame and averaged. (The "
                          "reference's per-particle deformed ART "
                          "forward model, recast as cluster-wise batched "
                          "reconstruction for the device.)")
        self.addParamsLine("   -i <md>       : Particles with poses + sphCoefficients")
        self.addParamsLine("   -o <volume>   : Output volume")
        self.addParamsLine("  [--ref <volume=\"\">] : Initial volume of the "
                           "iteration")
        self.addParamsLine("  [--odir <outputDir=\".\">] : Output directory")
        self.addParamsLine("  [--sampling <Ts=1>] : Pixel size (A)")
        self.addParamsLine("  [--RDef <r=-1>] : Deformation radius (px); "
                           "-1 = half the box")
        self.addParamsLine("  [--l1 <l1=3>]  : Zernike radial depth")
        self.addParamsLine("  [--l2 <l2=2>]  : Spherical harmonic depth")
        self.addParamsLine("  [--useZernike] : Correct heterogeneity with "
                           "the rows' Zernike3D coefficients")
        self.addParamsLine("  [--useCTF] : Phase-flip-correct each image "
                           "with its row CTF before reconstruction")
        self.addParamsLine("  [--phaseFlipped] : Inputs already phase "
                           "flipped")
        self.addParamsLine("  [--regularization <l=0.01>] : Tikhonov "
                           "shrinkage per iteration")
        self.addParamsLine("  [--niter <n=1>]    : SIRT iterations per cluster")
        self.addParamsLine("  [--save_iter <s=0>] : Save the volume every "
                           "s iterations (<odir>/<out>_iterNNN.vol)")
        self.addParamsLine("  [--sort_last <N=2>] : Projection insertion "
                           "order knob; the batched SIRT update is order-"
                           "free, accepted for CLI compatibility")
        self.addParamsLine("  [--resume] : Skip the run if the output "
                           "volume already exists")
        self.addParamsLine("  [--clusters <c=4>] : Conformational clusters")
        self._define_extra_params()

    def _define_extra_params(self):
        pass

    def _precorrect_ctf(self, imgs, rows, Ts, dev):
        """Per-row CTF phase flip (sign correction) before reconstruction
        (the effect of the reference's CTF-aware ART forward model on
        phases; amplitude weighting stays with the Wiener programs)."""
        from xmipp3_tpu_torch.ops.continuous import _ctf_rfft
        N = imgs.shape[-1]
        consts = _ctf_constants(rows[0], Ts)
        g = lambda k: torch.tensor([float(r.get(k, 0.0)) for r in rows],
                                   device=dev)
        fy = torch.fft.fftfreq(N, device=dev)[:, None]
        fx = torch.fft.rfftfreq(N, device=dev)[None, :]
        r = torch.sqrt(fx * fx + fy * fy)
        ctf = _ctf_rfft(r, fx, fy, g("ctfDefocusU"), g("ctfDefocusV"),
                        g("ctfDefocusAngle"), consts, False)
        spec = torch.fft.rfft2(torch.as_tensor(imgs, device=dev)) \
            * torch.sign(ctf)
        return torch.fft.irfft2(spec, s=(N, N))

    def _refuse_unread(self):
        self.refuse_unread("--ref", item=21)

    def _out_fn(self):
        odir = self.getParam("--odir")
        out_fn = self.getParam("-o")
        if odir and odir != "." and not os.path.isabs(out_fn):
            os.makedirs(odir, exist_ok=True)
            out_fn = os.path.join(odir, out_fn)
        return out_fn

    def _undeform_average(self, C, lab, cen, use_zernike, N, dev,
                          cluster_volume):
        """Sum each cluster's volume, undeformed into the reference frame
        by the negated centre (first-order inverse of the deformation) and
        weighted by its size, in float64 on the host; returns the mean."""
        from xmipp3_tpu_torch.ops.zernike import (deform_volume,
                                                  zernike_basis_grid)
        L1, L2 = self.getIntParam("--l1"), self.getIntParam("--l2")
        rdef = float(self.getIntParam("--RDef"))
        basis = torch.as_tensor(zernike_basis_grid(
            N, L1, L2, rdef if rdef > 0 else None), device=dev)
        K = basis.shape[0]
        acc = np.zeros((N, N, N), np.float64)
        wsum = 0.0
        for c in range(C):
            m = lab == c
            if not m.any():
                continue
            volc = cluster_volume(m)
            cc = cen[c]
            if use_zernike and cc.size == 3 * K:
                with timed_phase("undeform"):
                    volc = deform_volume(volc, basis, -torch.as_tensor(
                        cc.reshape(3, K), dtype=torch.float32, device=dev))
            acc += volc.cpu().numpy().astype(np.float64) * m.sum()
            wsum += m.sum()
        return (acc / max(wsum, 1)).astype(np.float32)

    def run(self):
        self._refuse_unread()
        dev = resolve_device(self.getParam("--device"))
        out_fn = self._out_fn()
        if self.checkParam("--resume") and os.path.exists(out_fn):
            self.volume = np.squeeze(Image(out_fn).data)
            self.labels = None
            return
        md = MetaData(self.getParam("-i"))
        md.removeDisabled()
        rows = list(md.iterRows())
        imgs = torch.as_tensor(load_image_rows(rows), device=dev)
        N = imgs.shape[-1]
        Ts = float(self.getDoubleParam("--sampling"))
        if (self.checkParam("--useCTF")
                and not self.checkParam("--phaseFlipped")
                and "ctfDefocusU" in md.df.columns):
            with timed_phase("ctf"):
                imgs = self._precorrect_ctf(imgs, rows, Ts, dev)
        get = lambda k: np.array([float(r.get(k, 0.0)) for r in rows],
                                 np.float32)
        rot, tilt, psi = get("angleRot"), get("angleTilt"), get("anglePsi")
        use_zernike = self.checkParam("--useZernike") or (
            "sphCoefficients" in md.df.columns
            and self.getIntParam("--clusters") > 1)
        coeffs = np.stack([np.asarray(r.get("sphCoefficients", [0.0]),
                                      np.float64).ravel() for r in rows])
        C = (min(self.getIntParam("--clusters"), len(rows))
             if use_zernike else 1)
        niter = self.getIntParam("--niter")
        ridge = float(self.getDoubleParam("--regularization"))
        save_iter = self.getIntParam("--save_iter")
        base = os.path.splitext(out_fn)[0]

        def cb(it, v):
            if save_iter > 0 and it % save_iter == 0:
                save_image(f"{base}_iter{it:03d}.vol",
                           v.cpu().numpy().astype(np.float32))
        # k-means over coefficients -> conformational clusters
        lab, cen = _kmeans_clusters(coeffs, C)

        def cluster_volume(m):
            sel = torch.as_tensor(np.flatnonzero(m), device=dev)
            with timed_phase("sirt"):
                return self._reconstruct_cluster(
                    imgs[sel], rot[m], tilt[m], psi[m], niter, ridge,
                    cb if save_iter > 0 else None, dev)

        vol = self._undeform_average(C, lab, cen, use_zernike, N, dev,
                                     cluster_volume)
        save_image(out_fn, vol)
        self.volume = vol
        self.labels = lab
        if self.verbose:
            print(f"reconstructed from {len(rows)} particles in {C} "
                  f"conformational clusters")

    def _reconstruct_cluster(self, imgs, rot, tilt, psi, niter, ridge, cb,
                             dev):
        from xmipp3_tpu_torch.ops.art import sirt_reconstruct
        volc, _ = sirt_reconstruct(imgs, rot, tilt, psi, n_iters=niter,
                                   ridge=ridge, iter_callback=cb,
                                   device=dev)
        return volc


class ProgForwardArtZernike3DSubtomos(ProgArtZernike3D):
    """Subtomo flavor (forward_art_zernike3d_subtomos.cpp:106-128): same
    cluster-wise undeform+average; adds --mask (reconstruction support)
    and --t1/--t2 (missing wedge): volume inputs are averaged with the
    wedge-aware Fourier normalization, image inputs keep cluster SIRT.
    --sigma, --blobr and --step are splatting internals of the reference
    suite's forward model that the reference package declares and never
    reads (no splatting stage in the Fourier path): the port refuses each
    given with a value other than its default (ROADMAP.md section 3,
    item 21)."""
    name = "xmipp_forward_art_zernike3d_subtomos"

    def _define_extra_params(self):
        self.addParamsLine("  [--mask <m=\"\">] : Reconstruction support "
                           "mask (volume multiplied in each iteration)")
        self.addParamsLine("  [--sigma <s=0.25>] : Splatting Gaussian of "
                           "the reference's forward model (accepted; the "
                           "Fourier path has no splatting stage)")
        self.addParamsLine("  [--blobr <b=-1>] : Splat blob radius "
                           "(accepted; see --sigma)")
        self.addParamsLine("  [--step <step=1>] : Voxel stride (accepted; "
                           "see --sigma)")
        self.addParamsLine("  [--t1 <t1=-60>] : First tilt angle of the "
                           "missing wedge (volume inputs)")
        self.addParamsLine("  [--t2 <t2=60>] : Second tilt angle of the "
                           "missing wedge (volume inputs)")

    def _refuse_unread(self):
        self.refuse_unread("--ref", "--sigma", "--blobr", "--step", item=21)

    def run(self):
        # volume inputs -> wedge-aware average path; image inputs take the
        # cluster SIRT of the base class
        rows = list(MetaData(self.getParam("-i")).iterRows())
        if rows:
            v0 = np.squeeze(Image(str(rows[0]["image"])).data)
            if v0.ndim == 3:
                return self._run_subtomos(rows)
        return super().run()

    def _run_subtomos(self, rows):
        from xmipp3_tpu_torch.ops.art import wedge_aware_average
        self._refuse_unread()
        dev = resolve_device(self.getParam("--device"))
        out_fn = self._out_fn()
        if self.checkParam("--resume") and os.path.exists(out_fn):
            self.volume = np.squeeze(Image(out_fn).data)
            self.labels = None
            return
        subs = np.stack([np.squeeze(Image(str(r["image"])).data)
                         .astype(np.float32) for r in rows])
        N = subs.shape[-1]
        get = lambda k: np.array([float(r.get(k, 0.0)) for r in rows],
                                 np.float32)
        rot, tilt, psi = get("angleRot"), get("angleTilt"), get("anglePsi")
        t1 = float(self.getDoubleParam("--t1"))
        t2 = float(self.getDoubleParam("--t2"))
        use_zernike = self.checkParam("--useZernike")
        coeffs = np.stack([np.asarray(r.get("sphCoefficients", [0.0]),
                                      np.float64).ravel() for r in rows])
        C = (min(self.getIntParam("--clusters"), len(rows))
             if use_zernike else 1)
        lab, cen = _kmeans_clusters(coeffs, C)
        subs_t = torch.as_tensor(subs, device=dev)

        def cluster_volume(m):
            sel = torch.as_tensor(np.flatnonzero(m), device=dev)
            with timed_phase("average"):
                return wedge_aware_average(subs_t[sel], rot[m], tilt[m],
                                           psi[m], t1, t2)

        vol = self._undeform_average(C, lab, cen, use_zernike, N, dev,
                                     cluster_volume)
        if self.checkParam("--mask") and self.getParam("--mask"):
            vol = vol * (np.squeeze(Image(self.getParam("--mask")).data)
                         > 0.5)
        save_image(out_fn, vol)
        self.volume = vol
        self.labels = lab


class ProgCuda11ForwardArtZernike3D(ProgArtZernike3D):
    """cuda11_forward_art_zernike3d (forward_art_zernike3d_gpu.cpp:
    132-168): the regularized flavor: per-iteration TV (--ltv), Tikhonov
    (--ltk), L1 (--ll1) and soft-threshold (--lst) steps, forward/backward
    masks, --onlyPositive clamp, --sym symmetrization of the result and
    --debug_iter intermediates. --sort_random stays accepted (the batched
    update is order-free); the multiresolution (--mr/--dSize) and
    splatting (--blobr/--step/--sigma) internals of the reference suite's
    GPU implementation are declared by the reference package and never
    read: the port refuses each given with a value other than its default
    (ROADMAP.md section 3, item 21)."""
    name = "xmipp_cuda11_forward_art_zernike3d"

    def _define_extra_params(self):
        self.addParamsLine("  [--maskf <m=\"\">] : Forward-model mask "
                           "(multiplies the volume before projection)")
        self.addParamsLine("  [--maskb <m=\"\">] : Backward mask "
                           "(multiplies the update each iteration)")
        self.addParamsLine("  [--blobr <b=-1>] : Splat blob radius "
                           "(GPU splatting internal; accepted)")
        self.addParamsLine("  [--step <step=1>] : Voxel stride (accepted)")
        self.addParamsLine("  [--sigma <...>] : Splatting Gaussian sigmas "
                           "(accepted)")
        self.addParamsLine("  [--mr <mr=0>] : Multiresolution levels "
                           "(accepted; full-res single dispatch)")
        self.addParamsLine("  [--dSize <ds=0>] : Multiresolution size "
                           "(accepted)")
        self.addParamsLine("  [--ltv <ltv=1e-4>] : Total-variation step")
        self.addParamsLine("  [--ltk <ltk=1e-4>] : Tikhonov shrinkage")
        self.addParamsLine("  [--ll1 <ll1=1e-4>] : L1 subgradient step")
        self.addParamsLine("  [--lst <lst=1e-4>] : Soft-threshold prox")
        self.addParamsLine("  [--sym <sym=c1>] : Symmetrize the result")
        self.addParamsLine("  [--onlyPositive] : Clamp negatives")
        self.addParamsLine("  [--debug_iter] : Save the volume after every "
                           "iteration")
        self.addParamsLine("  [--sort_random] : Random projection order "
                           "(order-free batched update; accepted)")

    def _refuse_unread(self):
        self.refuse_unread("--ref", "--blobr", "--step", "--sigma", "--mr",
                           "--dSize", item=21)

    def _reconstruct_cluster(self, imgs, rot, tilt, psi, niter, ridge, cb,
                             dev):
        from xmipp3_tpu_torch.ops.art import sirt_reconstruct
        vol_mask = None
        if self.checkParam("--maskb") and self.getParam("--maskb"):
            vol_mask = (np.squeeze(Image(self.getParam("--maskb")).data)
                        > 0.5).astype(np.float32)
        if self.checkParam("--maskf") and self.getParam("--maskf"):
            mf = (np.squeeze(Image(self.getParam("--maskf")).data)
                  > 0.5).astype(np.float32)
            vol_mask = mf if vol_mask is None else vol_mask * mf
        if self.checkParam("--debug_iter") and cb is None:
            base = os.path.splitext(self.getParam("-o"))[0]

            def cb(it, v):
                save_image(f"{base}_iter{it:03d}.vol",
                           v.cpu().numpy().astype(np.float32))
        volc, _ = sirt_reconstruct(
            imgs, rot, tilt, psi, n_iters=niter, ridge=ridge,
            tv=float(self.getDoubleParam("--ltv")),
            l1=float(self.getDoubleParam("--ll1")),
            soft_threshold=float(self.getDoubleParam("--lst")),
            vol_mask=vol_mask,
            positivity=self.checkParam("--onlyPositive"),
            iter_callback=cb, device=dev)
        # --ltk Tikhonov rides the base --regularization ridge; apply the
        # extra shrinkage once if it differs
        ltk = float(self.getDoubleParam("--ltk"))
        if ltk > 0:
            volc = volc * (1.0 - ltk)
        sym = self.getParam("--sym")
        if sym and sym.lower() != "c1":
            from xmipp3_tpu_torch.core.sym import SymList
            from xmipp3_tpu_torch.ops.geo import apply_affine_3d
            mats = SymList(sym).sym_matrices()
            volc = apply_affine_3d(volc, np.asarray(mats, np.float32)
                                   ).mean(dim=0)
        return volc


class ProgClassifyFTTRI(MeshProgram):
    """Full FTTRI pipeline (mpi_classify_FTTRI.cpp:82-236): mask ->
    pad (--padding) -> |FFT| -> window to Rmax=floor(maxfreq*padXdim) ->
    polar with --zoom center densification -> R^sigma1 radial weight ->
    second |FFT| -> (Rmax-R)^sigma2 weight -> central window, range-
    adjusted log10 feature images written to <oroot>_FTTRI.mrcs; then
    iterative classification with --nmin class pruning over --iter
    rounds, optionally refined with a phase-sensitive pass (--doPhase).

    The feature chain runs on the card on batches of 64 images (64 a rank
    with --mesh dp: each rank takes its rows of a chunk and the rows meet
    in one all_gather); EM-PCA and the k-means distances run there too.
    The k-means draws, the pruning and the metadata stay on the host."""
    name = "xmipp_classify_FTTRI"

    def defineParams(self):
        self.addUsageLine("Fast 2D classification on translation/rotation-"
                          "invariant Fourier features (FTTRI).")
        self.addParamsLine("   -i <md>       : Particles")
        self.addParamsLine("  [-o <md=\"\">]   : Output with class "
                           "assignments (default <oroot>_classes.xmd)")
        self.addParamsLine("  [--oroot <root=fttri>] : Output rootname "
                           "(feature stack, mask, classes)")
        self.addParamsLine("  [--nref <k=8>] : Number of classes")
        self.addParamsLine("  [--padding <p=4>] : Padding factor")
        self.addParamsLine("  [--maxfreq <f=0.25>] : Maximum digital "
                           "frequency of the spectrum band (-1 = auto)")
        self.addParamsLine("  [--zoom <z=1>] : Polar zoom factor at low "
                           "frequencies (log-polar ~ 2.8)")
        self.addParamsLine("  [--nmin <n=5>] : Minimum class size; smaller "
                           "classes are dissolved each iteration")
        self.addParamsLine("  [--iter <n=10>] : Classification iterations")
        self.addParamsLine("  [--sigma1 <s=0.707>] : First FTTRI radial "
                           "weight exponent")
        self.addParamsLine("  [--sigma2 <s=1.5>] : Second FTTRI radial "
                           "weight exponent")
        self.addParamsLine("  [--doPhase] : Also run an amplitude+phase "
                           "classification pass")
        self.addParamsLine("  [--pca <d=20>] : PCA dimensions for the "
                           "classification features")
        from xmipp3_tpu_torch.parallel.cli import add_mesh_params
        add_mesh_params(self)

    def readParams(self):
        from xmipp3_tpu_torch.parallel.cli import read_mesh_params
        self.device_arg = self.getParam("--device")
        read_mesh_params(self)

    @staticmethod
    def _fttri_images(imgs, pad, fmax, zoom, s1, s2, dev):
        """The FTTRI feature images of a (b, H, W) tensor on the card."""
        B, H, W = imgs.shape
        pad_n = int(pad * W)
        Rmax = max(int(np.floor(fmax * pad_n)), 8)
        # circular mask of radius xdim/2 (produceSideInfo)
        yy, xx = np.mgrid[0:H, 0:W]
        mask = torch.as_tensor(((yy - H // 2) ** 2 + (xx - W // 2) ** 2
                                < 0.25 * W * W).astype(np.float32),
                               device=dev)
        # polar grid over the Rmax-windowed |FFT|: radii densified at the
        # center by the zoom factor, angles in [0, pi)
        nrad = nang = Rmax
        t = np.arange(nrad) / max(nrad - 1, 1)
        radii = Rmax * (t + (zoom - 1.0) * t * t) / zoom
        theta = np.arange(nang) * (np.pi / nang)
        xs = np.float32(radii[None, :] * np.cos(theta)[:, None] + pad_n // 2)
        ys = np.float32(radii[None, :] * np.sin(theta)[:, None] + pad_n // 2)
        x0, y0 = np.floor(xs).astype(np.int64), np.floor(ys).astype(np.int64)
        fx = torch.as_tensor(xs - x0, device=dev)
        fy = torch.as_tensor(ys - y0, device=dev)
        w1 = torch.as_tensor((radii ** s1).astype(np.float32), device=dev)
        w2 = torch.as_tensor(np.maximum(Rmax - radii, 0.0) ** s2,
                             dtype=torch.float32, device=dev)
        fy_dim = int((Rmax + 1) * 0.55)
        fx_dim = int((Rmax + 1) * 0.35)
        p = torch.zeros((B, pad_n, pad_n), device=dev)
        oy, ox = (pad_n - H) // 2, (pad_n - W) // 2
        p[:, oy:oy + H, ox:ox + W] = imgs * mask
        mag = torch.fft.fftshift(torch.fft.fft2(p), dim=(-2, -1)).abs()
        pol = 0.0
        for dy in (0, 1):
            for dx in (0, 1):
                yi = torch.as_tensor(np.clip(y0 + dy, 0, pad_n - 1),
                                     device=dev)
                xi = torch.as_tensor(np.clip(x0 + dx, 0, pad_n - 1),
                                     device=dev)
                pol = pol + mag[:, yi, xi] * ((fx if dx else 1 - fx)
                                              * (fy if dy else 1 - fy))
        pol = pol * w1[None, None, :]
        mag2 = torch.fft.fftshift(torch.fft.fft2(pol), dim=(-2, -1)).abs()
        mag2 = mag2 * w2[None, None, :]
        # the central window (dynamic_slice's clamped start)
        cy = min(max(nang // 2 - fy_dim // 2, 0), nang - fy_dim)
        cx = min(max(nrad // 2, 0), nrad - fx_dim)
        win = mag2[:, cy:cy + fy_dim, cx:cx + fx_dim]
        lo = win.amin(dim=(1, 2), keepdim=True)
        hi = win.amax(dim=(1, 2), keepdim=True)
        win = (win - lo) * (254.0 / (hi - lo).clamp(min=1e-12)) + 1.0
        return torch.log10(win)

    def _features(self, imgs, mesh, *chain):
        """The feature images of every image (numpy float32), in chunks of
        64 images (64 a rank on a mesh)."""
        from xmipp3_tpu_torch.parallel.engines import gather_batch, shard_batch
        from xmipp3_tpu_torch.parallel.mesh import pad_to_multiple
        B = len(imgs)
        out = []
        if mesh is None:
            for c0 in range(0, B, 64):
                blk = torch.as_tensor(imgs[c0:c0 + 64], device=self.device)
                out.append(self._fttri_images(blk, *chain, self.device)
                           .cpu().numpy())
            return np.concatenate(out)
        n = mesh.size
        for c0 in range(0, B, 64 * n):
            blk, n_valid = pad_to_multiple(imgs[c0:c0 + 64 * n], n)
            f = self._fttri_images(shard_batch(blk, mesh), *chain,
                                   self.device)
            out.append(gather_batch(f, mesh, n_valid).cpu().numpy())
        return np.concatenate(out)

    def _run(self, mesh):
        from xmipp3_tpu_torch.models.dimred import empca
        from xmipp3_tpu_torch.programs.scripts_misc import _kmeans
        dev = self.device
        md = MetaData(self.getParam("-i"))
        rows = list(md.iterRows())
        with timed_phase("read images"):
            imgs = load_image_rows(rows).astype(np.float32)
        B, H, W = imgs.shape
        root = self.getParam("--oroot")
        fmax = self.getDoubleParam("--maxfreq")
        if fmax <= 0:
            fmax = 0.25                      # automatic estimate fallback
        chain = (self.getDoubleParam("--padding"), fmax,
                 max(self.getDoubleParam("--zoom"), 1.0),
                 self.getDoubleParam("--sigma1"),
                 self.getDoubleParam("--sigma2"))
        with timed_phase("features"):
            fttri = self._features(imgs, mesh, *chain)
        yy, xx = np.mgrid[0:H, 0:W]
        if self.writer:
            save_image(root + "_FTTRI.mrcs", fttri.astype(np.float32))
            save_image(root + "_mask.mrc",
                       (((yy - H // 2) ** 2 + (xx - W // 2) ** 2
                         < 0.25 * W * W)).astype(np.float32))
        feat = fttri.reshape(B, -1)
        feat = (feat - feat.mean(0)) / np.maximum(feat.std(0), 1e-8)
        d = min(self.getIntParam("--pca"), B - 1, feat.shape[1])
        with timed_phase("pca"):
            Y = empca(feat, d=d, n_iters=15, device=dev)
        if self.checkParam("--doPhase"):
            # amplitude+phase pass: phases of the low-frequency FT of the
            # images appended to the invariant features
            F = torch.fft.fft2(torch.as_tensor(imgs, device=dev).double()
                               )[:, :4, :4].cpu().numpy()
            lowf = np.concatenate([np.angle(F).reshape(B, -1),
                                   np.abs(F).reshape(B, -1)], axis=1)
            lowf = (lowf - lowf.mean(0)) / np.maximum(lowf.std(0), 1e-8)
            Y = np.concatenate([Y, 0.25 * lowf], axis=1)
        k = min(self.getIntParam("--nref"), B)
        with timed_phase("kmeans"):
            lab = _kmeans(Y, k, np.random.default_rng(0), device=dev)
        nmin = self.getIntParam("--nmin")
        for _ in range(max(self.getIntParam("--iter") - 1, 0)):
            # dissolve classes smaller than nmin, reassign to the nearest
            # surviving centroid (reference --nmin/--iter contract)
            uniq, counts = np.unique(lab, return_counts=True)
            alive = uniq[counts >= max(nmin, 1)]
            if len(alive) == 0:
                break
            cents = np.stack([Y[lab == c].mean(axis=0) for c in alive])
            dists = ((Y[:, None, :] - cents[None]) ** 2).sum(-1)
            lab = alive[np.argmin(dists, axis=1)]
            if len(alive) == len(uniq):
                break
        # relabel contiguously
        uniq, lab = np.unique(lab, return_inverse=True)
        fn_out = (self.getParam("-o")
                  if self.checkParam("-o") and self.getParam("-o")
                  else root + "_classes.xmd")
        if self.writer:
            MetaData.fromRows(dict(r, ref=int(lab[i]) + 1)
                              for i, r in enumerate(rows)).write(fn_out)
        self.labels = lab
        if self.verbose:
            print(f"{len(uniq)} FTTRI classes of {B} particles")


class ProgClassifyCLTomo(XmippProgram):
    """Missing-wedge-aware subtomogram classification: the wedge-masked,
    band-limited Fourier magnitudes of the subtomograms (their 3-D FFTs in
    float64 on the card, in chunks), whitened per frequency, then k-means
    (the draws on the host, the distances on the card)."""
    name = "xmipp_classify_CLTomo_prog"

    def defineParams(self):
        self.addUsageLine("Missing-wedge-aware subtomogram classification "
                          "(CLTomo role): iterative assignment to class "
                          "averages with wedge-masked Fourier correlation.")
        self.addParamsLine("   -i <md>        : Subtomograms")
        self.addParamsLine("   -o <md>        : Output classes")
        self.addParamsLine("  [--nref <k=2>]  : Number of classes")
        self.addParamsLine("  [--maxTilt <t=60>] : Tilt range defining the wedge")
        self.addParamsLine("  [--maxFreq <f=0.25>] : Feature band limit (digital freq)")
        self.addParamsLine("  [--iter <n=10>] : Iterations")
        self.addParamsLine("  [--oroot <root=class>] : Class average rootname")

    def run(self):
        from xmipp3_tpu_torch.programs.scripts_misc import _kmeans
        dev = resolve_device(self.getParam("--device"))
        md = MetaData(self.getParam("-i"))
        rows = list(md.iterRows())
        with timed_phase("read subtomograms"):
            vols = np.stack([np.squeeze(Image(r["image"]).data)
                             for r in rows]).astype(np.float32)
        B, N = len(vols), vols.shape[-1]
        k = min(self.getIntParam("--nref"), B)
        # missing-wedge mask (y-axis tilt): |fz| <= |fx| tan(maxTilt); the
        # features are the wedge-masked Fourier MAGNITUDES, whitened per
        # frequency, inside the band (the reference's measured purities:
        # 0.94 against 0.63 for complex features, 1.0 against 0.58
        # without the band limit, on a two-class synthetic set)
        f = np.fft.fftfreq(N)
        fz, fy, fx = np.meshgrid(f, f, f, indexing="ij")
        wedge = np.abs(fz) <= np.abs(fx) * np.tan(
            np.deg2rad(self.getDoubleParam("--maxTilt"))) + 1e-9
        keep = wedge & (np.sqrt(fx ** 2 + fy ** 2 + fz ** 2)
                        < self.getDoubleParam("--maxFreq"))
        idx = torch.as_tensor(np.flatnonzero(keep.ravel()), device=dev)
        with timed_phase("spectra"):
            step = max(1, (1 << 27) // (16 * N ** 3))
            mag = torch.cat([
                torch.fft.fftn(torch.as_tensor(vols[s:s + step], device=dev)
                               .double(), dim=(1, 2, 3)).reshape(
                    -1, N ** 3)[:, idx].abs()
                for s in range(0, B, step)])
            mag = mag / mag.mean(0, keepdim=True).clamp(min=1e-9)
            mag = (mag - mag.mean(0)) / mag.std(0, correction=0).clamp(
                min=1e-9)
        with timed_phase("kmeans"):
            lab = _kmeans(mag, k, np.random.default_rng(0),
                          iters=self.getIntParam("--iter"), device=dev)
        root = self.getParam("--oroot")
        for c in range(k):
            if (lab == c).any():
                save_image(f"{root}{c + 1:03d}.vol",
                           vols[lab == c].mean(axis=0))
        MetaData.fromRows(dict(r, ref=int(lab[i]) + 1)
                          for i, r in enumerate(rows)).write(
            self.getParam("-o"))
        self.labels = lab
        if self.verbose:
            print(f"{k} CLTomo classes of {B} subtomograms")


class ProgVolumeInitialSimulatedAnnealing(XmippProgram):
    """Ab-initio volume by simulated annealing over per-image poses, then
    greedy gallery matching. The poses and the Metropolis draws come from
    numpy's default_rng(0) on the host, in the reference's order; the
    reconstructions (SIRT, its passes gridded by K3), the reprojections and
    their correlations, the gallery and the matching (K4) run on the
    card."""
    name = "xmipp_volume_initial_simulated_annealing"

    def defineParams(self):
        self.addUsageLine("Ab-initio volume from projections by stochastic "
                          "orientation search: random-assignment iterations "
                          "followed by greedy gallery matching "
                          "(volume_initial_simulated_annealing role).")
        self.addParamsLine("   -i <md>        : Input particle images")
        self.addParamsLine("  [--oroot <root=rec_random>] : Output rootname")
        self.addParamsLine("  [--sym <s=c1>]  : Symmetry")
        self.addParamsLine("  [--randomIter <n=3>] : Random-assignment iterations")
        self.addParamsLine("  [--greedyIter <n=3>] : Greedy refinement iterations")
        self.addParamsLine("  [--rejection <p=25>] : Percent worst-correlating images rejected")
        self.addParamsLine("  [--angSampling <a=20>] : Gallery step (deg) for greedy phase")
        self.addParamsLine("   alias --angularSampling;")
        self.addParamsLine("  [--T0 <T=0.1>] : Initial annealing "
                           "temperature (Metropolis acceptance of worse "
                           "assignments in the random iterations)")
        self.addParamsLine("  [--initial <vol=\"\">] : Initial volume")
        self.addParamsLine("  [--keepIntermediateVolumes] : Save the "
                           "volume of every iteration")
        self.addParamsLine("  [--dontApplyPositive] : Skip the positivity "
                           "constraint in the random iterations")

    def run(self):
        from xmipp3_tpu_torch.core.sampling import compute_sampling_points
        from xmipp3_tpu_torch.ops.art import sirt_reconstruct
        from xmipp3_tpu_torch.ops.match import match_to_gallery
        from xmipp3_tpu_torch.ops.project import FourierProjector
        from xmipp3_tpu_torch.ops.shift import correlation_index
        self.refuse_unread("--sym", item=24)
        dev = resolve_device(self.getParam("--device"))
        md = MetaData(self.getParam("-i"))
        md.removeDisabled()
        rows = list(md.iterRows())
        imgs = torch.as_tensor(load_image_rows(rows), device=dev)
        B = len(imgs)
        rng = np.random.default_rng(0)
        rej = self.getDoubleParam("--rejection") / 100.0
        n_rand = self.getIntParam("--randomIter")
        n_greedy = self.getIntParam("--greedyIter")
        step = self.getDoubleParam("--angSampling")
        T = self.getDoubleParam("--T0")
        positive = not self.checkParam("--dontApplyPositive")
        keep_vols = self.checkParam("--keepIntermediateVolumes")
        root = self.getParam("--oroot")

        def reconstruct(rot, tilt, psi, keep, clamp):
            sel = torch.as_tensor(np.flatnonzero(keep), device=dev)
            with timed_phase("sirt"):
                vol, _ = sirt_reconstruct(imgs[sel], rot[keep], tilt[keep],
                                          psi[keep], n_iters=3, device=dev)
            return vol.clamp(min=0.0) if clamp else vol

        def score_of(vol, rot, tilt, psi):
            with timed_phase("score"):
                proj = FourierProjector(vol, device=dev).project_euler(
                    rot, tilt, psi)
                return correlation_index(proj, imgs).cpu().numpy()

        def random_pose():
            return (rng.uniform(-180, 180, B).astype(np.float32),
                    np.degrees(np.arccos(rng.uniform(-1, 1, B))
                               ).astype(np.float32),
                    rng.uniform(-180, 180, B).astype(np.float32))

        def save(fn, vol):
            save_image(fn, vol.cpu().numpy().astype(np.float32))

        # the --initial volume if given, else a first random reconstruction
        rot, tilt, psi = random_pose()
        everyone = np.ones(B, bool)
        if self.getParam("--initial"):
            vol = torch.as_tensor(np.squeeze(Image(
                self.getParam("--initial")).data).astype(np.float32),
                device=dev)
        else:
            vol = reconstruct(rot, tilt, psi, everyone, positive)
        cc = score_of(vol, rot, tilt, psi)
        # simulated annealing over per-image orientation assignments:
        # proposals that improve the reprojection correlation are always
        # accepted, worse ones with probability exp(dcc/T); T cools
        # geometrically (volume_initial_simulated_annealing.cpp --T0)
        for it in range(max(n_rand, 1)):
            prot, ptilt, ppsi = random_pose()
            pcc = score_of(vol, prot, ptilt, ppsi)
            dcc = pcc - cc
            accept = (dcc > 0) | (rng.random(B) < np.exp(
                np.minimum(dcc / max(T, 1e-6), 0.0)))
            rot = np.where(accept, prot, rot)
            tilt = np.where(accept, ptilt, tilt)
            psi = np.where(accept, ppsi, psi)
            vol = reconstruct(rot, tilt, psi, everyone, positive)
            cc = score_of(vol, rot, tilt, psi)
            T *= 0.9
            if keep_vols:
                save(f"{root}_random{it + 1:02d}.vol", vol)
            if self.verbose:
                print(f"random iter {it + 1}: mean CC "
                      f"{float(cc.mean()):.4f} "
                      f"(accepted {int(accept.sum())}/{B}, T={T:.4f})")
        dirs = compute_sampling_points(step)
        for it in range(n_greedy):
            with timed_phase("gallery"):
                gallery = FourierProjector(vol, device=dev).project_euler(
                    dirs[:, 0].astype(np.float32),
                    dirs[:, 1].astype(np.float32),
                    np.zeros(len(dirs), np.float32))
            with timed_phase("match"):
                res = match_to_gallery(gallery, imgs)
            ref = res["ref_idx"].cpu().numpy()
            rot = dirs[ref, 0].astype(np.float32)
            tilt = dirs[ref, 1].astype(np.float32)
            psi = -res["psi"].cpu().numpy().astype(np.float32)
            cc = res["corr"].cpu().numpy()
            keep = cc >= np.quantile(cc, rej)
            vol = reconstruct(rot, tilt, psi, keep, False)
            if keep_vols:
                save(f"{root}_greedy{it + 1:02d}.vol", vol)
            if self.verbose:
                print(f"greedy iter {it + 1}: mean CC "
                      f"{float(cc.mean()):.4f} (kept {keep.sum()}/{B})")
        self.volume = vol.cpu().numpy().astype(np.float32)
        save_image(root + ".vol", self.volume)
        MetaData.fromRows(
            dict(r, angleRot=float(rot[i]), angleTilt=float(tilt[i]),
                 anglePsi=float(psi[i])) for i, r in enumerate(rows)
        ).write(root + ".xmd")
        if self.verbose:
            print(f"initial volume -> {root}.vol")


class ProgPhantomTransform(XmippProgram):
    """Shift, scale or rotate a phantom description or the atoms of a PDB
    file (host text and numpy, as in the reference)."""
    name = "xmipp_phantom_transform"

    def defineParams(self):
        self.addUsageLine("Apply shift/scale/rotate to a phantom "
                          "description or PDB (phantom_transform contract).")
        self.addParamsLine("   -i <file>  : .descr phantom or .pdb")
        self.addParamsLine("  [-o <file=\"\">] : Output (defaults to input for .descr)")
        self.addParamsLine("   --operation <op> : Operation")
        self.addParamsLine("      where <op>")
        self.addParamsLine("            shift <x> <y> <z> : Shift vector")
        self.addParamsLine("            scale <x> <y> <z> : Scale vector")
        self.addParamsLine("            rotate_euler <rot> <tilt> <psi> : Euler rotation")
        self.addParamsLine("  [--center_pdb]  : Subtract the center of mass from the coordinates before transforming (phantom_transform.cpp:61)")

    def run(self):
        from xmipp3_tpu_torch.core.geometry import euler_matrix
        op = self.getParam("--operation", 0)
        args = [self.getDoubleParam("--operation", i) for i in (1, 2, 3)]
        fn_in = self.getParam("-i")
        fn_out = self.getParam("-o") or fn_in
        atom = ("ATOM", "HETATM")
        xyz = lambda ln: [float(ln[30:38]), float(ln[38:46]),
                          float(ln[46:54])]
        com = np.zeros(3)
        if self.checkParam("--center_pdb") and fn_in.endswith(".pdb"):
            pts = [xyz(ln) for ln in open(fn_in) if ln.startswith(atom)]
            if pts:
                com = np.mean(np.asarray(pts, np.float64), axis=0)
        M = np.asarray(euler_matrix(*(np.array([a]) for a in args)))[0]

        def xform(p):
            p = np.asarray(p, np.float64) - com
            if op == "shift":
                return p + args
            if op == "scale":
                return p * args
            return p @ M.T

        if fn_in.endswith(".pdb"):
            lines = open(fn_in).readlines()
            with open(fn_out, "w") as f:
                for ln in lines:
                    if ln.startswith(atom):
                        p = xform(xyz(ln))
                        ln = (ln[:30] + f"{p[0]:8.3f}{p[1]:8.3f}{p[2]:8.3f}"
                              + ln[54:])
                    f.write(ln)
        else:
            from xmipp3_tpu_torch.ops.phantom import Phantom
            ph = Phantom.read(fn_in)
            for feat in ph.features:
                feat.center = np.asarray(xform(feat.center))
                if op == "scale":
                    feat.params = [v * float(np.mean(args))
                                   for v in feat.params]
            ph.write(fn_out)
        if self.verbose:
            print(f"{op} applied -> {fn_out}")


class ProgVolumeToWeb(XmippProgram):
    """Montages of a volume's slices and of its three projections (the
    sums on the card; the montage on the host)."""
    name = "xmipp_volume_to_web"

    def defineParams(self):
        self.addUsageLine("Create web-friendly representations of a volume: "
                          "a montage of central slices and/or projections "
                          "(volume_to_web contract; output normally jpg/png).")
        self.addParamsLine("   -i <volume>    : Input volume")
        self.addParamsLine("  [--central_slices <img=\"\"> <n=-1>] : Slice montage (-1 = all)")
        self.addParamsLine("  [--projections <img=\"\">] : X/Y/Z projection montage")
        self.addParamsLine("  [--maxWidth <w=800>]   : Maximum montage width")
        self.addParamsLine("  [--separation <s=2>]   : Pixels between tiles")

    @staticmethod
    def _montage(tiles, max_w, sep):
        n, h, w = tiles.shape
        per_row = max(min(n, max_w // (w + sep)), 1)
        rows = int(np.ceil(n / per_row))
        canvas = np.zeros((rows * (h + sep) - sep,
                           per_row * (w + sep) - sep), np.float32)
        for i, t in enumerate(tiles):
            r, c = divmod(i, per_row)
            canvas[r * (h + sep):r * (h + sep) + h,
                   c * (w + sep):c * (w + sep) + w] = t
        return canvas

    def run(self):
        dev = resolve_device(self.getParam("--device"))
        vol = np.squeeze(Image(self.getParam("-i")).data).astype(np.float32)
        Z = vol.shape[0]
        max_w = self.getIntParam("--maxWidth")
        sep = self.getIntParam("--separation")
        if self.getParam("--central_slices"):
            n = self.getIntParam("--central_slices", 1)
            idx = (np.arange(Z) if n <= 0 else
                   np.linspace(Z // 4, 3 * Z // 4, n).astype(int))
            save_image(self.getParam("--central_slices"),
                       self._montage(vol[idx], max_w, sep))
        if self.getParam("--projections"):
            v = torch.as_tensor(vol, device=dev)
            projs = np.stack([v.sum(dim=a).cpu().numpy() for a in (0, 1, 2)])
            save_image(self.getParam("--projections"),
                       self._montage(projs, max_w, sep))
        if self.verbose:
            print("web representations written")


class ProgResolutionPdbBfactor(XmippProgram):
    """Per-residue B-factors against the local resolution around each
    C-alpha (the PDB text and the 3^3 neighbourhoods on the host, as in
    the reference)."""
    name = "xmipp_resolution_pdb_bfactor"

    def defineParams(self):
        self.addUsageLine("Compare per-residue PDB B-factors with the local "
                          "resolution around each C-alpha "
                          "(resolution_pdb_bfactor contract).")
        self.addParamsLine("   --atmodel <pdb>  : Atomic model (fitted to the map)")
        self.addParamsLine("   --vol <volume>   : Local resolution map")
        self.addParamsLine("  [--sampling <Ts=1>] : Sampling rate (A)")
        self.addParamsLine("  [--useMedian]    : Median instead of mean per residue")
        self.addParamsLine("  [--centered]     : Atomic model centered at the map middle")
        self.addParamsLine("  [--fscResolution <R=-1>] : Normalize the local "
                           "resolution LR as (LR-R)/R against this global "
                           "FSC resolution (Å)")
        self.addParamsLine("   -o <md>          : Output per-residue metadata")

    def run(self):
        vol = np.squeeze(Image(self.getParam("--vol")).data
                         ).astype(np.float32)
        Ts = self.getDoubleParam("--sampling")
        N = vol.shape[0]
        agg = np.median if self.checkParam("--useMedian") else np.mean
        residues = {}
        for ln in open(self.getParam("--atmodel")):
            if not ln.startswith("ATOM") or ln[12:16].strip() != "CA":
                continue
            p = np.array([float(ln[30:38]), float(ln[38:46]),
                          float(ln[46:54])]) / Ts
            if self.checkParam("--centered"):
                p = p + N // 2
            iz, iy, ix = int(round(p[2])), int(round(p[1])), int(round(p[0]))
            if not all(1 <= v < N - 1 for v in (iz, iy, ix)):
                continue
            r = residues.setdefault((ln[21], int(ln[22:26])),
                                    {"b": [], "r": []})
            r["b"].append(float(ln[60:66]))
            r["r"].append(float(agg(vol[iz - 1:iz + 2, iy - 1:iy + 2,
                                        ix - 1:ix + 2])))
        fsc_res = self.getDoubleParam("--fscResolution")
        rows = []
        for (_, resi), v in sorted(residues.items()):
            lr = float(agg(v["r"]))
            if fsc_res > 0:
                # reference resolution_pdb_bfactor.cpp:57 — normalized
                # local resolution (LR - R)/R
                lr = (lr - fsc_res) / fsc_res
            rows.append({"resolution": lr, "bfactor": float(agg(v["b"])),
                         "residue": int(resi)})
        MetaData.fromRows(rows).write(self.getParam("-o"))
        if rows:
            r = np.array([x["resolution"] for x in rows])
            b = np.array([x["bfactor"] for x in rows])
            self.correlation = float(np.corrcoef(r, b)[0, 1]) \
                if len(rows) > 2 else 0.0
            if self.verbose:
                print(f"{len(rows)} residues; resolution-bfactor corr "
                      f"{self.correlation:.3f}")


class ProgPerformanceTest(XmippProgram):
    """Times a batched rfft2 and a batched float32 matmul (TF32 off) on the
    device, synchronised, after one warm-up call each."""
    name = "xmipp_performance_test"

    def defineParams(self):
        self.addUsageLine("Device/host performance micro-benchmark "
                          "(mpi_performance_test role): batched FFT and "
                          "matmul throughput on the active backend.")
        self.addParamsLine("  [-i <selfile=\"\">] : Selfile with "
                           "experimental images; times the metadata read "
                           "(the reference mpi_performance_test.cpp:68 "
                           "behavior)")
        self.addParamsLine("  [--size <n=256>]  : Problem size")
        self.addParamsLine("  [--batch <b=64>]  : Batch")

    def run(self):
        from xmipp3_tpu_torch.device import fp32_products
        dev = resolve_device(self.getParam("--device"))
        if self.getParam("-i"):
            t0 = time.perf_counter()
            md = MetaData(self.getParam("-i"))
            dt = time.perf_counter() - t0
            print(f"metadata read: {md.size()} rows in {dt * 1e3:.1f} ms")
            self.md_read_s = dt
        n = self.getIntParam("--size")
        b = self.getIntParam("--batch")
        x = torch.as_tensor(np.random.default_rng(0).normal(
            size=(b, n, n)).astype(np.float32), device=dev)
        sync = (lambda: torch.cuda.synchronize(dev)) \
            if dev.type == "cuda" else (lambda: None)

        def timed(fn):
            float(fn())                      # warm-up
            sync()
            t0 = time.perf_counter()
            float(fn())
            sync()
            return time.perf_counter() - t0

        with fp32_products():
            t_fft = timed(lambda: torch.fft.rfft2(x).abs().sum())
            t_mm = timed(lambda: torch.bmm(x, x.transpose(1, 2)).sum())
        self.results = {"fft_s": t_fft, "matmul_s": t_mm,
                        "matmul_gflops": 2 * b * n ** 3 / t_mm / 1e9}
        print(f"fft2 {b}x{n}^2: {t_fft * 1e3:.1f} ms; matmul: "
              f"{t_mm * 1e3:.1f} ms "
              f"({self.results['matmul_gflops']:.1f} GFLOP/s)")


class ProgWriteTest(XmippProgram):
    """Times writing a stack of zeros to a file (the filesystem's rate;
    nothing runs on the device)."""
    name = "xmipp_write_test"

    def defineParams(self):
        self.addUsageLine("Filesystem write benchmark (mpi_write_test "
                          "role): time writing an image stack.")
        self.addParamsLine("  [--size <mb=64>]  : Stack size to write (MB)")
        self.addParamsLine("  [-o <file=write_test.mrcs>] : Test file (removed after)")

    def run(self):
        mb = self.getIntParam("--size")
        n = max(int(mb * 1024 * 1024 / (256 * 256 * 4)), 1)
        data = np.zeros((n, 256, 256), np.float32)
        fn = self.getParam("-o")
        t0 = time.perf_counter()
        save_image(fn, data)
        dt = time.perf_counter() - t0
        size_mb = os.path.getsize(fn) / 1e6
        os.remove(fn)
        self.mb_per_s = size_mb / dt
        print(f"wrote {size_mb:.0f} MB in {dt:.2f} s "
              f"({self.mb_per_s:.0f} MB/s)")
