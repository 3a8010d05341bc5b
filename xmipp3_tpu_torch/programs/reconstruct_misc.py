"""Reconstruction programs: reconstruct_art, reconstruct_wbp,
reconstruct_significant, on the card.

Contracts: the reference package's programs/reconstruct_misc.py (reference
reconstruct_art/basic_art, basic_art.h:92; reconstruct_wbp,
reconstruct_wbp.h:47; reconstruct_significant,
reconstruct_significant.h:39). The projections go to the program's device
(--device; the card by default) once; ART's blocks grid their residuals
through K2 and SIRT, WBP and the significance volumes grid with the
Kaiser-Bessel window through K3 (ops/art.py, ops/reconstruct.py);
reconstruct_significant scores every (image, gallery direction) pair
through match_score_matrix (K4), in chunks of SCORE_BATCH images, and
ranks the scores on the card. The host keeps what the reference keeps
there: the metadata, the numpy draws (ART's --noisy_reconstruction noise
and the significance run's first volumes from Generator(0)), the
significance quantile and the output rows.

--mesh (reconstruct_art, reconstruct_significant) runs over the ranks of a
torch.distributed process group (parallel/cli.py): ART's blocks through
parallel_art_correction, the significance scores' chunks dealt to the
ranks by parallel_match_score_matrix (so they equal the serial scores) and
its volumes through parallel_reconstruct. Every rank computes the result;
only rank 0 writes files.
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
from xmipp3_tpu_torch.parallel.cli import (MeshProgram, add_mesh_params,
                                           read_mesh_params)

# images a chunk of reconstruct_significant's score matrix, serial and on a
# mesh alike (the reference scores the stack in one call)
SCORE_BATCH = 512


def _load(md):
    rows = list(md.iterRows())
    with timed_phase("read images"):
        imgs = load_image_rows(rows)
    get = lambda k, d=0.0: np.array([float(r.get(k, d)) for r in rows],
                                    np.float32)
    return imgs, get("angleRot"), get("angleTilt"), get("anglePsi"), \
        get("shiftX"), get("shiftY")


def _host(vol) -> np.ndarray:
    return vol.cpu().numpy() if isinstance(vol, torch.Tensor) \
        else np.asarray(vol, np.float32)


class _Reconstructor(MeshProgram):
    """reconstruct_art and reconstruct_significant read --device and
    --mesh here; the reference reads their other flags in run()."""

    def readParams(self):
        read_mesh_params(self)
        self.device_arg = self.getParam("--device")


class ProgReconstructART(_Reconstructor):
    name = "xmipp_reconstruct_art"

    def defineParams(self):
        self.addUsageLine("Algebraic (ART/SIRT) 3D reconstruction from "
                          "projections (full reference surface, "
                          "basic_art.cpp defineParams).")
        self.addParamsLine("   -i <md_file>  : Metadata with projections")
        self.addParamsLine("  [-o <volume=rec_art.vol>] : Output volume")
        self.addParamsLine("  [-n <iters=5>] : Number of iterations")
        self.addParamsLine("  [-l <lambdas=0.5>] : Relaxation parameter(s), comma-separated per iteration")
        self.addParamsLine("  [--stop_at <n=0>] : Stop after n iterated projections")
        self.addParamsLine("  [--start <vol=\"\">] : Start from this volume")
        self.addParamsLine("  [--ctf <ctf_file=\"\">] : ctfparam applied to the theoretical projections")
        self.addParamsLine("  [--max_tilt <alpha=1.e6>] : skip projections with tilt outside 0/180 +- alpha")
        self.addParamsLine("  [--dont_apply_shifts] : ignore shiftX/shiftY from the metadata")
        self.addParamsLine("  [--refine] : refine the projection alignment against the theoretical projection before backprojecting")
        self.addParamsLine("  [--ref_trans_after <n=-1>] : refine translations after n projections")
        self.addParamsLine("  [--ref_trans_step <v=-1>] : maximum displacement in the refinement (px)")
        self.addParamsLine("  [--POCS_positivity] : Positivity constraint")
        self.addParamsLine("  [--POCS_freq <f=1>] : Apply POCS every f block updates")
        self.addParamsLine("  [--surface <mask=\"\">] : Surface mask volume (forced to 0 where mask=1)")
        self.addParamsLine("  [--known_volume <v=-1>] : keep only the v highest voxels (POCS)")
        self.addParamsLine("  [--sparse <eps=-1>] : sparsity threshold (POCS)")
        self.addParamsLine("  [--diffusion <eps=-1>] : diffusion smoothing weight (POCS)")
        self.addParamsLine("  [--goldmask <v=1.e6>] : image pixels below this value are excluded (gold beads)")
        self.addParamsLine("  [--shiftedTomograms] : exclude zero-valued border pixels created by tomogram alignment")
        self.addParamsLine("  [--noisy_reconstruction] : companion pure-noise reconstruction (for SSNR)")
        self.addParamsLine("  [--variability] : variability analysis (block-wise variance volume)")
        self.addParamsLine("  [--sym <sym=\"\">] : symmetry group or file")
        self.addParamsLine("  [--sym_each <n=0>] : symmetrize the volume every n projections")
        self.addParamsLine("  [--force_sym <n=0>] : symmetrize at every POCS step")
        self.addParamsLine("  [--no_group] : do not expand to the symmetry subgroup")
        self.addParamsLine("  [--no_symproj] : do not add symmetrized projections")
        self.addParamsLine("  [--only_sym] : use only the symmetrized copies, not the originals")
        self.addParamsLine("  [--parallel_mode <m=SIRT>] : ART|pCAV|pAVSP|pSART|pBiCAV|pSIRT|pfSIRT|SIRT (basic_art.h:92)")
        self.addParamsLine("  [--equation_mode <mode=ARTK>] : equation to project onto the hyperplane")
        self.addParamsLine("         where <mode>")
        self.addParamsLine("                  ARTK : block ART")
        self.addParamsLine("                  CAV  : component averaging")
        self.addParamsLine("                  CAVK : block component averaging")
        self.addParamsLine("                  CAVARTK : component-averaging variant of block ART")
        self.addParamsLine("  [--block_size <b=-1>] : Projections per parallel block")
        self.addParamsLine("  [--sort_last <N=2>] : orthogonal projection ordering against the last N insertions (-1 = all)")
        self.addParamsLine("  [--random_sort] : Random projection order")
        self.addParamsLine("  [--no_sort] : keep the input order")
        self.addParamsLine("  [--WLS] : weighted-least-squares ART")
        self.addParamsLine("  [-k <kappas=0.5>] : WLS residual relaxation factor(s), comma-separated")
        self.addParamsLine("  [-R <r=-1>] : interest-sphere radius (px)")
        self.addParamsLine("  [--ext <px=0>] : projection extension (px) against the box effect")
        self.addParamsLine("  [--output_size <X=0> <Y=0> <Z=0>] : output volume size (0 = projection size)")
        self.addParamsLine("  [--sampling_rate <Ts=1>] : pixel size (Å), stored in the output header")
        self.addParamsLine("  [--show_error] : per-block residual printout")
        self.addParamsLine("  [--show_stats] : per-iteration statistics")
        self.addParamsLine("  [--show_iv <n=10>] : alias of --show_stats granularity (accepted)")
        self.addParamsLine("  [--save_intermediate <n=0>] : save the volume every iteration as <root>it<N>.vol")
        add_mesh_params(self)

    def _sym_expand(self, imgs, rot, tilt, psi, sx, sy):
        """--sym: add symmetrized projection copies (reference
        --no_symproj/--only_sym gates; the symmetry orbit of each pose
        contributes an equivalent projection)."""
        from xmipp3_tpu_torch.core.geometry import euler_matrix, matrix_to_euler
        from xmipp3_tpu_torch.core.sym import SymList
        sym = self.getParam("--sym")
        if not sym:
            return imgs, rot, tilt, psi, sx, sy, None
        mats = SymList(sym).sym_matrices()
        if self.checkParam("--no_group") and len(mats) > 1:
            # only the generators, no subgroup expansion: keep identity +
            # the first non-identity element
            mats = mats[:2]
        if self.checkParam("--no_symproj") or len(mats) <= 1:
            return imgs, rot, tilt, psi, sx, sy, mats
        A = np.asarray(euler_matrix(rot, tilt, psi))
        out_i, out_r, out_t, out_p, out_x, out_y = [], [], [], [], [], []
        ks = range(1, len(mats)) if self.checkParam("--only_sym") \
            else range(len(mats))
        for k in ks:
            comp = np.einsum("nij,jk->nik", A, mats[k].T)
            eul = np.array([matrix_to_euler(c) for c in comp])
            out_i.append(imgs)
            out_r.append(eul[:, 0].astype(np.float32))
            out_t.append(eul[:, 1].astype(np.float32))
            out_p.append(eul[:, 2].astype(np.float32))
            out_x.append(sx)
            out_y.append(sy)
        return (np.concatenate(out_i), np.concatenate(out_r),
                np.concatenate(out_t), np.concatenate(out_p),
                np.concatenate(out_x), np.concatenate(out_y), mats)

    def _run(self, mesh):
        from xmipp3_tpu_torch.ops.art import art_reconstruct
        md = MetaData(self.getParam("-i"))
        md.removeDisabled()
        imgs, rot, tilt, psi, sx, sy = _load(md)
        # --max_tilt: tilt within 0 +- a or 180 +- a (angles mod 360)
        a = self.getDoubleParam("--max_tilt")
        if a < 1e5:
            t = np.mod(tilt, 360.0)
            keep = (np.minimum(t, 360.0 - t) <= a) | (np.abs(t - 180.0) <= a)
            imgs, rot, tilt, psi = imgs[keep], rot[keep], tilt[keep], \
                psi[keep]
            sx, sy = sx[keep], sy[keep]
        if self.checkParam("--dont_apply_shifts"):
            sx = np.zeros_like(sx)
            sy = np.zeros_like(sy)
        imgs, rot, tilt, psi, sx, sy, sym_mats = \
            self._sym_expand(imgs, rot, tilt, psi, sx, sy)
        # pixel exclusion masks: --goldmask / --shiftedTomograms
        pixel_masks = None
        gold = self.getDoubleParam("--goldmask")
        if gold < 1e5 or self.checkParam("--shiftedTomograms"):
            pixel_masks = np.ones_like(imgs)
            if gold < 1e5:
                pixel_masks *= (imgs >= gold)
            if self.checkParam("--shiftedTomograms"):
                pixel_masks *= (imgs != 0.0)
        # --ext: pad projections against the box effect
        ext = self.getIntParam("--ext")
        if ext > 0:
            pad = ((0, 0), (ext, ext), (ext, ext))
            imgs = np.pad(imgs, pad)
            if pixel_masks is not None:
                pixel_masks = np.pad(pixel_masks, pad)
        lambdas = [float(v) for v in
                   str(self.getParam("-l")).split(",") if v]
        kappas = [float(v) for v in str(self.getParam("-k")).split(",")
                  if v]
        bs = self.getIntParam("--block_size")
        surf = None
        if self.checkParam("--surface") and self.getParam("--surface"):
            surf = np.squeeze(Image(self.getParam("--surface")).data)
        init_vol = None
        if self.checkParam("--start") and self.getParam("--start"):
            init_vol = np.squeeze(Image(self.getParam("--start")).data)
        ctf = None
        if self.checkParam("--ctf") and self.getParam("--ctf"):
            from xmipp3_tpu_torch.ops.ctf import CTFDescription
            ctf = CTFDescription.from_metadata(self.getParam("--ctf"))
        mode = self.getParam("--parallel_mode")
        if self.checkParam("--equation_mode"):
            # reference equation modes map onto the parallel family:
            # ARTK = block ART, CAV = component averaging (one
            # simultaneous CAV update), CAVK = block CAV, CAVARTK = the
            # block-iterative CAV variant (basic_art.h:92-116)
            mode = {"ARTK": "ART", "CAV": "pCAV", "CAVK": "pBiCAV",
                    "CAVARTK": "pSART"}[self.getParam("--equation_mode")]
        fn_out = self.getParam("-o")
        root = fn_out.rsplit(".", 1)[0]
        save_cb = None
        if self.checkParam("--save_intermediate") and self.writer:
            def save_cb(it, v):
                save_image(f"{root}it{it}.vol", self._finish_vol(v, ext))
        kw = dict(
            mode=mode, n_iters=self.getIntParam("-n"), lambda_list=lambdas,
            block_size=None if bs <= 0 else bs,
            positivity=self.checkParam("--POCS_positivity"),
            surface_mask=surf, pocs_freq=self.getIntParam("--POCS_freq"),
            random_sort=self.checkParam("--random_sort"),
            verbose=self.verbose or self.checkParam("--show_stats"),
            mesh=mesh, init_vol=init_vol,
            stop_at=self.getIntParam("--stop_at"),
            sort_last=(self.getIntParam("--sort_last")
                       if self.checkParam("--sort_last") else 0),
            no_sort=not self.checkParam("--sort_last"),
            known_volume=self.getDoubleParam("--known_volume"),
            sparse_eps=self.getDoubleParam("--sparse"),
            diffusion_eps=self.getDoubleParam("--diffusion"),
            sphere_R=self.getDoubleParam("-R"), sym_mats=sym_mats,
            sym_each=self.getIntParam("--sym_each"),
            force_sym=self.getIntParam("--force_sym"),
            wls=self.checkParam("--WLS"), kappa_list=kappas,
            pixel_masks=pixel_masks, ctf=ctf,
            refine=self.checkParam("--refine"),
            ref_trans_after=self.getIntParam("--ref_trans_after"),
            ref_trans_step=self.getDoubleParam("--ref_trans_step"),
            show_error=self.checkParam("--show_error"),
            save_intermediate=save_cb, device=self.device)
        with timed_phase("reconstruct"):
            vol, hist = art_reconstruct(imgs, rot, tilt, psi, sx=sx, sy=sy,
                                        **kw)
            vol = self._finish_vol(vol, ext)
        self.residual_history = hist
        Ts = self.getDoubleParam("--sampling_rate")
        if self.writer:
            save_image(fn_out, vol, sampling=Ts)
        if self.checkParam("--noisy_reconstruction"):
            # companion reconstruction from pure noise, same procedure
            # (reference --noisy_reconstruction outputs for SSNR)
            rng = np.random.default_rng(0)
            noise = rng.normal(0.0, imgs.std(),
                               imgs.shape).astype(np.float32)
            if self.writer:
                save_image(root + "_noise_proj.stk", noise)
                MetaData.fromRows([
                    {"image": f"{i + 1:06d}@{root}_noise_proj.stk",
                     "angleRot": float(rot[i]), "angleTilt": float(tilt[i]),
                     "anglePsi": float(psi[i]), "itemId": i + 1}
                    for i in range(len(noise))]).write(
                        root + "_noise_proj.sel")
                md.write(root + "_signal_proj.sel")
            nvol, _ = art_reconstruct(noise, rot, tilt, psi, sx=sx, sy=sy,
                                      **dict(kw, save_intermediate=None))
            if self.writer:
                save_image(root + "_noise.vol", self._finish_vol(nvol, ext),
                           sampling=Ts)
        if self.checkParam("--variability"):
            # block-wise variance volume (reference variability analysis)
            nb = min(8, len(imgs))
            vols = []
            for blk in np.array_split(np.arange(len(imgs)), nb):
                v, _ = art_reconstruct(
                    imgs[blk], rot[blk], tilt[blk], psi[blk], sx=sx[blk],
                    sy=sy[blk], **dict(kw, save_intermediate=None,
                                       stop_at=0))
                vols.append(self._finish_vol(v, ext))
            if self.writer:
                save_image(root + "_variability.vol",
                           np.stack(vols).var(axis=0).astype(np.float32),
                           sampling=Ts)

    def _finish_vol(self, vol, ext):
        """The volume on the host, with the --ext padding cropped back and
        --output_size applied."""
        vol = _host(vol)
        if ext > 0:
            vol = vol[ext:-ext, ext:-ext, ext:-ext]
        if self.checkParam("--output_size"):
            X = self.getIntParam("--output_size", 0)
            Y = self.getIntParam("--output_size", 1)
            Z = self.getIntParam("--output_size", 2)
            if X > 0:
                Y = Y or X
                Z = Z or X
                out = np.zeros((Z, Y, X), np.float32)
                sz = [min(a, b) for a, b in zip(vol.shape, (Z, Y, X))]
                so = [(a - c) // 2 for a, c in zip(vol.shape, sz)]
                do = [(a - c) // 2 for a, c in zip((Z, Y, X), sz)]
                out[do[0]:do[0] + sz[0], do[1]:do[1] + sz[1],
                    do[2]:do[2] + sz[2]] = \
                    vol[so[0]:so[0] + sz[0], so[1]:so[1] + sz[1],
                        so[2]:so[2] + sz[2]]
                return out
        return np.asarray(vol, np.float32)


class ProgReconstructWBP(XmippProgram):
    """Full reference grammar reconstruct_wbp.cpp:96-161 with the
    Radermacher arbitrary-geometry filter (filterOneImage :437-492)."""
    name = "xmipp_reconstruct_wbp"

    def defineParams(self):
        self.addUsageLine("Weighted back-projection 3D reconstruction "
                          "(Radermacher arbitrary-geometry weighting).")
        self.addParamsLine("   -i <md_file>  : selection file with input "
                           "images and Euler angles")
        self.addParamsLine("  [-o <volume=wbp.vol>] : filename for output "
                           "volume")
        self.addParamsLine("  [--doc <docfile=\"\">] : Ignore headers and "
                           "get angles from this docfile")
        self.addParamsLine("  [--radius <int=-1>] : Reconstruction radius "
                           "(-1 = dim/2); the volume is zero outside")
        self.addParamsLine("  [--sym <sym=\"\">] : Enforce symmetry")
        self.addParamsLine("  [--threshold <float=0.005>] : Lower relative "
                           "threshold for filter values")
        self.addParamsLine("  [--filsam <float=5>] : Angular sampling rate "
                           "for the geometry filter directions")
        self.addParamsLine("  [--use_each_image] : Use each image instead "
                           "of sampled representatives for the filter")
        self.addParamsLine("  [--weight] : Use weights stored in the input "
                           "metadata")
        self.addParamsLine("  [--diameter <d=-1>] : Use the classic ramp "
                           "filter with this object diameter instead of "
                           "the arbitrary-geometry filter")

    def run(self):
        from xmipp3_tpu_torch.ops.art import wbp_reconstruct
        from xmipp3_tpu_torch.ops.fourier import fourier_shift_2d
        dev = resolve_device(self.getParam("--device"))
        torch.backends.cuda.matmul.allow_tf32 = False
        md = MetaData(self.getParam("-i"))
        md.removeDisabled()
        fn_doc = self.getParam("--doc")
        if fn_doc:
            md_doc = MetaData(fn_doc)
            imgs, _, _, _, _, _ = _load(md)
            _, rot, tilt, psi, sx, sy = _load(md_doc)
        else:
            imgs, rot, tilt, psi, sx, sy = _load(md)
        imgs = torch.as_tensor(imgs, device=dev)
        if np.any(sx) or np.any(sy):
            imgs = fourier_shift_2d(imgs, sx, sy)
        weights = None
        if self.checkParam("--weight"):
            rows = list(md.iterRows())
            weights = np.array([float(r.get("weight", 1.0)) for r in rows],
                               np.float32)
        d = self.getDoubleParam("--diameter")
        radius = self.getIntParam("--radius")
        N = imgs.shape[-1]
        diameter = 2 * radius if radius > 0 else N
        with timed_phase("reconstruct"):
            if d > 0:
                vol = wbp_reconstruct(imgs, rot, tilt, psi,
                                      filter_diameter=d)
            else:
                vol = wbp_reconstruct(
                    imgs, rot, tilt, psi, mode="arbitrary", weights=weights,
                    filsam=self.getDoubleParam("--filsam"),
                    sym=self.getParam("--sym") or "c1",
                    use_each_image=self.checkParam("--use_each_image"),
                    threshold=self.getDoubleParam("--threshold"),
                    filter_diameter=diameter)
            vol = _host(vol)
        if radius > 0:
            zz, yy, xx = np.meshgrid(*([np.arange(N) - N // 2] * 3),
                                     indexing="ij")
            vol = np.where(zz * zz + yy * yy + xx * xx
                           <= float(radius) ** 2, vol, 0.0).astype(np.float32)
        save_image(self.getParam("-o"), vol)


class ProgReconstructSignificant(_Reconstructor):
    """Reference grammar: reconstruct_significant.cpp defineParams.
    Significance weighting reuses the align_significant rank-cdf pooling
    (aalign_significant.cpp:283-311) over the full (image, direction)
    correlation matrix."""
    name = "xmipp_reconstruct_significant"

    def defineParams(self):
        self.addUsageLine("Initial-volume estimation by significance-weighted "
                          "angular assignment iterations.")
        self.addParamsLine("   -i <md_file>  : Metadata/stack with class averages")
        self.addParamsLine("  [--odir <dir=.>] : Output directory")
        self.addParamsLine("  [--numberOfVolumes <N=1>] : Number of volumes to reconstruct")
        self.addParamsLine("  [--initvolumes <md=\"\">] : Initial volume(s); else random")
        self.addParamsLine("  [--initgallery <md=\"\">] : Gallery metadata (projections of a single volume) used for the first iteration")
        self.addParamsLine("  [--sym <s=c1>] : Symmetry")
        self.addParamsLine("  [--iter <n=10>] : Iterations")
        self.addParamsLine("  [--alpha0 <a=0.05>] : Initial significance")
        self.addParamsLine("  [--alphaF <a=0.005>] : Final significance")
        self.addParamsLine("  [--angularSampling <a=15>] : Gallery sampling (deg)")
        self.addParamsLine("  [--maxShift <s=-1>] : Maximum shift (px; -1 = dim/8)")
        self.addParamsLine("  [--minTilt <t=0>]  : Minimum gallery tilt (deg)")
        self.addParamsLine("  [--maxTilt <t=90>] : Maximum gallery tilt (deg)")
        self.addParamsLine("  [--useImed]        : Weight with the IMED (Gaussian-coupled image Euclidean distance) of the aligned pair")
        self.addParamsLine("  [--strictDirection] : Images below the significance threshold are fully discarded")
        self.addParamsLine("  [--angDistance <a=10>] : Angular neighborhood for the significance pooling")
        self.addParamsLine("  [--dontApplyFisher] : Plain positive-correlation weights (no rank-cdf significance pooling)")
        self.addParamsLine("  [--dontReconstruct] : Only write the assignment metadata")
        self.addParamsLine("  [--dontCheckMirrors] : Do not check mirrors in the alignment")
        self.addParamsLine("  [--keepIntermediateVolumes] : Save the volume of each iteration")
        self.addParamsLine("  [--useForValidation <n=10>] : Validation mode: write the n best orientations per particle and stop")
        add_mesh_params(self)

    @staticmethod
    def _imed(a, b):
        """IMED merit between aligned pairs, on their device: (a-b)^T G
        (a-b) with a Gaussian coupling (reference useImed weighting)."""
        from xmipp3_tpu_torch.ops.fourier_filter import (
            apply_fourier_mask_2d, real_gaussian_mask)
        diff = a - b
        H, W = diff.shape[-2:]
        g = apply_fourier_mask_2d(diff, real_gaussian_mask(H, W, 1.0))
        return (g * diff).sum(dim=(-2, -1))

    def _gallery(self, vol, angles):
        """Projections of `vol` at the (rot, tilt) rows, on the device."""
        from xmipp3_tpu_torch.ops.project import FourierProjector
        proj = FourierProjector(_host(vol), device=self.device)
        return torch.cat([proj.project_euler(
            angles[s:s + 256, 0], angles[s:s + 256, 1],
            np.zeros(len(angles[s:s + 256]), np.float32))
            for s in range(0, len(angles), 256)])

    def _run(self, mesh):
        from xmipp3_tpu_torch.core.geometry import euler_matrix
        from xmipp3_tpu_torch.core.metadata_program import is_metadata_file
        from xmipp3_tpu_torch.core.sampling import Sampling
        from xmipp3_tpu_torch.ops.match import (match_to_gallery,
                                                refine_winners)
        from xmipp3_tpu_torch.parallel.match import \
            parallel_match_score_matrix
        from xmipp3_tpu_torch.ops.reconstruct import reconstruct_fourier
        from xmipp3_tpu_torch.programs.align_significant import \
            significance_weights
        dev = self.device
        host = lambda t: t.cpu().numpy()

        fn_in = self.getParam("-i")
        with timed_phase("read images"):
            if is_metadata_file(fn_in):
                md = MetaData(fn_in)
                md.removeDisabled()
                imgs = load_image_rows(list(md.iterRows()))
            else:
                imgs = Image.read_stack(fn_in)
        imgs_d = torch.as_tensor(imgs, device=dev)
        B, N, _ = imgs.shape
        sym = self.getParam("--sym")
        n_iters = self.getIntParam("--iter")
        rate = self.getDoubleParam("--angularSampling")
        sampling = Sampling(rate, sym)
        angles = sampling.angles.astype(np.float32)
        tilt_lo = self.getDoubleParam("--minTilt")
        tilt_hi = self.getDoubleParam("--maxTilt")
        keep_t = (angles[:, 1] >= tilt_lo) & (angles[:, 1] <= tilt_hi)
        if keep_t.any():
            angles = angles[keep_t]
        n_vols = self.getIntParam("--numberOfVolumes")
        max_shift = self.getIntParam("--maxShift")
        if max_shift < 0:
            max_shift = N // 8
        alpha0 = self.getDoubleParam("--alpha0")
        alphaF = self.getDoubleParam("--alphaF")
        ang_dist = self.getDoubleParam("--angDistance")
        check_mirror = not self.checkParam("--dontCheckMirrors")
        use_fisher = not self.checkParam("--dontApplyFisher")
        strict = self.checkParam("--strictDirection")
        use_imed = self.checkParam("--useImed")
        odir = self.getParam("--odir")
        rng = np.random.default_rng(0)
        A = np.asarray(euler_matrix(angles[:, 0], angles[:, 1],
                                    np.zeros(len(angles), np.float32)))
        ref_dirs = A[:, 2, :].astype(np.float64)

        # --useForValidation: write the n best orientations and stop
        # (reference validation mode feeding multireference_aligneability)
        if self.checkParam("--useForValidation"):
            n_or = self.getIntParam("--useForValidation")
            vol = np.squeeze(Image(self.getParam("--initvolumes")).data
                             ).astype(np.float32)
            refs = self._gallery(vol, angles)
            res = match_to_gallery(refs, imgs_d, max_shift=max_shift,
                                   n_orientations=n_or,
                                   check_mirror=check_mirror)
            res = {k: host(v) for k, v in res.items()}
            rows = []
            for i in range(B):
                for k in range(n_or):
                    r = int(np.asarray(res["ref_idx"])[i, k])
                    rows.append({
                        "itemId": i + 1,
                        "angleRot": float(angles[r, 0]),
                        "angleTilt": float(angles[r, 1]),
                        "anglePsi": float(np.asarray(res["psi"])[i, k]),
                        "shiftX": float(np.asarray(res["sx"])[i, k]),
                        "shiftY": float(np.asarray(res["sy"])[i, k]),
                        "maxCC": float(np.asarray(res["corr"])[i, k]),
                        "weight": float(max(np.asarray(
                            res["corr"])[i, k], 0.0))})
            if self.writer:
                MetaData.fromRows(rows).write(
                    os.path.join(odir, "angles_validation.xmd"))
            return

        # initial volumes
        vols = []
        fn_init = self.getParam("--initvolumes") \
            if self.checkParam("--initvolumes") else ""
        init_gallery = self.getParam("--initgallery") \
            if self.checkParam("--initgallery") else ""
        if fn_init:
            if is_metadata_file(fn_init):
                vols = [np.squeeze(Image(r["image"]).data).astype(
                    np.float32) for r in MetaData(fn_init).iterRows()]
            else:
                vols = [np.squeeze(Image(fn_init).data).astype(np.float32)]
            n_vols = len(vols)
        elif not init_gallery:
            # random-angle bootstrap per volume (reference random init);
            # images are split randomly across the volumes
            groups = np.array_split(rng.permutation(B), n_vols)
            for g in groups:
                rot0 = rng.uniform(-180, 180, len(g)).astype(np.float32)
                tilt0 = np.degrees(np.arccos(
                    rng.uniform(-1, 1, len(g)))).astype(np.float32)
                psi0 = rng.uniform(-180, 180, len(g)).astype(np.float32)
                vols.append(reconstruct_fourier(
                    imgs[g], rot0, tilt0, psi0, sym=sym, batch=len(g),
                    device=dev))

        last_rows = None
        for it in range(n_iters):
            # alpha schedule: geometric alpha0 -> alphaF (reference
            # iterates the significance from alpha0 to alphaF)
            t = it / max(n_iters - 1, 1)
            alpha = float(alpha0 * (alphaF / alpha0) ** t) \
                if alpha0 > 0 and alphaF > 0 else alpha0
            per_vol = []
            for v in range(max(n_vols, 1)):
                if it == 0 and init_gallery:
                    md_g = MetaData(init_gallery)
                    g_rows = list(md_g.iterRows())
                    refs = torch.as_tensor(load_image_rows(g_rows),
                                           device=dev)
                    g_ang = np.array(
                        [[float(r.get("angleRot", 0.0)),
                          float(r.get("angleTilt", 0.0))]
                         for r in g_rows], np.float32)
                    Ag = np.asarray(euler_matrix(
                        g_ang[:, 0], g_ang[:, 1],
                        np.zeros(len(g_ang), np.float32)))
                    dirs = Ag[:, 2, :].astype(np.float64)
                    ang_v = g_ang
                else:
                    refs = self._gallery(vols[v], angles)
                    dirs = ref_dirs
                    ang_v = angles
                with timed_phase("score", sync=refs):
                    # chunks of SCORE_BATCH images, dealt to the ranks
                    # under --mesh dp (the reference's
                    # mpi_reconstruct_significant image distribution)
                    sm = parallel_match_score_matrix(
                        mesh, refs, imgs_d, max_shift=max_shift,
                        check_mirror=check_mirror, batch=SCORE_BATCH)
                    cc_d = sm["peak"].to(torch.float32)
                    cc = host(cc_d).astype(np.float64)
                    if use_fisher:
                        W = host(significance_weights(cc_d, dirs, ang_dist))
                    else:
                        W = np.maximum(cc, 0.0).astype(np.float32)
                # pose = best raw correlation; the pooled significance W
                # only sets the reconstruction weight (the pooling smears
                # scores over angular neighborhoods and must not move the
                # alignment winner)
                best = cc.argmax(axis=1)
                # refine the selected winners with the shared batched tail
                bi = torch.arange(B, device=dev)
                best_d = torch.as_tensor(best, device=dev)
                tgrid = torch.as_tensor(np.asarray(sm["trials"], np.float32),
                                        device=dev)
                with timed_phase("refine", sync=refs):
                    res = refine_winners(
                        refs, imgs_d, best_d,
                        sm["psi"][bi, best_d].to(torch.float32),
                        tgrid[sm["trial"][bi, best_d].to(torch.int64)],
                        sm["flip"][bi, best_d].to(torch.bool),
                        max_shift, 2, N // 2 - 2)
                w_best = W[np.arange(B), best].astype(np.float64)
                per_vol.append((w_best, best, res, ang_v))
            # assign each image to its best volume; significance
            # threshold keeps the top (1 - alpha) ... alpha-strict tail
            Wall = np.stack([pv[0] for pv in per_vol])     # (V, B)
            v_best = Wall.argmax(axis=0)
            w_img = Wall[v_best, np.arange(B)]
            thresh = np.quantile(w_img, alpha) if B > 1 else -np.inf
            keep = w_img >= thresh
            rows_out = []
            new_vols = []
            for v in range(max(n_vols, 1)):
                w_best, best, res, ang_v = per_vol[v]
                mine = (v_best == v) & keep if n_vols > 1 else keep
                w = np.where(mine, np.maximum(w_best, 0), 0.0)
                if not strict:
                    # soft floor: non-significant images keep a small
                    # weight instead of being discarded
                    w = np.where((v_best == v) & ~keep,
                                 0.1 * np.maximum(w_best, 0), w)
                if use_imed:
                    aligned = res.get("aligned")
                    if aligned is not None:
                        ref_sel = refs[res["ref_idx"]]
                        imed = host(self._imed(aligned, ref_sel))
                        sc = np.exp(-imed / max(np.median(imed), 1e-9))
                        w = w * sc
                w = w.astype(np.float32)
                res_h = {k: host(v) for k, v in res.items()
                         if k != "aligned"}
                ref_idx = res_h["ref_idx"]
                if not self.checkParam("--dontReconstruct"):
                    rec_kw = dict(sx=res_h["sx"].astype(np.float32),
                                  sy=res_h["sy"].astype(np.float32),
                                  weights=w, sym=sym, flip=res_h["flip"])
                    with timed_phase("reconstruct"):
                        if mesh is not None:
                            from xmipp3_tpu_torch.parallel.reconstruct \
                                import parallel_reconstruct
                            new_vols.append(parallel_reconstruct(
                                mesh, imgs, ang_v[ref_idx, 0],
                                ang_v[ref_idx, 1],
                                res_h["psi"].astype(np.float32), **rec_kw))
                        else:
                            new_vols.append(reconstruct_fourier(
                                imgs_d, ang_v[ref_idx, 0], ang_v[ref_idx, 1],
                                res_h["psi"].astype(np.float32), batch=B,
                                device=dev, **rec_kw))
                for i in range(B):
                    if n_vols > 1 and v_best[i] != v:
                        continue
                    rows_out.append({
                        "itemId": i + 1, "ref3d": v + 1,
                        "angleRot": float(ang_v[ref_idx[i], 0]),
                        "angleTilt": float(ang_v[ref_idx[i], 1]),
                        "anglePsi": float(res_h["psi"][i]),
                        "shiftX": float(res_h["sx"][i]),
                        "shiftY": float(res_h["sy"][i]),
                        "flip": int(res_h["flip"][i]),
                        "maxCC": float(res_h["corr"][i]),
                        "weight": float(w[i]),
                        "enabled": 1 if w[i] > 0 else -1})
            last_rows = rows_out
            if new_vols:
                vols = new_vols
            if self.checkParam("--keepIntermediateVolumes") and self.writer:
                for v, vol in enumerate(vols):
                    save_image(os.path.join(
                        odir, f"volume_iter{it + 1:03d}_{v + 1:02d}.vol"),
                        _host(vol))
                MetaData.fromRows(rows_out).write(os.path.join(
                    odir, f"angles_iter{it + 1:03d}.xmd"))
            if self.verbose:
                print(f"  significant iter {it + 1}: alpha {alpha:.4f} "
                      f"mean weight {w_img.mean():.4f} "
                      f"kept {keep.mean() * 100:.0f}%")
            if self.checkParam("--dontReconstruct"):
                break
        if not self.checkParam("--dontReconstruct"):
            self.volume = _host(vols[0])
        if not self.writer:
            return
        if last_rows:
            MetaData.fromRows(last_rows).write(
                os.path.join(odir, "significant_images.xmd"))
        if not self.checkParam("--dontReconstruct"):
            for v, vol in enumerate(vols):
                suffix = f"_{v + 1:02d}" if n_vols > 1 else ""
                save_image(os.path.join(
                    odir, f"significant_volume{suffix}.vol"), _host(vol))


PROGRAM = None
