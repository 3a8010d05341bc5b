"""Zernike3D programs of the reference package's
programs/zernike_programs.py: xmipp_volume_deform_sph,
xmipp_forward_zernike_volume, xmipp_volume_apply_coefficient_zernike3d
(also registered as volume_apply_deform_sph), xmipp_angular_sph_alignment,
xmipp_forward_zernike_images and xmipp_forward_zernike_images_priors
(reference volume_deform_sph.h:38, volume_apply_deform_sph,
angular_sph_alignment.h:42, forward_zernike_images.{h,cpp}).

Each runs on the card unless `--device cpu` is given: the warps, the
Fourier projections, the splats and every fit. The Zernike basis, the
voxel selection, the strain analysis and the metadata stay on the host,
as in the reference. angular_sph_alignment and forward_zernike_images
take `--mesh dp`: each rank of the process group fits its own rows of
every batch (padded by repeating row 0), and the rows meet in one
all_gather a batch (parallel.engines.shard_batch / gather_batch).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import resolve_device
from xmipp3_tpu_torch.parallel.cli import (MeshProgram, add_mesh_params,
                                           read_mesh_params)


def _ctf_constants(row, Ts):
    """(K1, K2, Ksin, Kcos, Ts) of a row's microscope (the reference's
    inline computation)."""
    kV = float(row.get("ctfVoltage", 300.0))
    Cs = float(row.get("ctfSphericalAberration", 2.7))
    Q0 = float(row.get("ctfQ0", 0.07))
    lam_e = 12.2643247 / np.sqrt(kV * 1e3 * (1 + 0.978466e-6 * kV * 1e3))
    return (float(np.pi * lam_e), float(np.pi / 2 * Cs * 1e7 * lam_e ** 3),
            float(np.sqrt(max(1 - Q0 ** 2, 0.0))), float(Q0),
            float(max(Ts, 1e-6)))


def _sph_row(coeffs, deformation, image):
    return {"sphCoefficients": np.asarray(coeffs).ravel().astype(np.float64),
            "sphDeformation": deformation, "image": image}


class ProgVolumeDeformSph(XmippProgram):
    """Full reference surface (volume_deform_sph.cpp:37-49): --sigma
    multiresolution NCC, --regularization deformation penalty,
    --Rmax basis radius, --optimizeRadius (radius-candidate search: the
    Powell radius parameter recast as a grid), --analyzeStrain
    strain/rotation volumes."""
    name = "xmipp_volume_deform_sph"

    def defineParams(self):
        self.addUsageLine("Deform a volume onto a reference with a Zernike3D "
                          "displacement field.")
        self.addParamsLine("   -i <volume>  : Volume to deform")
        self.addParamsLine("   -r <volume>  : Target (reference) volume")
        self.addParamsLine("  [-o <out=deformed.vol>] : Deformed volume")
        self.addParamsLine("  [--sigma <...>] : Gaussian sigmas (px) for "
                           "multiresolution NCC (0 = unfiltered level)")
        self.addParamsLine("  [--analyzeStrain] : Write <oroot>_strain.vol "
                           "and <oroot>_rotation.vol from the displacement "
                           "jacobian")
        self.addParamsLine("  [--optimizeRadius] : Also search the basis "
                           "radius (candidates 0.8/0.9/1.0/1.1 x Rmax)")
        self.addParamsLine("  [--l1 <l1=3>]  : Zernike radial depth")
        self.addParamsLine("  [--l2 <l2=2>]  : Spherical harmonic depth")
        self.addParamsLine("  [--regularization <l=0.00025>] : Deformation "
                           "penalty lambda")
        self.addParamsLine("  [--Rmax <r=-1>] : Basis radius (px); -1 = "
                           "half the volume size")
        self.addParamsLine("  [--steps <n=100>] : Optimization steps")
        self.addParamsLine("  [--oroot <root=\"\">] : Root for extra "
                           "outputs (coefficients .xmd, strain volumes; "
                           "reference default 'Volumes')")

    def _write_extras(self, basis, coeffs):
        from xmipp3_tpu_torch.ops.zernike import strain_rotation_volumes
        root = self.getParam("--oroot")
        if root:
            MetaData.fromRows([_sph_row(coeffs, self.deformation,
                                        self.getParam("-i"))]
                              ).write(root + ".xmd")
        if self.checkParam("--analyzeStrain"):
            with timed_phase("strain"):
                strain, rotation = strain_rotation_volumes(basis, coeffs)
            save_image((root or "Volumes") + "_strain.vol", strain)
            save_image((root or "Volumes") + "_rotation.vol", rotation)

    def run(self):
        from xmipp3_tpu_torch.ops.zernike import (deformation_amplitude,
                                                  fit_deformation,
                                                  zernike_basis_grid)
        dev = resolve_device(self.getParam("--device"))
        vol = np.squeeze(Image(self.getParam("-i")).data).astype(np.float32)
        ref = np.squeeze(Image(self.getParam("-r")).data).astype(np.float32)
        L1 = self.getIntParam("--l1")
        L2 = self.getIntParam("--l2")
        lam = float(self.getDoubleParam("--regularization"))
        rmax = float(self.getIntParam("--Rmax"))
        if rmax <= 0:
            rmax = vol.shape[0] / 2 - 1
        sigmas = None
        if self.checkParam("--sigma"):
            toks = self.getListParam("--sigma")
            sigmas = [float(t) for t in toks if t != ""] or None
        steps = self.getIntParam("--steps")
        radii = [rmax]
        if self.checkParam("--optimizeRadius"):
            radii = [0.8 * rmax, 0.9 * rmax, rmax, 1.1 * rmax]
        best = None
        with timed_phase("fit"):
            for rad in radii:
                coeffs, deformed, ncc = fit_deformation(
                    vol, ref, L1, L2, n_steps=steps, radius=rad, lam=lam,
                    sigmas=sigmas, verbose=self.verbose, device=dev)
                if best is None or ncc > best[3]:
                    best = (coeffs, deformed, rad, ncc)
        coeffs, deformed, radius, ncc = best
        out = self.getParam("-o")
        save_image(out if out else self.getParam("-i"), deformed)
        self.ncc = ncc
        self.radius = radius
        basis = zernike_basis_grid(vol.shape[0], L1, L2, radius)
        self.deformation = deformation_amplitude(basis, coeffs)
        self.coeffs = coeffs
        if self.verbose:
            print(f"NCC after deformation: {ncc:.4f}  "
                  f"RMS deformation: {self.deformation:.3f} px  "
                  f"radius: {radius:.1f}")
        self._write_extras(basis, coeffs)


class ProgForwardZernikeVolume(ProgVolumeDeformSph):
    """forward_zernike_volume (forward_zernike_volume.cpp:120-135): the
    volume-to-volume fit through the FORWARD splat model: the input's
    masked voxel cloud is displaced and splat back into a volume
    (trilinear or --blobr KB blob, --step stride), optimized against the
    masked reference; --clnm seeds the coefficients."""
    name = "xmipp_forward_zernike_volume"

    def defineParams(self):
        super().defineParams()
        self.addParamsLine("  [--maski <m=\"\">] : Input volume mask "
                           "(voxel-cloud support)")
        self.addParamsLine("  [--maskr <m=\"\">] : Reference volume mask "
                           "(fit region)")
        self.addParamsLine("  [--blobr <b=-1>] : Splat blob radius; <=0 = "
                           "trilinear splat")
        self.addParamsLine("  [--step <step=1>] : Voxel index stride")
        self.addParamsLine("  [--clnm <metadata_file=\"\">] : Coefficients "
                           "seeding the optimization")

    def run(self):
        from xmipp3_tpu_torch.ops.forward_zernike import (
            blob_splat_profile_3d, fit_forward_zernike_subtomos_batch,
            forward_splat_volume, masked_voxel_basis)
        from xmipp3_tpu_torch.ops.zernike import zernike_basis_grid
        # the reference reads neither --sigma nor --optimizeRadius here
        # (ROADMAP.md section 3, item 21)
        self.refuse_unread("--sigma", "--optimizeRadius", item=21)
        dev = resolve_device(self.getParam("--device"))
        vol = np.squeeze(Image(self.getParam("-i")).data).astype(np.float32)
        ref = np.squeeze(Image(self.getParam("-r")).data).astype(np.float32)
        L1, L2 = self.getIntParam("--l1"), self.getIntParam("--l2")
        lam = float(self.getDoubleParam("--regularization"))
        rmax = float(self.getIntParam("--Rmax"))
        maski = None
        if self.checkParam("--maski") and self.getParam("--maski"):
            maski = np.squeeze(Image(self.getParam("--maski")).data)
        with timed_phase("basis"):
            positions, values, Z = masked_voxel_basis(
                vol, L1, L2, value_threshold=float(np.abs(vol).max()) * 1e-3,
                mask=maski, rmax=rmax if rmax > 0 else None,
                step=max(1, self.getIntParam("--step")))
        K = Z.shape[0]
        n = vol.shape[0]
        vol_mask = None
        if self.checkParam("--maskr") and self.getParam("--maskr"):
            vol_mask = (np.squeeze(Image(self.getParam("--maskr")).data)
                        > 0.5).astype(np.float32)
        blobr = float(self.getDoubleParam("--blobr"))
        blob_profile, n_taps = (None, 0)
        if blobr > 0:
            blob_profile, n_taps = blob_splat_profile_3d(blobr)
        c0 = np.zeros((1, 3, K), np.float32)
        if self.checkParam("--clnm") and self.getParam("--clnm"):
            cmd = MetaData(self.getParam("--clnm"))
            c0 = np.asarray(cmd.getValue("sphCoefficients",
                                         cmd.firstObject()),
                            np.float32).reshape(1, 3, K)
        z0 = np.zeros(1, np.float32)
        pos_t, val_t, Z_t = (torch.as_tensor(a, device=dev)
                             for a in (positions, values, Z))
        with timed_phase("fit"):
            c3, dp, cc, deform = fit_forward_zernike_subtomos_batch(
                pos_t, val_t, Z_t, ref[None], z0, z0, z0, c0, lam, n,
                int(self.getIntParam("--steps")), vol_mask=vol_mask,
                blob_profile=blob_profile, n_taps=n_taps, opt_align=False,
                opt_deform=True, device=dev)
            coeffs = c3[0]
            deformed, _ = forward_splat_volume(
                pos_t, val_t, Z_t, coeffs, 0.0, 0.0, 0.0, n,
                blob_profile=blob_profile, n_taps=n_taps)
        coeffs = coeffs.cpu().numpy()
        out = self.getParam("-o")
        save_image(out if out else self.getParam("-i"),
                   deformed.cpu().numpy())
        self.ncc = float(cc[0])
        self.deformation = float(deform[0])
        self.coeffs = coeffs
        if self.verbose:
            print(f"NCC after forward deformation: {self.ncc:.4f}  "
                  f"RMS deformation: {self.deformation:.3f} px")
        basis = zernike_basis_grid(n, L1, L2, rmax if rmax > 0 else None) \
            if self.checkParam("--analyzeStrain") else None
        self._write_extras(basis, coeffs)


class ProgVolumeApplyCoefficientZernike3D(XmippProgram):
    name = "xmipp_volume_apply_coefficient_zernike3d"

    def defineParams(self):
        self.addUsageLine("Apply stored Zernike3D coefficients to a volume.")
        self.addParamsLine("   -i <volume>  : Input volume")
        self.addParamsLine("   --clnm <md>  : Metadata with sphCoefficients")
        self.addParamsLine("  [-o <out=deformed.vol>] : Output")
        self.addParamsLine("  [--mask <m=\"\">] : Deformation support mask")
        self.addParamsLine("  [--step <step=1>] : Voxel index stride "
                           "(forward splat mode)")
        self.addParamsLine("  [--blobr <b=-1>] : Blob radius for forward "
                           "splat application; <=0 applies the backward "
                           "warp (TPU-native default path)")
        self.addParamsLine("  [--l1 <l1=3>]  : Zernike radial depth")
        self.addParamsLine("  [--l2 <l2=2>]  : Spherical harmonic depth")

    def run(self):
        from xmipp3_tpu_torch.ops.zernike import deform_volume, \
            zernike_basis_grid
        dev = resolve_device(self.getParam("--device"))
        vol = np.squeeze(Image(self.getParam("-i")).data).astype(np.float32)
        md = MetaData(self.getParam("--clnm"))
        flat = np.asarray(md.getValue("sphCoefficients", md.firstObject()),
                          np.float32)
        coeffs = flat.reshape(3, -1)
        mask = None
        if self.checkParam("--mask") and self.getParam("--mask"):
            mask = np.squeeze(Image(self.getParam("--mask")).data)
        blobr = (float(self.getDoubleParam("--blobr"))
                 if self.checkParam("--blobr") else -1.0)
        if blobr > 0:
            # forward splat application (the reference's forward mapping)
            from xmipp3_tpu_torch.ops.forward_zernike import (
                blob_splat_profile_3d, forward_splat_volume,
                masked_voxel_basis)
            positions, values, Z = masked_voxel_basis(
                vol, self.getIntParam("--l1"), self.getIntParam("--l2"),
                value_threshold=0.0, mask=mask,
                step=max(1, self.getIntParam("--step")))
            if Z.shape[0] != coeffs.shape[1]:
                raise XmippError(ErrCode.PARAM_INCORRECT,
                                 f"coefficient count {coeffs.shape[1]} != "
                                 f"basis size {Z.shape[0]} for l1/l2")
            prof, n_taps = blob_splat_profile_3d(blobr)
            out, _ = forward_splat_volume(positions, values, Z, coeffs, 0.0,
                                          0.0, 0.0, vol.shape[0],
                                          blob_profile=prof, n_taps=n_taps,
                                          device=dev)
            save_image(self.getParam("-o"), out.cpu().numpy())
            return
        basis = zernike_basis_grid(
            vol.shape[0], self.getIntParam("--l1"),
            self.getIntParam("--l2"))
        if mask is not None:
            basis = basis * (mask > 0.5).astype(np.float32)[None]
        if basis.shape[0] != coeffs.shape[1]:
            raise XmippError(ErrCode.PARAM_INCORRECT,
                             f"coefficient count {coeffs.shape[1]} != basis "
                             f"size {basis.shape[0]} for l1/l2")
        with timed_phase("warp"):
            out = deform_volume(vol, basis, coeffs, device=dev)
        save_image(self.getParam("-o"), out.cpu().numpy())


def _read_priors(path, B, K):
    """(B, 3, K) prior coefficients from a metadata: one row for every
    particle, or one global row."""
    pmd = MetaData(path)
    pc = [np.asarray(v, np.float32).reshape(3, -1)
          for v in pmd.getColumnValues("sphCoefficients")]
    priors = np.stack(pc * B)[:B] if len(pc) == 1 else np.stack(pc)[:B]
    if priors.shape[-1] != K:
        raise XmippError(ErrCode.VALUE_INCORRECT,
                         f"prior has {priors.shape[-1]} coefficients, "
                         f"basis has {K}")
    return priors


def _batch_on_ranks(mesh, arrays):
    """The batch's arrays as tensors: on the serial path whole, on a mesh
    padded by repeating row 0 and this rank's rows. Returns (tensors,
    padded row count)."""
    from xmipp3_tpu_torch.parallel.engines import (pad_repeat_first,
                                                   shard_batch)
    n = mesh.shape["data"]
    padded = [pad_repeat_first(a, n) for a in arrays]
    return [shard_batch(a, mesh) for a in padded], len(padded[0])


class ProgAngularSphAlignment(MeshProgram):
    """Full reference option surface (angular_sph_alignment.cpp:104-120):
    mask/RDef restrict+normalize the deformation basis, Rmax masks the 2-D
    correlation region, sampling+max_resolution low-pass the images, the
    --optimize* gates select the fitted parameter groups (pose/shift
    deltas clipped to max_angular_change / max_shift), per-particle
    defocus deltas ride the rows' CTF (applied when CTF columns exist;
    --phaseFlipped uses |CTF|), and --resume skips rows in the odir
    sphDone.xmd ledger.

    Each step warps the reference once for every particle of the batch
    (one batched gather of (B, 3, K) coefficients), takes the padded
    cubes' FFTs and one central slice each, and backpropagates through
    all of it; the reference's hand-written Adam (its g * nb_run scale,
    two learning-rate groups) updates on the card."""
    name = "xmipp_angular_sph_alignment"

    def defineParams(self):
        self.addUsageLine("Per-particle flexible alignment: fit Zernike3D "
                          "coefficients (+ pose refinement) against particle "
                          "images through the differentiable projector.")
        self.addParamsLine("   -i <md_file> : Particles with poses")
        self.addParamsLine("   --ref <volume> : Reference volume")
        self.addParamsLine("   -o <md_file> : Output with sphCoefficients")
        self.addParamsLine("  [--mask <m=\"\">] : Reference volume mask "
                           "(deformation support)")
        self.addParamsLine("  [--odir <outputDir=\".\">] : Output directory")
        self.addParamsLine("  [--max_shift <s=-1>] : Maximum shift delta "
                           "(px); -1 = 20% of the image size")
        self.addParamsLine("  [--max_angular_change <a=5>] : Maximum "
                           "angular delta (deg)")
        self.addParamsLine("  [--max_resolution <f=4>] : Low-pass the "
                           "images to this resolution (A); <=0 disables")
        self.addParamsLine("  [--sampling <Ts=1>] : Pixel size (A)")
        self.addParamsLine("  [--Rmax <R=-1>] : Correlation mask radius "
                           "(px); -1 = half the image size")
        self.addParamsLine("  [--RDef <r=-1>] : Deformation sphere radius "
                           "(px); -1 = half the volume size")
        self.addParamsLine("  [--l1 <l1=3>]  : Zernike radial depth")
        self.addParamsLine("  [--l2 <l2=2>]  : Spherical harmonic depth")
        self.addParamsLine("  [--optimizeAlignment] : Optimize pose deltas")
        self.addParamsLine("  [--optimizeDeformation] : Optimize Zernike3D "
                           "coefficients")
        self.addParamsLine("  [--optimizeDefocus] : Optimize per-particle "
                           "defocus deltas")
        self.addParamsLine("  [--phaseFlipped] : Input images have been "
                           "phase flipped (use |CTF|)")
        self.addParamsLine("  [--regularization <l=0.01>] : Deformation "
                           "penalty lambda")
        self.addParamsLine("  [--resume] : Resume from the odir "
                           "sphDone.xmd ledger")
        self.addParamsLine("  [--steps <n=40>] : Optimization steps per batch")
        self.addParamsLine("  [--batch <b=16>] : Particles per batch")
        self.addParamsLine("  [--priors <md=\"\">] : Metadata with prior "
                           "sphCoefficients (per-row, or one global row) used "
                           "to initialize the per-particle coefficients "
                           "(forward_zernike_images_priors contract)")
        add_mesh_params(self)

    def readParams(self):
        self.device_arg = self.getParam("--device")
        read_mesh_params(self)

    def _run(self, mesh):
        from xmipp3_tpu_torch.core.metadata_program import load_image_rows
        from xmipp3_tpu_torch.ops.continuous import _euler_t
        from xmipp3_tpu_torch.ops.forward_zernike import (NO_CTF, _clip,
                                                          _ctf_spec)
        from xmipp3_tpu_torch.ops.fourier_filter import (
            apply_fourier_mask_2d, low_pass_mask)
        from xmipp3_tpu_torch.ops.project import (extract_central_slices,
                                                  prepare_fourier_volume,
                                                  slices_to_projections)
        from xmipp3_tpu_torch.ops.zernike import (displacement,
                                                  warp_trilinear,
                                                  zernike_basis_grid)
        from xmipp3_tpu_torch.parallel.engines import gather_batch
        dev = self.device
        odir = self.getParam("--odir")
        out_fn = self.getParam("-o")
        if odir and odir != "." and not os.path.isabs(out_fn):
            os.makedirs(odir, exist_ok=True)
            out_fn = os.path.join(odir, out_fn)
        md = MetaData(self.getParam("-i"))
        md.removeDisabled()
        rows = list(md.iterRows())
        done_fn = os.path.join(odir, "sphDone.xmd")
        done_rows = []
        if self.checkParam("--resume") and os.path.exists(done_fn):
            done_rows = list(MetaData(done_fn).iterRows())
            done = {str(r.get("image", "")) for r in done_rows}
            rows = [r for r in rows if str(r.get("image", "")) not in done]
        if not rows:
            if self.writer:
                MetaData.fromRows(done_rows).write(out_fn)
            return
        imgs = load_image_rows(rows)
        vol = np.squeeze(Image(self.getParam("--ref")).data).astype(
            np.float32)
        D = vol.shape[0]
        L1, L2 = self.getIntParam("--l1"), self.getIntParam("--l2")
        rdef = float(self.getIntParam("--RDef"))
        with timed_phase("basis"):
            basis = zernike_basis_grid(D, L1, L2,
                                       radius=rdef if rdef > 0 else None)
            if self.checkParam("--mask") and self.getParam("--mask"):
                mvol = np.squeeze(Image(self.getParam("--mask")).data)
                basis = basis * (mvol > 0.5).astype(np.float32)[None]
            basis = torch.as_tensor(basis, device=dev)
        K = basis.shape[0]
        get = lambda k, d=0.0: np.array([float(r.get(k, d)) for r in rows],
                                        np.float32)
        rot, tilt, psi = get("angleRot"), get("angleTilt"), get("anglePsi")
        sx0, sy0 = get("shiftX"), get("shiftY")
        N = imgs.shape[-1]
        Ts = float(self.getDoubleParam("--sampling"))
        max_res = float(self.getDoubleParam("--max_resolution"))
        if max_res > 0:
            lp = low_pass_mask(N, N, min(0.5, Ts / max_res), raised_w=0.02)
            imgs = apply_fourier_mask_2d(imgs, lp, device=dev).cpu().numpy()
        rmax2d = float(self.getIntParam("--Rmax"))
        if rmax2d <= 0:
            rmax2d = N / 2
        yy, xx = np.mgrid[0:N, 0:N].astype(np.float32) - N // 2
        w2d = torch.as_tensor((yy * yy + xx * xx <= rmax2d * rmax2d)
                              .astype(np.float32), device=dev)
        lam = float(self.getDoubleParam("--regularization"))
        opt_align = self.checkParam("--optimizeAlignment")
        opt_deform = self.checkParam("--optimizeDeformation")
        opt_defocus = self.checkParam("--optimizeDefocus")
        if not (opt_align or opt_deform or opt_defocus):
            opt_deform = True
        phase_flipped = self.checkParam("--phaseFlipped")
        use_ctf = "ctfDefocusU" in md.df.columns
        if use_ctf:
            ctf_consts = _ctf_constants(rows[0], Ts)
            defU, defV = get("ctfDefocusU"), get("ctfDefocusV")
            defA = get("ctfDefocusAngle")
        else:
            ctf_consts = NO_CTF
            defU = defV = defA = np.zeros(len(rows), np.float32)
        max_ang = float(self.getDoubleParam("--max_angular_change"))
        max_shift = float(self.getDoubleParam("--max_shift"))
        if max_shift < 0:
            max_shift = 0.2 * N
        lr_a = 0.5 if opt_align else 0.0
        lr_d = 30.0 if (opt_defocus and use_ctf) else 0.0
        lr_pose = torch.tensor([lr_a] * 5 + [lr_d, lr_d, 0.1 * lr_d],
                               dtype=torch.float32, device=dev)
        lr_c = 0.05 if opt_deform else 0.0
        vol_t = torch.as_tensor(vol, device=dev)
        fy = torch.fft.fftfreq(N, device=dev)[:, None]
        fx = torch.fft.rfftfreq(N, device=dev)[None, :]
        ws = torch.maximum(w2d.sum(), torch.tensor(1e-20, device=dev))

        def losses_of(coeffs, dp, img, rot_b, tilt_b, psi_b, sx_b, sy_b,
                      dU, dV, dA):
            """Each particle's loss (B,): -cc + lam sqrt(mean |g|^2)."""
            d = displacement(basis, coeffs)
            vf, _ = prepare_fourier_volume(warp_trilinear(vol_t, d), 2.0)
            clip_a = lambda a: _clip(a, -max_ang, max_ang)
            mats = _euler_t(rot_b + clip_a(dp[:, 0]),
                            tilt_b + clip_a(dp[:, 1]),
                            psi_b + clip_a(dp[:, 2]))
            proj = slices_to_projections(
                extract_central_slices(vf, mats, N), N)
            sx = sx_b + _clip(dp[:, 3], -max_shift, max_shift)
            sy = sy_b + _clip(dp[:, 4], -max_shift, max_shift)
            e = lambda a: a[:, None, None]
            spec = torch.fft.rfft2(proj) * torch.exp(
                -2j * torch.pi * (fy * e(sy) + fx * e(sx)))
            if use_ctf:
                spec = spec * _ctf_spec(N, dU + dp[:, 5], dV + dp[:, 6],
                                        dA + dp[:, 7], ctf_consts,
                                        phase_flipped)
            proj = torch.fft.irfft2(spec, s=(N, N))
            pm = proj - e((proj * w2d).sum(dim=(1, 2)) / ws)
            im = img - e((img * w2d).sum(dim=(1, 2)) / ws)
            cc = (w2d * pm * im).sum(dim=(1, 2)) / torch.sqrt(
                (w2d * pm * pm).sum(dim=(1, 2))
                * (w2d * im * im).sum(dim=(1, 2))).clamp(min=1e-12)
            g2 = (d ** 2).sum(1).mean(dim=(1, 2, 3))
            return -cc + lam * torch.sqrt(g2 + 1e-12)

        B = len(rows)
        bs = self.getIntParam("--batch")
        n_steps = self.getIntParam("--steps")
        out_rows = []
        priors = None
        if self.checkParam("--priors") and self.getParam("--priors"):
            priors = _read_priors(self.getParam("--priors"), B, K)
        for s in range(0, B, bs):
            sl = slice(s, min(s + bs, B))
            nb = sl.stop - sl.start
            coeffs = (np.zeros((nb, 3, K), np.float32) if priors is None
                      else priors[sl])
            args = [coeffs, imgs[sl], rot[sl], tilt[sl], psi[sl], sx0[sl],
                    sy0[sl], defU[sl], defV[sl], defA[sl]]
            if mesh is not None:
                # per-particle DP (the reference's
                # mpi_angular_sph_alignment particle distribution): every
                # loss is per particle, so each rank fits its own rows
                args, nb_run = _batch_on_ranks(mesh, args)
            else:
                args = [torch.as_tensor(np.asarray(a, np.float32),
                                        device=dev) for a in args]
                nb_run = nb
            coeffs, args = args[0], args[1:]
            params = [coeffs, torch.zeros((len(coeffs), 8), device=dev)]
            m = [torch.zeros_like(p) for p in params]
            v = [torch.zeros_like(p) for p in params]
            lrs = (lr_c, lr_pose[None, :])
            losses = None
            with timed_phase("fit"):
                for step in range(n_steps):
                    ps = [p.requires_grad_(True) for p in params]
                    with torch.enable_grad():
                        losses = losses_of(*ps, *args)
                        # the reference's mean over the (padded) batch,
                        # its gradient scaled back by nb_run
                        g = torch.autograd.grad(losses.sum() / nb_run, ps)
                    params = [p.detach() for p in ps]
                    losses = losses.detach()
                    t = step + 1
                    for k in range(2):
                        gk = g[k] * nb_run
                        m[k] = 0.9 * m[k] + 0.1 * gk
                        v[k] = 0.999 * v[k] + 0.001 * gk * gk
                        params[k] = params[k] - lrs[k] * (
                            m[k] / (1 - 0.9 ** t)) / (
                            torch.sqrt(v[k] / (1 - 0.999 ** t)) + 1e-8)
                coeffs, dpose = params
                if mesh is not None:
                    coeffs, dpose, losses = (
                        gather_batch(a, mesh, nb)
                        for a in (coeffs, dpose, losses))
            cc = -losses.cpu().numpy()[:nb]
            cf = coeffs.cpu().numpy()[:nb]
            dp = dpose.cpu().numpy()[:nb]
            for i in range(nb):
                d = dict(rows[s + i])
                d["sphCoefficients"] = cf[i].ravel().astype(np.float64)
                d["sphDeformation"] = float(np.abs(cf[i]).mean())
                d["maxCC"] = float(cc[i])
                if opt_align:
                    clip = lambda a, lim: float(np.clip(a, -lim, lim))
                    d["angleRot"] = float(rot[s + i] + clip(dp[i, 0],
                                                            max_ang))
                    d["angleTilt"] = float(tilt[s + i] + clip(dp[i, 1],
                                                              max_ang))
                    d["anglePsi"] = float(psi[s + i] + clip(dp[i, 2],
                                                            max_ang))
                    d["shiftX"] = float(sx0[s + i] + clip(dp[i, 3],
                                                          max_shift))
                    d["shiftY"] = float(sy0[s + i] + clip(dp[i, 4],
                                                          max_shift))
                if opt_defocus and use_ctf:
                    d["ctfDefocusU"] = float(defU[s + i] + dp[i, 5])
                    d["ctfDefocusV"] = float(defV[s + i] + dp[i, 6])
                out_rows.append(d)
            if self.verbose:
                print(f"  sph batch {s // bs + 1}: mean CC {cc.mean():.4f}")
            if self.checkParam("--resume") and self.writer:
                os.makedirs(odir or ".", exist_ok=True)
                MetaData.fromRows(done_rows + out_rows).write(done_fn)
        if self.writer:
            MetaData.fromRows(done_rows + out_rows).write(out_fn)
        self.rows = done_rows + out_rows


class ProgForwardZernikeImages(MeshProgram):
    """The forward-model Zernike3D engine (reference
    forward_zernike_images.{h,cpp}): each particle is fit by splatting the
    deformed masked voxel cloud directly into its projection plane
    (deformVol, forward_zernike_images.cpp:1047-1145) with simultaneous
    pose-delta refinement and deformation regularization, not the
    deform-volume-then-project scheme of angular_sph_alignment."""
    name = "xmipp_forward_zernike_images"

    def defineParams(self):
        self.addUsageLine("Per-particle flexible refinement with the "
                          "forward splatting model.")
        self.addParamsLine("   -i <md_file> : Particles with poses")
        self.addParamsLine("   --ref <volume> : Reference volume")
        self.addParamsLine("   -o <md_file> : Output metadata")
        self.addParamsLine("  [--mask <m=\"\">] : Mask volume selecting the "
                           "voxels to deform (default: sphere of radius "
                           "--RDef)")
        self.addParamsLine("  [--odir <outputDir=\".\">] : Output directory "
                           "(relative outputs + the resume ledger live here)")
        self.addParamsLine("  [--l1 <l1=3>] : Zernike radial depth")
        self.addParamsLine("  [--l2 <l2=2>] : Spherical harmonic depth")
        self.addParamsLine("  [--max_shift <s=-1>] : Maximum shift delta "
                           "(px); -1 = 20% of the image size")
        self.addParamsLine("  [--max_angular_change <a=5>] : Maximum angular delta (deg)")
        self.addParamsLine("  [--max_resolution <f=4>] : Low-pass the "
                           "images to this resolution (A) before fitting")
        self.addParamsLine("  [--sampling <Ts=1>] : Pixel size (A)")
        self.addParamsLine("  [--Rmax <R=-1>] : Correlation mask radius "
                           "(px); -1 = half the image size")
        self.addParamsLine("  [--RDef <r=-1>] : Deformation sphere radius "
                           "(px); -1 = half the volume size")
        self.addParamsLine("  [--step <step=1>] : Voxel index stride of the "
                           "splatted cloud")
        self.addParamsLine("  [--useCTF] : Apply the rows' CTF to the "
                           "forward projection")
        self.addParamsLine("  [--phaseFlipped] : Input images have been "
                           "phase flipped (use |CTF|)")
        self.addParamsLine("  [--optimizeAlignment] : Optimize pose deltas")
        self.addParamsLine("  [--optimizeDeformation] : Optimize Zernike3D "
                           "coefficients")
        self.addParamsLine("  [--optimizeDefocus] : Optimize per-particle "
                           "defocus deltas (with --useCTF)")
        self.addParamsLine("  [--regularization <l=0.01>] : Deformation penalty lambda")
        self.addParamsLine("  [--blobr <b=-1>] : Splatting blob radius "
                           "(KB blob, order 2, alpha 7.05); <=0 selects the "
                           "differentiable bilinear splat (TPU-native "
                           "default path of this engine)")
        self.addParamsLine("  [--image_mode <im=-1>] : 1=single, 2=pairs, "
                           "3=triplets; -1 auto-detects from the image1/"
                           "image2 columns")
        self.addParamsLine("  [--resume] : Resume from this output's "
                           "sphDone.xmd ledger")
        self.addParamsLine("  [--steps <n=60>] : Optimization steps")
        self.addParamsLine("  [--batch <b=16>] : Particles per device batch")
        self.addParamsLine("  [--priors <md=\"\">] : Metadata whose sphCoefficients initialize the fit (the _priors program contract)")
        add_mesh_params(self)

    def readParams(self):
        self.device_arg = self.getParam("--device")
        read_mesh_params(self)

    def _priors_for(self, B, K):
        if not (self.checkParam("--priors") and self.getParam("--priors")):
            return None
        return _read_priors(self.getParam("--priors"), B, K)

    # per-image metadata label suffixes for the pairs/triplets mode
    # (reference forward_zernike_images.cpp:653-705: image/angleRot...,
    # image1/angleRot2..., image2/angleRot3...)
    _IMG_LABELS = [("image", ""), ("image1", "2"), ("image2", "3")]

    def _num_images(self, md) -> int:
        im = self.getIntParam("--image_mode")
        if im > 0:
            return min(im, 3)
        has1 = "image1" in md.df.columns
        has2 = "image2" in md.df.columns
        return 3 if (has1 and has2) else (2 if has1 else 1)

    def _out_path(self, odir: str) -> str:
        out = self.getParam("-o")
        if odir and odir != "." and not os.path.isabs(out):
            os.makedirs(odir, exist_ok=True)
            return os.path.join(odir, out)
        return out

    def _run(self, mesh):
        from xmipp3_tpu_torch.core.metadata_program import load_image_rows
        from xmipp3_tpu_torch.ops.forward_zernike import (
            blob_splat_profile, fit_forward_zernike_batch,
            masked_voxel_basis)
        from xmipp3_tpu_torch.ops.fourier_filter import (
            apply_fourier_mask_2d, low_pass_mask)
        from xmipp3_tpu_torch.parallel.engines import gather_batch
        dev = self.device
        odir = self.getParam("--odir")
        md = MetaData(self.getParam("-i"))
        md.removeDisabled()
        rows = list(md.iterRows())
        M = self._num_images(md)
        vol = np.squeeze(Image(self.getParam("--ref")).data).astype(
            np.float32)
        L1 = self.getIntParam("--l1")
        L2 = self.getIntParam("--l2")
        lam = float(self.getDoubleParam("--regularization"))
        mask = None
        if self.checkParam("--mask") and self.getParam("--mask"):
            mask = np.squeeze(Image(self.getParam("--mask")).data)
        rdef = float(self.getIntParam("--RDef"))
        with timed_phase("basis"):
            positions, values, Z = masked_voxel_basis(
                vol, L1, L2,
                value_threshold=float(np.abs(vol).max()) * 1e-3,
                mask=mask, rmax=rdef if rdef > 0 else None,
                step=max(1, self.getIntParam("--step")))
        K = Z.shape[0]

        # resume ledger (reference Rerunable fnOutDir + "/sphDone.xmd")
        done_fn = os.path.join(odir, "sphDone.xmd")
        done_rows = []
        if self.checkParam("--resume") and os.path.exists(done_fn):
            done_rows = list(MetaData(done_fn).iterRows())
            done_names = {str(r.get("image", "")) for r in done_rows}
            rows = [r for r in rows
                    if str(r.get("image", "")) not in done_names]
        self._rows = rows
        if not rows:
            if self.writer:
                MetaData.fromRows(done_rows).write(self._out_path(odir))
            self.mean_corr = float(np.mean(
                [r.get("maxCC", 0.0) for r in done_rows])) if done_rows \
                else 0.0
            return

        # (B, M, H, W) images + per-image poses/shifts
        imgs_m, rot, tilt, psi, sx, sy = [], [], [], [], [], []
        for m in range(M):
            label, suf = self._IMG_LABELS[m]
            sub = [dict(r, image=r.get(label, r.get("image")))
                   for r in rows]
            imgs_m.append(load_image_rows(sub))
            g = lambda k, d=0.0: np.array(
                [float(r.get(k + suf, d)) for r in rows], np.float32)
            rot.append(g("angleRot"))
            tilt.append(g("angleTilt"))
            psi.append(g("anglePsi"))
            sx.append(g("shiftX"))
            sy.append(g("shiftY"))
        imgs = np.stack(imgs_m, axis=1)
        rot, tilt, psi = (np.stack(rot, 1), np.stack(tilt, 1),
                          np.stack(psi, 1))
        sx, sy = np.stack(sx, 1), np.stack(sy, 1)
        size = imgs.shape[-1]

        Ts = float(self.getDoubleParam("--sampling"))
        max_res = float(self.getDoubleParam("--max_resolution"))
        if max_res > 0:
            # reference low-pass at w1 = Ts/maxResol before fitting
            # (forward_zernike_images.cpp:249-251)
            lp = low_pass_mask(size, size, min(0.5, Ts / max_res),
                               raised_w=0.02)
            imgs = apply_fourier_mask_2d(
                imgs.reshape(-1, size, size), lp,
                device=dev).cpu().numpy().reshape(imgs.shape)

        rmax2d = float(self.getIntParam("--Rmax"))
        if rmax2d <= 0:
            rmax2d = size / 2
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) - size // 2
        img_mask = (yy * yy + xx * xx <= rmax2d * rmax2d).astype(np.float32)

        blobr = float(self.getDoubleParam("--blobr"))
        blob_profile, n_taps = (None, 0)
        if blobr > 0:
            blob_profile, n_taps = blob_splat_profile(blobr)

        use_ctf = self.checkParam("--useCTF")
        phase_flipped = self.checkParam("--phaseFlipped")
        opt_align = self.checkParam("--optimizeAlignment")
        opt_deform = self.checkParam("--optimizeDeformation")
        opt_defocus = self.checkParam("--optimizeDefocus")
        if not (opt_align or opt_deform or opt_defocus):
            # bare invocation: evaluate AND refine the deformation
            opt_deform = True
        ctf_consts = (0.0, 0.0, 1.0, 0.0, max(Ts, 1e-6))
        defU = defV = defAng = None
        if use_ctf:
            ctf_consts = _ctf_constants(rows[0], Ts)
            gc = lambda k: np.array([[float(r.get(k, 0.0))] * M
                                     for r in rows], np.float32)
            defU, defV, defAng = (gc("ctfDefocusU"), gc("ctfDefocusV"),
                                  gc("ctfDefocusAngle"))

        max_shift = float(self.getDoubleParam("--max_shift"))
        if max_shift < 0:
            max_shift = 0.2 * size
        B = len(rows)
        bs = self.getIntParam("--batch")
        priors = self._priors_for(B, K)
        cloud = [torch.as_tensor(a, device=dev)
                 for a in (positions, values, Z)]
        out_rows = []
        for s in range(0, B, bs):
            sl = slice(s, min(s + bs, B))
            nb = sl.stop - sl.start
            c0 = (np.zeros((nb, 3, K), np.float32) if priors is None
                  else np.asarray(priors[sl], np.float32))
            batch = [imgs[sl], rot[sl], tilt[sl], psi[sl], c0, sx[sl],
                     sy[sl]] + ([] if defU is None else
                                [defU[sl], defV[sl], defAng[sl]])
            if mesh is not None:
                # per-particle DP (mpi_forward_zernike_images analog)
                batch, _ = _batch_on_ranks(mesh, batch)
            else:
                batch = [torch.as_tensor(np.asarray(a, np.float32),
                                         device=dev) for a in batch]
            ctf_b = batch[7:] if defU is not None else [None] * 3
            with timed_phase("fit"):
                c3, dpose, corr, deform = fit_forward_zernike_batch(
                    *cloud, *batch[:5], lam, size,
                    int(self.getIntParam("--steps")),
                    max_angular=float(
                        self.getDoubleParam("--max_angular_change")),
                    max_shift=max_shift, shifts_x=batch[5],
                    shifts_y=batch[6], blob_profile=blob_profile,
                    n_taps=n_taps, use_ctf=use_ctf,
                    phase_flipped=phase_flipped, defU=ctf_b[0],
                    defV=ctf_b[1], defAng=ctf_b[2], ctf_consts=ctf_consts,
                    opt_align=opt_align, opt_deform=opt_deform,
                    opt_defocus=opt_defocus, img_mask=img_mask)
                if mesh is not None:
                    c3, dpose, corr, deform = (
                        gather_batch(a, mesh, nb)
                        for a in (c3, dpose, corr, deform))
            c3, dpose, corr, deform = (a.cpu().numpy()[:nb] for a in
                                       (c3, dpose, corr, deform))
            if dpose.ndim == 2:          # single-image mode: (nb, 8)
                dpose = dpose[:, None]
                corr = corr[:, None]
            for k in range(nb):
                r = dict(rows[sl.start + k])
                for m in range(M):
                    suf = self._IMG_LABELS[m][1]
                    i = sl.start + k
                    r["angleRot" + suf] = float(rot[i, m] + dpose[k, m, 0])
                    r["angleTilt" + suf] = float(tilt[i, m]
                                                 + dpose[k, m, 1])
                    r["anglePsi" + suf] = float(psi[i, m] + dpose[k, m, 2])
                    r["shiftX" + suf] = float(sx[i, m] + dpose[k, m, 3])
                    r["shiftY" + suf] = float(sy[i, m] + dpose[k, m, 4])
                    if use_ctf and opt_defocus:
                        r["ctfDefocusU"] = float(defU[i, m]
                                                 + dpose[k, m, 5])
                        r["ctfDefocusV"] = float(defV[i, m]
                                                 + dpose[k, m, 6])
                r["sphCoefficients"] = c3[k].reshape(-1)
                r["sphDeformation"] = float(deform[k])
                r["maxCC"] = float(corr[k].mean())
                out_rows.append(r)
            if self.checkParam("--resume") and self.writer:
                os.makedirs(odir or ".", exist_ok=True)
                MetaData.fromRows(done_rows + out_rows).write(done_fn)
        all_rows = done_rows + out_rows
        if self.writer:
            MetaData.fromRows(all_rows).write(self._out_path(odir))
        self.rows = all_rows
        self.mean_corr = float(np.mean([r["maxCC"] for r in all_rows]))
        if self.verbose:
            print(f"  mean corr {self.mean_corr:.4f}")


class ProgForwardZernikeImagesPriors(ProgForwardZernikeImages):
    """forward_zernike_images_priors: the forward engine initialized from
    prior coefficients (reference forward_zernike_images_priors.h: same
    model, priors seed the optimization). Priors come from --priors or,
    failing that, from the input rows' own sphCoefficients column."""
    name = "xmipp_forward_zernike_images_priors"

    def _priors_for(self, B, K):
        explicit = super()._priors_for(B, K)
        if explicit is not None:
            return explicit
        rows = getattr(self, "_rows", [])
        if rows and "sphCoefficients" in rows[0]:
            pc = [np.asarray(r["sphCoefficients"],
                             np.float32).reshape(3, -1) for r in rows]
            priors = np.stack(pc)
            if priors.shape[-1] == K:
                return priors
        return None
