"""Phantom programs: create, project, simulate_microscope.

Contracts: the reference package's programs/phantom_programs.py (reference
phantom_create, project (project.h:45) and phantom_simulate_microscope).
Volumes are voxelized, projected and filtered on the card (--device; the
card by default). The random angles of --nangles and the noise of
phantom_simulate_microscope are drawn on the host from numpy Generators
exactly as the reference draws them, so that a --seed run equals the
reference's; the noise then goes to the card.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import resolve_device
from xmipp3_tpu_torch.ops.phantom import Phantom


class ProgPhantomCreate(XmippProgram):
    name = "xmipp_phantom_create"

    def defineParams(self):
        self.addUsageLine("Create a voxel volume from a mathematical phantom "
                          "description file.")
        self.addParamsLine("   -i <description_file> : Phantom description (.descr)")
        self.addParamsLine("   -o <output_volume>    : Output volume")

    def run(self):
        dev = resolve_device(self.getParam("--device"))
        ph = Phantom.read(self.getParam("-i"))
        save_image(self.getParam("-o"), ph.voxelize(dev).cpu().numpy())


class ProgPhantomProject(XmippProgram):
    name = "xmipp_phantom_project"

    # views a Fourier projection pass takes at a time
    batch = 256

    def defineParams(self):
        self.addUsageLine("Generate projections from a volume, phantom "
                          "description or PDB (reference project.cpp "
                          "defineParams).")
        self.addParamsLine("   -i <volume_or_descr>  : Input volume, .descr phantom or PDB")
        self.addParamsLine("   -o <output>           : Output projection (single) or stack rootname")
        self.addParamsLine("  [--sampling_rate <Ts=1>] : Pixel size; only used for PDB phantoms")
        self.addParamsLine("  [--high_sampling_rate <highTs=0.08333333>] : Rasterization sampling before downscaling; only used for PDB phantoms")
        self.addParamsLine("  [--angles <rot=0> <tilt=0> <psi=0> <x=0.> <y=0.>] : Angles and shifts for a single projection")
        self.addParamsLine("  [--params <file>]      : Projection parameter file (metadata with angles)")
        self.addParamsLine("  [--sym <sym_file=\"\">]  : Symmetry; angle generation is restricted to the asymmetric unit")
        self.addParamsLine("  [--only_create_angles] : Do not create projections (write only the angle metadata)")
        self.addParamsLine("  [--xdim <size=-1>]     : Size of the projection (needed for PDB inputs)")
        self.addParamsLine("  [--nangles <n=0>]      : Generate n random projections")
        self.addParamsLine("  [--seed <s=0>]         : Random seed")
        self.addParamsLine("  [--method <m=fourier>] : fourier | real_space")

    def _volume(self, fn_in, dev):
        xdim = self.getIntParam("--xdim") if self.checkParam("--xdim") \
            else -1
        if fn_in.endswith(".descr"):
            return Phantom.read(fn_in).voxelize(dev)
        if fn_in.endswith((".pdb", ".cif", ".ent")):
            from xmipp3_tpu_torch.core.pdb import rasterize_modes, read_pdb
            model = read_pdb(fn_in)
            Ts = self.getDoubleParam("--sampling_rate")
            highTs = self.getDoubleParam("--high_sampling_rate")
            if xdim <= 0:
                ext = (np.abs(model.coords
                              - model.coords.mean(axis=0)).max() / Ts)
                xdim = int(2 * np.ceil(ext) + 8)
            model = model.centered()
            return torch.as_tensor(rasterize_modes(
                model, (xdim, xdim, xdim), Ts,
                high_sampling=min(highTs, Ts), device=dev), device=dev)
        return torch.as_tensor(
            np.squeeze(Image(fn_in).data).astype(np.float32), device=dev)

    def _angles(self):
        if self.checkParam("--params"):
            md = MetaData(self.getParam("--params"))
            rot = md.getColumn("angleRot").astype(np.float32)
            tilt = md.getColumn("angleTilt").astype(np.float32)
            psi = md.getColumn("anglePsi", 0.0).astype(np.float32) if \
                md.containsLabel("anglePsi") else np.zeros(len(md),
                                                           np.float32)
        elif self.checkParam("--nangles") and \
                self.getIntParam("--nangles") > 0:
            n = self.getIntParam("--nangles")
            rng = np.random.default_rng(self.getIntParam("--seed"))
            rot = rng.uniform(-180, 180, n).astype(np.float32)
            tilt = np.degrees(np.arccos(rng.uniform(-1, 1, n))
                              ).astype(np.float32)
            psi = rng.uniform(-180, 180, n).astype(np.float32)
            if self.checkParam("--sym") and self.getParam("--sym"):
                # restrict generated angles to the asymmetric unit
                # (project.cpp --sym: computes the asymmetric unit)
                from xmipp3_tpu_torch.core.geometry import euler_matrix
                from xmipp3_tpu_torch.core.sampling import (
                    remove_redundant_points_reference)
                A = np.asarray(euler_matrix(rot, tilt, psi))
                ang, _ = remove_redundant_points_reference(
                    np.stack([rot, tilt], axis=1), A[:, 2, :],
                    self.getParam("--sym"))
                keep = np.isin(rot, ang[:, 0])
                rot, tilt, psi = rot[keep], tilt[keep], psi[keep]
        else:
            rot = np.float32([self.getDoubleParam("--angles", 0)])
            tilt = np.float32([self.getDoubleParam("--angles", 1)])
            psi = np.float32([self.getDoubleParam("--angles", 2)])
        return rot, tilt, psi

    def run(self):
        from xmipp3_tpu_torch.ops.project import (FourierProjector,
                                                  project_real_space)
        dev = resolve_device(self.getParam("--device"))
        fn_in = self.getParam("-i")
        fn_out = self.getParam("-o")
        rot, tilt, psi = self._angles()
        if self.checkParam("--only_create_angles"):
            root = fn_out[:-4] if fn_out.endswith((".stk", ".xmd")) \
                else fn_out
            MetaData.fromRows([
                {"angleRot": float(rot[i]), "angleTilt": float(tilt[i]),
                 "anglePsi": float(psi[i]), "itemId": i + 1}
                for i in range(len(rot))]).write(root + ".xmd")
            return
        with timed_phase("volume"):
            vol = self._volume(fn_in, dev)
        with timed_phase("project", sync=vol):
            if self.getParam("--method") == "real_space":
                imgs = project_real_space(vol, rot, tilt, psi)
            else:
                proj = FourierProjector(vol.cpu().numpy(), device=dev)
                b = self.batch
                imgs = torch.cat([proj.project_euler(
                    rot[s:s + b], tilt[s:s + b], psi[s:s + b])
                    for s in range(0, len(rot), b)])
        single = len(imgs) == 1 and not self.checkParam("--params") and \
            not self.checkParam("--nangles")
        if single and self.checkParam("--angles"):
            sx = self.getDoubleParam("--angles", 3)
            sy = self.getDoubleParam("--angles", 4)
            if sx != 0.0 or sy != 0.0:
                from xmipp3_tpu_torch.ops.geo import shift_2d_real
                imgs = shift_2d_real(imgs, np.float32([sx]),
                                     np.float32([sy]))
        with timed_phase("write"):
            imgs = imgs.cpu().numpy()
            if single:
                save_image(fn_out, imgs[0])
                return
            root = fn_out[:-4] if fn_out.endswith((".stk", ".xmd")) \
                else fn_out
            fn_stk = root + ".stk"
            save_image(fn_stk, imgs)
            MetaData.fromRows([
                {"image": f"{i + 1:06d}@{fn_stk}", "angleRot": float(rot[i]),
                 "angleTilt": float(tilt[i]), "anglePsi": float(psi[i]),
                 "itemId": i + 1} for i in range(len(imgs))
            ]).write(root + ".xmd")


class ProgPhantomSimulateMicroscope(XmippProgram):
    """Full reference surface (phantom_simulate_microscope.cpp:55-340):
    --noise sigma split between a pre-CTF and a post-CTF component by
    the mask-power balance when --after_ctf_noise is on (the post
    component is filtered by the CTF's background noise model),
    --defocus_change random per-image defocus perturbation (percent),
    --downsampling rescaling the CTF sampling rate. The CTFs of a
    --defocus_change run are applied in one pass, one per image."""
    name = "xmipp_phantom_simulate_microscope"

    def defineParams(self):
        self.addUsageLine("Simulate the microscope: apply CTF and noise to "
                          "ideal projections.")
        self.addParamsLine("   -i <stack_or_md>  : Input projections")
        self.addParamsLine("   -o <stack>        : Output images")
        self.addParamsLine("  [--ctf <ctfparam=\"\">] : CTF description file")
        self.addParamsLine("  [--noise <stddev=0>]  : Gaussian noise sigma (after CTF)")
        self.addParamsLine("  [--noise_before <stddev=0>] : Noise before CTF")
        self.addParamsLine("  [--after_ctf_noise] : Split --noise between a pre-CTF part and a post-CTF part shaped by the CTF background noise model (reference power balance)")
        self.addParamsLine("  [--defocus_change <v=0>] : Random change of the defocus per image (percentage)")
        self.addParamsLine("  [--downsampling <D=1>] : Downsampling factor of the input with respect to the original micrograph (rescales the CTF sampling rate)")
        self.addParamsLine("  [--seed <s=0>]    : Random seed")

    def run(self):
        import copy

        from xmipp3_tpu_torch.core.metadata_program import (is_metadata_file,
                                                            load_image_rows)
        from xmipp3_tpu_torch.ops.ctf import CTFDescription, apply_ctf
        dev = resolve_device(self.getParam("--device"))
        fn_in = self.getParam("-i")
        if is_metadata_file(fn_in):
            imgs = load_image_rows(list(MetaData(fn_in).iterRows()))
        else:
            imgs = Image.read_stack(fn_in)
        rng = np.random.default_rng(self.getIntParam("--seed"))
        shape = imgs.shape
        H, W = shape[-2:]
        x = torch.as_tensor(imgs, device=dev)
        ctf = None
        if self.checkParam("--ctf") and self.getParam("--ctf"):
            ctf = CTFDescription.from_metadata(self.getParam("--ctf"))
            D = self.getDoubleParam("--downsampling") \
                if self.checkParam("--downsampling") else 1.0
            if D != 1.0:
                # reference: ctf.changeSamplingRate(Tm * downsampling)
                ctf.sampling_rate = ctf.sampling_rate * D

        s_before = self.getDoubleParam("--noise_before")
        s_after = self.getDoubleParam("--noise")
        noise_filter = None
        if ctf is not None and self.checkParam("--after_ctf_noise") \
                and s_after > 0:
            # reference updateCtfs power balance: split sigma between the
            # pre-CTF (CTF-shaped) and post-CTF (noise-model-shaped) parts
            c2d = ctf.generate_2d(H, W, rfft_layout=True, device=dev)
            fy = np.fft.fftfreq(H)[:, None] / ctf.sampling_rate
            fx = np.fft.rfftfreq(W)[None, :] / ctf.sampling_rate
            bg = ctf.noise_at(fx * np.ones_like(fy), fy * np.ones_like(fx),
                              device=dev).clamp(min=0)
            before_power = float((c2d ** 2).mean())
            after_power = float(bg.mean())
            if after_power + before_power > 0:
                p = after_power / (after_power + before_power)
                K = 1.0 / np.sqrt(p * after_power
                                  + (1 - p) * before_power + 1e-300)
                sigma = s_after
                s_after = float(np.sqrt(p) * K * sigma)
                s_before = float(max(s_before,
                                     np.sqrt(1 - p) * K * sigma))
                nf = torch.sqrt(bg)
                noise_filter = nf / max(
                    float(torch.sqrt((nf ** 2).mean())), 1e-12)

        if s_before > 0:
            x = x + torch.as_tensor(
                rng.normal(0, s_before, shape).astype(np.float32),
                device=dev)
        if ctf is not None:
            dc = self.getDoubleParam("--defocus_change") \
                if self.checkParam("--defocus_change") else 0.0
            if dc != 0:
                # per-image random defocus in [1-dc%, 1+dc%], drawn in the
                # reference's order (U then V, image by image)
                ctfs = []
                for _ in range(len(x)):
                    c = copy.copy(ctf)
                    c.defocusU = ctf.defocusU * rng.uniform(1 - dc / 100,
                                                            1 + dc / 100)
                    c.defocusV = ctf.defocusV * rng.uniform(1 - dc / 100,
                                                            1 + dc / 100)
                    ctfs.append(c)
                x = apply_ctf(x, ctfs)
            else:
                x = apply_ctf(x, ctf)
        if s_after > 0:
            noise = torch.as_tensor(
                rng.normal(0, s_after, shape).astype(np.float32),
                device=dev)
            if noise_filter is not None:
                noise = torch.fft.irfft2(torch.fft.rfft2(noise)
                                         * noise_filter, s=(H, W))
            x = x + noise
        save_image(self.getParam("-o"), x.cpu().numpy())


PROGRAM = None
