"""NMA programs of the reference package's programs/nma_programs.py:
xmipp_nma_modes, xmipp_nma_alignment_vol and xmipp_pdb_nma_deform
(reference nma_alignment_vol, volume-vs-reference mode amplitude fitting
with the CONDOR optimizer replaced by Adam; pdb_nma_deform; the mode
computation step).

nma_alignment_vol runs on the card unless `--device cpu` is given: the
warp by the mode fields, the matching weights, the FRM alignment and the
Adam steps. The modes, the fields' interpolation from the atoms and the
PDB files stay on the host, as in the reference.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from xmipp3_tpu_torch.core.image import Image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.pdb import AtomicModel, read_pdb, write_pdb
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import resolve_device


def _read_modes(md_fn):
    from xmipp3_tpu_torch.models.nma import read_mode
    return np.stack([read_mode(str(r["nmaModefile"]))
                     for r in MetaData(md_fn).iterRows()])


class ProgNMAModes(XmippProgram):
    """Generate elastic-network normal modes from a PDB/pseudoatom model
    (role of the reference's external mode computation step; host
    numpy)."""
    name = "xmipp_nma_modes"

    def defineParams(self):
        self.addUsageLine("Compute elastic-network (Tirion) normal modes of "
                          "an atomic/pseudoatomic model.")
        self.addParamsLine("   -i <pdb>      : Input model")
        self.addParamsLine("   --oroot <root> : Output rootname (mode files + metadata)")
        self.addParamsLine("  [--nmodes <n=6>] : Number of nonrigid modes")
        self.addParamsLine("  [--cutoff <c=-1>] : Interaction cutoff (Å; -1 auto)")

    def run(self):
        from xmipp3_tpu_torch.models.nma import (elastic_network_modes,
                                                 write_modes)
        model = read_pdb(self.getParam("-i"))
        cutoff = self.getDoubleParam("--cutoff")
        with timed_phase("modes"):
            modes, evals = elastic_network_modes(
                model.coords, self.getIntParam("--nmodes"),
                None if cutoff <= 0 else cutoff)
        root = self.getParam("--oroot")
        files = write_modes(root, modes)
        MetaData.fromRows([
            {"nmaModefile": f, "nmaEnergy": float(evals[i]),
             "itemId": i + 1} for i, f in enumerate(files)]
        ).write(root + "_modes.xmd")
        self.modes = modes


class ProgNMAAlignmentVol(XmippProgram):
    """Full reference surface nma_alignment_vol.cpp:54-73: deformed-volume
    NMA fitting with optional FRM rigid alignment, 3-D mask, missing-wedge
    compensation and low-pass matching metric. The CONDOR trust-region
    optimizer maps to Adam on the differentiable warp->NCC chain
    (rhoStart scales the step, niter bounds the steps)."""
    name = "xmipp_nma_alignment_vol"

    def defineParams(self):
        self.addUsageLine("Fit NMA mode amplitudes deforming a reference "
                          "volume onto an input volume.")
        self.addParamsLine("   -i <volume>   : Volume (or metadata of "
                           "volumes) to explain")
        self.addParamsLine("   --pdb <pdb>   : Reference atomic/pseudoatom "
                           "model")
        self.addParamsLine("   --modes <md>  : Metadata listing mode files")
        self.addParamsLine("  [--vol <ref=\"\">] : Reference volume "
                           "(default: rasterized pdb)")
        self.addParamsLine("  [-o <md=nma_vol.xmd>] : Output amplitudes")
        self.addParamsLine("  [--odir <outputDir=\".\">] : Output directory")
        self.addParamsLine("  [--resume] : Resume processing (skip if the "
                           "output exists)")
        self.addParamsLine("  [--opdb <PDB_filename=\"\">] : Write the "
                           "deformed input PDB here")
        self.addParamsLine("  [--sampling_rate <Ts=1>] : Pixel size")
        self.addParamsLine("  [--filterVol <cutoff=15.>] : Low-pass the "
                           "deformed volume at this cutoff (A) before "
                           "comparing")
        self.addParamsLine("  [--centerPDB] : Center the PDB structure")
        self.addParamsLine("  [--fixed_Gaussian <std=-1>] : Pseudo-atom "
                           "fixed Gaussian std (A; -1 = from the PDB)")
        self.addParamsLine("  [--trustradius_scale <s=1>] : Scales the "
                           "optimizer's initial step size")
        self.addParamsLine("  [--alignVolumes <frm_freq=0.25> "
                           "<frm_shift=10>] : FRM-align the deformed "
                           "volume to the input before comparing")
        self.addParamsLine("  [--mask <m=\"\">] : 3D mask for the "
                           "comparison")
        self.addParamsLine("  [--tilt_values <tilt0=-90> <tiltF=90>] : "
                           "Missing-wedge compensation (Fourier wedge "
                           "between these tilts)")
        self.addParamsLine("  [--condor_params <rhoStartBase=250.> "
                           "<rhoEndBase=50.> <niter=10000>] : Optimizer "
                           "parameters (rhoStart scales the step, niter "
                           "bounds the iterations)")
        self.addParamsLine("  [--steps <n=60>] : Optimization steps")

    def run(self):
        from xmipp3_tpu_torch.core.pdb import rasterize
        from xmipp3_tpu_torch.models.nma import (mode_field, unit_fields,
                                                 warp_volume_field)
        from xmipp3_tpu_torch.ops.optim import adam_scan
        # the reference reads neither --alignVolumes' two values (FRM runs
        # at L 12 whatever they say) nor --condor_params' rhoEndBase
        # (ROADMAP.md section 3, item 21)
        if self.checkParam("--alignVolumes"):
            a = self.getListParam("--alignVolumes")
            if float(a[0]) != 0.25 or float(a[1]) != 10:
                self._refuse("--alignVolumes")
        if self.checkParam("--condor_params") and \
                float(self.getListParam("--condor_params")[1]) != 50:
            self._refuse("--condor_params")
        dev = resolve_device(self.getParam("--device"))
        odir = self.getParam("--odir") if self.checkParam("--odir") else "."
        fn_out = self.getParam("-o")
        if not os.path.isabs(fn_out) and odir not in ("", "."):
            os.makedirs(odir, exist_ok=True)
            fn_out = os.path.join(odir, fn_out)
        if self.checkParam("--resume") and os.path.exists(fn_out):
            return
        vol_t = np.squeeze(Image(self.getParam("-i")).data
                           ).astype(np.float32)
        model = read_pdb(self.getParam("--pdb"))
        if self.checkParam("--centerPDB"):
            model = model.centered()
        modes = _read_modes(self.getParam("--modes"))
        Ts = self.getDoubleParam("--sampling_rate")
        N = vol_t.shape[0]
        fixed_std = self.getDoubleParam("--fixed_Gaussian")
        if self.checkParam("--vol") and self.getParam("--vol"):
            vol_r = np.squeeze(Image(self.getParam("--vol")).data
                               ).astype(np.float32)
        else:
            vol_r = rasterize(model, N, Ts,
                              sigma_a=fixed_std if fixed_std > 0 else 2.0)
        with timed_phase("fields"):
            uf = torch.as_tensor(unit_fields(model.coords, modes, N, Ts),
                                 device=dev)
        vr = torch.as_tensor(vol_r, dtype=torch.float32, device=dev)

        # matching weights: low-pass (--filterVol) and missing wedge
        # (--tilt_values) act in Fourier; --mask in real space
        fz = np.fft.fftfreq(N)[:, None, None]
        fy = np.fft.fftfreq(N)[None, :, None]
        fx = np.fft.rfftfreq(N)[None, None, :]
        w = np.ones((N, N, N // 2 + 1), np.float32)
        if self.checkParam("--filterVol"):
            fc = Ts / max(self.getDoubleParam("--filterVol"), 2 * Ts)
            w *= (np.sqrt(fz ** 2 + fy ** 2 + fx ** 2) <= fc)
        if self.checkParam("--tilt_values"):
            toks = self.getListParam("--tilt_values")
            t0, tf = float(toks[0]), float(toks[1])
            # wedge about the y (tilt) axis: data where the (x,z) polar
            # angle lies within the acquired tilt range
            ang = np.degrees(np.arctan2(fz, fx + 0 * fy))
            inside = ((ang >= t0) & (ang <= tf)) | \
                     ((ang - 180 >= t0) & (ang - 180 <= tf)) | \
                     ((ang + 180 >= t0) & (ang + 180 <= tf))
            w *= inside | ((fz == 0) & (fx == 0) + np.zeros_like(ang,
                                                                 bool))
        spec_w = torch.as_tensor(w, device=dev) \
            if (self.checkParam("--filterVol")
                or self.checkParam("--tilt_values")) else None
        mask3 = None
        if self.checkParam("--mask") and self.getParam("--mask"):
            mask3 = torch.as_tensor((np.squeeze(
                Image(self.getParam("--mask")).data) > 0
            ).astype(np.float32), device=dev)
        do_align = self.checkParam("--alignVolumes")

        def prepare(v):
            if spec_w is not None:
                v = torch.fft.irfftn(torch.fft.rfftn(v) * spec_w, s=v.shape)
            if mask3 is not None:
                v = v * mask3
            return v

        vt_j = prepare(torch.as_tensor(vol_t, device=dev))
        bm = vt_j - vt_j.mean()

        warped_of = lambda amp: warp_volume_field(vr, mode_field(amp, uf))

        def loss(amp, R):
            warped = warped_of(amp)
            if do_align:
                from xmipp3_tpu_torch.ops.geo import apply_affine_3d
                warped = apply_affine_3d(warped, R[None])[0]
            warped = prepare(warped)
            am = warped - warped.mean()
            return -(am * bm).sum() / torch.sqrt(
                (am ** 2).sum() * (bm ** 2).sum()).clamp(min=1e-12)

        tr = self.getDoubleParam("--trustradius_scale")
        lr = 0.5 * tr
        n_steps = self.getIntParam("--steps")
        if self.checkParam("--condor_params"):
            toks = self.getListParam("--condor_params")
            lr *= float(toks[0]) / 250.0
            n_steps = min(n_steps, int(float(toks[2])))
        M = len(modes)
        amp = torch.zeros(M, device=dev)
        R = torch.eye(3, device=dev)
        rounds = 3 if do_align else 1
        with timed_phase("fit"):
            for _ in range(rounds):
                if do_align:
                    from xmipp3_tpu_torch.ops.frm import frm_align_volumes
                    M3 = frm_align_volumes(torch.as_tensor(vol_t, device=dev),
                                           warped_of(amp), L=12,
                                           refine=False)
                    R = torch.as_tensor(np.asarray(M3, np.float32),
                                        device=dev)
                amp, _ = adam_scan(lambda a: loss(a, R), amp,
                                   max(n_steps // rounds, 1), lr)
            ncc = -float(loss(amp, R))
        amp = amp.cpu().numpy()
        row = {"image": self.getParam("-i"),
               "nmaDisplacements": amp.astype(np.float64),
               "cost": float(ncc), "maxCC": float(ncc)}
        MetaData.fromRows([row]).write(fn_out)
        if self.checkParam("--opdb") and self.getParam("--opdb"):
            disp = np.einsum("m,mnk->nk", amp.astype(np.float64),
                             modes.astype(np.float64))
            write_pdb(self.getParam("--opdb"),
                      AtomicModel(model.coords + disp, model.elements,
                                  model.bfactors, model.occupancies))
        self.amplitudes = amp
        self.ncc = ncc
        if self.verbose:
            print(f"amplitudes: {np.round(amp, 3)}  NCC={ncc:.4f}")

    def _refuse(self, flag):
        from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
        raise XmippError(
            ErrCode.ARG_INCORRECT,
            f"{flag}: the reference accepts these values and never reads "
            f"them; the port refuses them rather than ignore them "
            f"(ROADMAP.md section 3, item 21)")


class ProgPDBNMADeform(XmippProgram):
    name = "xmipp_pdb_nma_deform"

    def defineParams(self):
        self.addUsageLine("Deform a PDB along normal modes with given "
                          "amplitudes.")
        self.addParamsLine("   --pdb <file>  : Input PDB")
        self.addParamsLine("   -o <file>     : Deformed PDB")
        self.addParamsLine("   --nma <md>  : Metadata listing mode files (label nmaModefile)")
        self.addParamsLine("   alias --modes;")
        self.addParamsLine("   --deformations <...> : One amplitude per mode")

    def run(self):
        model = read_pdb(self.getParam("--pdb"))
        modes = _read_modes(self.getParam("--nma"))
        amps = np.array([float(t) for t in
                         self.getListParam("--deformations")], np.float64)
        disp = np.einsum("m,mnk->nk", amps[: len(modes)],
                         modes[: len(amps)].astype(np.float64))
        out = AtomicModel(model.coords + disp, model.elements,
                          model.bfactors, model.occupancies)
        write_pdb(self.getParam("-o"), out)
