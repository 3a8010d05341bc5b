"""xmipp_resolution_fsc — FSC/DPR between two volumes or image halves
(reference resolution_fsc.h:33, resolution_fsc.cpp:59-210).

The reference package's surface: -i/--ref pair mode or --set_of_images
half-split mode, --oroot/-o outputs, --dont_apply_geo, --do_dpr,
--max_sam/--min_sam band zeroing, --do_rfactor appended `rfactor@` block.
Output columns match writeFiles (resolution_fsc.cpp:115-163): freq, FRC,
optional DPR, L2 error, random-noise FRC, real-space freq, rows from shell
i>=1. The spectra and shell sums run on the card unless `--device cpu` is
given.
"""
from __future__ import annotations

import numpy as np

from xmipp3_tpu_torch.core.image import Image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import load_image_rows
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import resolve_device
from xmipp3_tpu_torch.ops.fsc import (frc_dpr_curves, frc_rfactor,
                                      fsc_resolution)
from xmipp3_tpu_torch.ops.geo import apply_md_geometry


class ProgResolutionFsc(XmippProgram):
    name = "xmipp_resolution_fsc"

    def defineParams(self):
        self.addUsageLine("Calculate the Fourier Shell Correlation between "
                          "two volumes (or FRC between two images / the two "
                          "random halves of an image set).")
        self.addParamsLine("  [-i <file=\"\">]     : Image/volume to compare against --ref")
        self.addParamsLine("  [--ref <file=\"\">]  : Reference image/volume")
        self.addParamsLine("  [--set_of_images <selfile=\"\">] : selfile of 2D images; "
                           "FRC between the averages of its two halves")
        self.addParamsLine("  [--oroot <root=\"\">] : Root of the output metadata "
                           "(default: input rootname)")
        self.addParamsLine("  [-o <output_md=\"\">] : Output file name")
        self.addParamsLine("  [--sampling_rate <Ts=1>] : Pixel size (Å)")
        self.addParamsLine("   alias -s;")
        self.addParamsLine("  [--dont_apply_geo]  : for 2D-images: do not apply "
                           "the metadata transformation")
        self.addParamsLine("  [--do_dpr]          : compute differential phase "
                           "residual too (default: only FRC)")
        self.addParamsLine("  [--max_sam <A=-1>]  : set FSC to 0 above this "
                           "resolution (Å); -1 = all frequencies")
        self.addParamsLine("  [--min_sam <A=-1>]  : minimum frequency used for "
                           "the R-factor (Å)")
        self.addParamsLine("  [--do_rfactor]      : compute the R-factor for "
                           "the input volumes")
        self.addParamsLine("  [--threshold <t=0.143>] : resolution criterion "
                           "threshold (reported at -v)")

    def readParams(self):
        self.fn_in = self.getParam("-i")
        self.fn_ref = self.getParam("--ref")
        self.fn_sel = self.getParam("--set_of_images")
        if self.fn_sel:
            if self.fn_in or self.fn_ref:
                raise ValueError(
                    "--set_of_images is incompatible with -i/--ref")
        elif not (self.fn_in and self.fn_ref):
            raise ValueError("provide -i and --ref, or --set_of_images")
        self.fn_out = self.getParam("-o")
        self.fn_root = self.getParam("--oroot")
        self.Ts = self.getDoubleParam("--sampling_rate")
        self.apply_geo = not self.checkParam("--dont_apply_geo")
        self.do_dpr = self.checkParam("--do_dpr")
        self.do_rfactor = self.checkParam("--do_rfactor")
        self.max_sam = self.getDoubleParam("--max_sam")
        self.min_sam = self.getDoubleParam("--min_sam")
        self.threshold = self.getDoubleParam("--threshold")
        self.device_arg = self.getParam("--device")

    # -- helpers -----------------------------------------------------------
    def _half_averages(self):
        """Average the two halves (even/odd rows — deterministic stand-in
        for the reference's randomized split, resolution_fsc.cpp:197)."""
        md = MetaData(self.fn_sel)
        md.removeDisabled()
        rows = list(md.iterRows())
        imgs = load_image_rows(rows)
        if self.apply_geo:
            get = lambda k: np.array([float(r.get(k, 0.0)) for r in rows],
                                     np.float32)
            flip = np.array([bool(r.get("flip", 0)) for r in rows])
            imgs = apply_md_geometry(imgs, get("anglePsi"), get("shiftX"),
                                     get("shiftY"), flip,
                                     device=self.device).cpu().numpy()
        return imgs[0::2].mean(0), imgs[1::2].mean(0)

    def _write(self, fn_root, curves, rfactor):
        freq = curves["freq"]
        frc = curves["frc"].copy()
        dpr = curves["dpr"].copy()
        with np.errstate(divide="ignore"):
            freq_real = np.where(freq > 0, 1.0 / np.maximum(freq, 1e-30), 1e30)
        if self.max_sam > 0:
            kill = freq_real < self.max_sam
            frc[kill] = 0.0
            dpr[kill] = 0.0
        if self.min_sam > 0:
            kill = freq_real > self.min_sam
            frc[kill] = 0.0
            dpr[kill] = 0.0
        rows = []
        for i in range(1, len(freq)):
            row = {"resolutionFreq": float(freq[i]),
                   "resolutionFRC": float(frc[i])}
            if self.do_dpr:
                row["resolutionDPR"] = float(dpr[i])
            row["resolutionErrorL2"] = float(curves["error_l2"][i])
            row["resolutionFRCRandomNoise"] = float(curves["frc_noise"][i])
            row["resolutionFreqReal"] = float(freq_real[i])
            rows.append(row)
        fn_frc = self.fn_out if self.fn_out else fn_root + ".frc"
        MetaData.fromRows(rows).write(fn_frc)
        MetaData.fromRows([{"resolutionRfactor": float(rfactor)}]).write(
            fn_frc, block="rfactor", append=True)
        self.resolution = fsc_resolution(curves["freq_dig"][1:], frc[1:],
                                         self.threshold, self.Ts)
        if self.verbose:
            print(f"Resolution ({self.threshold} criterion): "
                  f"{self.resolution:.3f} A")

    def run(self):
        self.device = resolve_device(self.device_arg)
        with timed_phase("read images"):
            if self.fn_sel:
                a1, a2 = self._half_averages()
                root = self.fn_root or self.fn_sel.rsplit(".", 1)[0]
            else:
                a1 = np.squeeze(Image(self.fn_ref).data).astype(np.float32)
                a2 = np.squeeze(Image(self.fn_in).data).astype(np.float32)
                root = self.fn_root or self.fn_in.rsplit(".", 1)[0]
        with timed_phase("curves"):
            curves = frc_dpr_curves(a1, a2, self.Ts, self.do_dpr,
                                    device=self.device)
            rfactor = -1.0
            if self.do_rfactor and a1.ndim == 3:
                min_f = self.Ts / self.min_sam if self.min_sam > 0 else -2.0
                max_f = self.Ts / self.max_sam if self.max_sam > 0 else 0.5
                rfactor = frc_rfactor(a1, a2, min_f, max_f,
                                      device=self.device)
        with timed_phase("write metadata"):
            self._write(root, curves, rfactor)


PROGRAM = ProgResolutionFsc
