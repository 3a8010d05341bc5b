"""xmipp_transform_normalize — image normalization, on the card (reference
data/normalize.{h,cpp}: the method family OldXmipp/Near_OldXmipp/NewXmipp/
NewXmipp2/Tomography/Tomography0/Robust/Michael/None/Random/Ramp/Neighbour,
dust removal, --prm/--clip/--tiltMask/--thr_* flags), with the flags of the
reference package's programs/transform_normalize.py."""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.metadata_program import XmippMetadataProgram
from xmipp3_tpu_torch.ops.normalize import (normalize, normalize_tomography,
                                            remove_dust)


class ProgNormalize(XmippMetadataProgram):
    name = "xmipp_transform_normalize"

    def defineProcessParams(self):
        self.addUsageLine("Normalize images: zero background mean, unit noise variance.")
        self.addParamsLine("[--method <mth=NewXmipp>]  : Normalization method")
        self.addParamsLine("    where <mth>")
        self.addParamsLine("       OldXmipp      : I=(I-m(I))/stddev(I)")
        self.addParamsLine("       Near_OldXmipp : I=(I-m(I))/stddev(bg)")
        self.addParamsLine("       NewXmipp      : I=(I-m(bg))/stddev(bg)")
        self.addParamsLine("       NewXmipp2     : I=(I-m(bg))/(m(I)-m(bg))")
        self.addParamsLine("       Tomography    : I=(I-mean(I))/(stddev(I)*cos(tilt))")
        self.addParamsLine("       Tomography0   : like Tomography with the 0-degree stats")
        self.addParamsLine("       Robust        : I=(I-m(bg))/P99(I)")
        self.addParamsLine("       Michael       : I=(I-m(bg))/m(bg)")
        self.addParamsLine("       None          : only dust removal")
        self.addParamsLine("       Random        : I=aI+b with random a, b")
        self.addParamsLine("       Ramp          : subtract background ramp")
        self.addParamsLine("       Neighbour     : replace background outliers with noise")
        self.addParamsLine("[--background <mode>] : Background region")
        self.addParamsLine("    where <mode>")
        self.addParamsLine("       circle <r> : outside radius r")
        self.addParamsLine("       frame <w>  : frame of width w")
        self.addParamsLine("[--invert]  : Invert contrast")
        self.addParamsLine("[--thr_black_dust <sblack=-3.5>] : Remove black dust with this sigma threshold")
        self.addParamsLine("[--thr_white_dust <swhite=3.5>]  : Remove white dust with this sigma threshold")
        self.addParamsLine("[--thr_neigh <value=1.2>] : Sigma threshold for Neighbour removal")
        self.addParamsLine("[--prm <a0=0> <aF=1> <b0=0> <bF=0>] : Random method I=aI+b ranges")
        self.addParamsLine("[--clip] : Robust method: clip to +-1.3284")
        self.addParamsLine("[--tiltMask] : Tomography: zero outside the cos(tilt) band")

    def readProcessParams(self):
        self.method = self.getParam("--method") if self.checkParam("--method") \
            else "NewXmipp"
        self.bg_radius = None
        if self.checkParam("--background"):
            if self.getParam("--background") == "circle":
                self.bg_radius = self.getDoubleParam("--background", 1)
        self.invert = self.checkParam("--invert")
        self.thr_black = self.getDoubleParam("--thr_black_dust") if \
            self.checkParam("--thr_black_dust") else None
        self.thr_white = self.getDoubleParam("--thr_white_dust") if \
            self.checkParam("--thr_white_dust") else None
        self.thr_neigh = self.getDoubleParam("--thr_neigh") if \
            self.checkParam("--thr_neigh") else 1.2
        self.prm = [self.getDoubleParam("--prm", i) for i in range(4)] if \
            self.checkParam("--prm") else [0.0, 1.0, 0.0, 0.0]
        self.clip = self.checkParam("--clip")
        self.tilt_mask = self.checkParam("--tiltMask")
        self.rng = np.random.default_rng(0)
        self._tomo0 = None   # (mu0, sigma0) lazily from the least-tilted row

    def preProcess(self):
        # full float32: no TF32 in library products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if self.method == "Tomography0":
            # reference preProcess: stats of the image closest to 0 tilt
            rows = list(self.mdIn.iterRows())
            tilts = [abs(float(r.get("angleTilt", 0.0) or 0.0))
                     for r in rows]
            from xmipp3_tpu_torch.core.metadata_program import load_image_rows
            img0 = load_image_rows([rows[int(np.argmin(tilts))]])[0]
            t0 = float(rows[int(np.argmin(tilts))].get("angleTilt", 0.0)
                       or 0.0)
            _, mu0, sigma0 = normalize_tomography(img0, t0,
                                                  tilt_mask=self.tilt_mask)
            self._tomo0 = (mu0, sigma0)

    def processBatch(self, imgs, rows):
        """Dust removal, Random, Tomography* and the Robust/Neighbour
        methods run on the host in numpy, drawing from the program's numpy
        Generator in the reference's order; the other methods run on the
        card."""
        if self.invert:
            imgs = -imgs
        if self.thr_black is not None or self.thr_white is not None:
            imgs = remove_dust(imgs, self.thr_black, self.thr_white,
                               rng=self.rng)
        m = self.method
        if m == "None":
            return imgs
        if m == "Random":
            a0, aF, b0, bF = self.prm
            a = self.rng.uniform(a0, aF, len(rows)).astype(np.float32)
            b = self.rng.uniform(b0, bF, len(rows)).astype(np.float32)
            return imgs * a[:, None, None] + b[:, None, None]
        if m in ("Tomography", "Tomography0"):
            out = np.empty_like(imgs)
            for i, (img, r) in enumerate(zip(imgs, rows)):
                tilt = float(r.get("angleTilt", 0.0) or 0.0)
                if m == "Tomography0":
                    mu0, sigma0 = self._tomo0 or (0.0, 1.0)
                    out[i], _, _ = normalize_tomography(
                        img, tilt, tilt_mask=self.tilt_mask,
                        tomography0=True, mu0=mu0, sigma0=sigma0)
                else:
                    out[i], _, _ = normalize_tomography(
                        img, tilt, tilt_mask=self.tilt_mask)
            return out
        return normalize(imgs, m, self.bg_radius, clip=self.clip,
                         thr_neigh=self.thr_neigh, rng=self.rng,
                         device=self.device)


PROGRAM = ProgNormalize
