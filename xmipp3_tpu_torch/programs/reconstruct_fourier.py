"""xmipp_reconstruct_fourier — direct Fourier 3-D reconstruction on the card.

Contract: reference reconstruct_fourier CLI (reconstruction/
reconstruct_fourier.cpp:36-62 defineParams; FSC-halves mode :1002-1047),
with the flags and outputs of the reference package's program. Runs on the
card unless `--device cpu` is given.

Not yet ported, and rejected with an error when given: --useCTF and the
device-mesh flags (--mesh other than none/serial, --dist_*); ROADMAP.md
queues both.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import resolve_device
from xmipp3_tpu_torch.ops.reconstruct import FourierReconstructor

_LATER = {
    "--useCTF": "--useCTF (the ops/ctf.py subset and "
                "ctf_gridding_multipliers)",
    "--mesh": "the mesh paths with K3's kz-slab mode",
}


class ProgRecFourier(XmippProgram):
    name = "xmipp_reconstruct_fourier"

    def defineParams(self):
        self.addUsageLine("Generate 3D reconstructions from projections using "
                          "direct Fourier interpolation with arbitrary geometry.")
        self.addParamsLine("   -i <md_file>                : Metadata file with input projections")
        self.addParamsLine("  [-o <volume_file=\"rec_fourier.vol\">]  : Filename for output volume")
        self.addParamsLine("  [--iter <iterations=1>]      : Number of iterations for weight correction")
        self.addParamsLine("  [--sym <symfile=c1>]         : Enforce symmetry in projections")
        self.addParamsLine("  [--padding <proj=2.0> <vol=2.0>]  : Padding used for projections and volume")
        self.addParamsLine("  [--prepare_fsc <fscfile>]    : Filename root for FSC files")
        self.addParamsLine("  [--max_resolution <p=0.5>]   : Max resolution (Nyquist=0.5)")
        self.addParamsLine("  [--weight]                   : Use weights stored in the image metadata")
        self.addParamsLine("  [--blob <radius=1.9> <order=0> <alpha=15>] : Blob parameters (reference interpolant; radius<=0 selects trilinear)")
        self.addParamsLine("  [--interp <mode=kb>]         : Gridding window: kb (Kaiser-Bessel blob, reference default), tri (trilinear, fastest), tri+kb, nn")
        self.addParamsLine("  [--batch <b=256>]            : Images per device batch")
        self.addParamsLine("  [--useCTF]                   : Use CTF information if present (not yet ported: rejected)")
        self.addParamsLine("  [--sampling <Ts=1>]          : sampling rate of the input images in Angstroms/pixel")
        self.addParamsLine("  [--phaseFlipped]             : Give this flag if images have been already phase flipped")
        self.addParamsLine("  [--minCTF <ctf=0.01>]        : Minimum value of the CTF that will be inverted")
        self.addParamsLine("  [--mesh <mode=none>]         : Device-mesh parallel mode (not yet ported: only none/serial)")
        self.addParamsLine("  [--dist_coordinator <addr=\"\">] : Multi-host coordinator (not yet ported: rejected)")
        self.addParamsLine("  [--dist_nprocs <n=-1>]       : Processes in a multi-host run (not yet ported: rejected)")
        self.addParamsLine("  [--dist_procid <i=-1>]       : This process' index (not yet ported: rejected)")
        self.addExampleLine("   python -m xmipp3_tpu_torch.programs reconstruct_fourier -i reconstruction.sel --sym i3 --weight")

    def _reject(self, flag: str, item: str):
        raise XmippError(ErrCode.NOT_IMPLEMENTED,
                         f"{flag} is not yet ported to xmipp3_tpu_torch "
                         f"(ROADMAP.md, port queue: {item})")

    def readParams(self):
        if self.checkParam("--useCTF"):
            self._reject("--useCTF", _LATER["--useCTF"])
        if self.checkParam("--mesh") and \
                self.getParam("--mesh") not in ("none", "serial"):
            self._reject("--mesh " + self.getParam("--mesh"), _LATER["--mesh"])
        for flag in ("--dist_coordinator", "--dist_nprocs", "--dist_procid"):
            if self.checkParam(flag):
                self._reject(flag, _LATER["--mesh"])
        self.fn_in = self.getParam("-i")
        self.fn_out = self.getParam("-o")
        self.sym = self.getParam("--sym")
        self.pad = self.getDoubleParam("--padding", 1)
        self.max_res = self.getDoubleParam("--max_resolution")
        self.use_weights = self.checkParam("--weight")
        self.batch = self.getIntParam("--batch")
        self.niter_weight = self.getIntParam("--iter")
        self.interp = self.getParam("--interp") if \
            self.checkParam("--interp") else "kb"
        self.blob = (self.getDoubleParam("--blob", 0),
                     self.getIntParam("--blob", 1),
                     self.getDoubleParam("--blob", 2))
        if self.blob[0] <= 0:
            self.interp = "tri"
        self.fn_fsc = self.getParam("--prepare_fsc") if \
            self.checkParam("--prepare_fsc") else ""
        self.device_arg = self.getParam("--device")

    def show(self):
        if self.verbose:
            print(f"Input metadata    : {self.fn_in}")
            print(f"Output volume     : {self.fn_out}")
            print(f"Symmetry          : {self.sym}")
            print(f"Padding factor    : {self.pad}")
            print(f"Max resolution    : {self.max_res}")

    def _reconstruct_subset(self, md: MetaData, rows_idx, N: int):
        rows = [md.getRow(i) for i in rows_idx]
        rec = FourierReconstructor(N, self.pad, self.sym, self.max_res,
                                   interp=self.interp,
                                   niter_weight=self.niter_weight,
                                   blob=self.blob, device=self.device)
        for s in range(0, len(rows), self.batch):
            chunk = rows[s:s + self.batch]
            with timed_phase("read images"):
                imgs = np.stack([np.squeeze(Image(r["image"]).data)
                                 for r in chunk]).astype(np.float32)
            get = lambda k, d=0.0: np.array(
                [float(r.get(k, d)) for r in chunk], np.float32)
            with timed_phase("add_batch", sync=rec.data_r):
                rec.add_batch(imgs, get("angleRot"), get("angleTilt"),
                              get("anglePsi"), get("shiftX"), get("shiftY"),
                              get("weight", 1.0) if self.use_weights else None,
                              flip=get("flip", 0.0).astype(bool))
            if self.verbose:
                print(f"  processed {min(s + self.batch, len(rows))}/{len(rows)}")
        with timed_phase("finish"):
            return rec.finish().cpu().numpy()

    def run(self):
        self.device = resolve_device(self.device_arg)
        # the pipeline is full float32: no TF32 in library products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        md = MetaData(self.fn_in)
        md.removeDisabled()
        first = Image()
        first.read(md.getRow(md.firstObject())["image"], header_only=True)
        N = first.header.shape[-1]
        all_idx = list(md)
        if self.fn_fsc:
            # split halves (even/odd), write *_1/2 recons + merged
            h1 = self._reconstruct_subset(md, all_idx[0::2], N)
            h2 = self._reconstruct_subset(md, all_idx[1::2], N)
            root = self.fn_fsc
            save_image(root + "_1_recons.vol", h1)
            save_image(root + "_2_recons.vol", h2)
            vol = 0.5 * (h1 + h2)
        else:
            vol = self._reconstruct_subset(md, all_idx, N)
        with timed_phase("write volume"):
            save_image(self.fn_out, vol)
        if self.verbose:
            print(f"Reconstruction written to {self.fn_out}")


PROGRAM = ProgRecFourier
