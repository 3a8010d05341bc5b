"""xmipp_reconstruct_fourier — direct Fourier 3-D reconstruction on the card.

Contract: reference reconstruct_fourier CLI (reconstruction/
reconstruct_fourier.cpp:36-62 defineParams; FSC-halves mode :1002-1047),
with the flags and outputs of the reference package's program. Runs on the
card unless `--device cpu` is given.

--mesh dp|slab|slab2d (auto = dp on more than one rank) runs the mesh
reconstructors of parallel/reconstruct.py over the ranks of a
torch.distributed process group, started from --dist_coordinator,
--dist_nprocs and --dist_procid or by torchrun (parallel/cli.py); only
rank 0 writes files.

--useCTF corrects for each row's CTF during gridding (1/CTF on the data,
clipped at --minCTF; --phaseFlipped when the images were phase flipped),
with the frequencies converted by --sampling, when the rows carry CTF
labels: inline ctf* labels or a ctfModel .ctfparam file per row (the
reference's hasCTF gate; without them the run is the plain one).
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import load_image_rows
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import resolve_device
from xmipp3_tpu_torch.ops.ctf import CTFDescription, ctf_params_arrays
from xmipp3_tpu_torch.ops.reconstruct import FourierReconstructor
from xmipp3_tpu_torch.parallel.cli import (add_mesh_params,
                                           maybe_init_distributed,
                                           read_mesh_params, resolve_mesh)
from xmipp3_tpu_torch.parallel.mesh import backend, world
from xmipp3_tpu_torch.parallel.reconstruct import (parallel_reconstruct,
                                                   slab_reconstruct,
                                                   slab_reconstruct_2d)


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
        self.addParamsLine("  [--useCTF]                   : Use CTF information if present (per-frequency 1/CTF inversion during gridding)")
        self.addParamsLine("  [--sampling <Ts=1>]          : sampling rate of the input images in Angstroms/pixel")
        self.addParamsLine("  [--phaseFlipped]             : Give this flag if images have been already phase flipped")
        self.addParamsLine("  [--minCTF <ctf=0.01>]        : Minimum value of the CTF that will be inverted")
        add_mesh_params(self)
        self.addExampleLine("   python -m xmipp3_tpu_torch.programs reconstruct_fourier -i reconstruction.sel --sym i3 --weight")

    def readParams(self):
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
        self.use_ctf = self.checkParam("--useCTF")
        self.phase_flipped = self.checkParam("--phaseFlipped")
        self.min_ctf = self.getDoubleParam("--minCTF")
        self.sampling = self.getDoubleParam("--sampling")
        self._ctf_cache = {}
        self.device_arg = self.getParam("--device")
        read_mesh_params(self)

    def show(self):
        if self.verbose:
            print(f"Input metadata    : {self.fn_in}")
            print(f"Output volume     : {self.fn_out}")
            print(f"Symmetry          : {self.sym}")
            print(f"Padding factor    : {self.pad}")
            print(f"Max resolution    : {self.max_res}")

    def _ctf_params_for(self, rows):
        """Per-row CTF parameter arrays for --useCTF gridding, or None.

        The reference's hasCTF gate (ctfModel or ctfDefocusU label present
        AND --useCTF, reconstruct_fourier.cpp:335-336) and its per-row
        readFromMetadataRow (:367-372): inline ctf* labels, or a per-row
        ctfModel file (parsed once per distinct path)."""
        if not self.use_ctf:
            return None
        with timed_phase("ctf params"):
            if not any(("ctfModel" in r) or ("ctfDefocusU" in r)
                       for r in rows):
                return None
            descs = []
            for r in rows:
                if "ctfModel" in r and r["ctfModel"]:
                    fn = str(r["ctfModel"])
                    if fn not in self._ctf_cache:
                        self._ctf_cache[fn] = CTFDescription.from_metadata(fn)
                    descs.append(self._ctf_cache[fn])
                else:
                    descs.append(CTFDescription.from_row(r))
            return ctf_params_arrays(descs)

    def _ctf_kw(self):
        return dict(sampling=self.sampling, min_ctf=self.min_ctf,
                    phase_flipped=self.phase_flipped)

    def _reconstruct_subset(self, md: MetaData, rows_idx, N: int):
        rows = [md.getRow(i) for i in rows_idx]
        if self._mesh is not None:
            return self._reconstruct_mesh(rows)
        rec = FourierReconstructor(N, self.pad, self.sym, self.max_res,
                                   interp=self.interp,
                                   niter_weight=self.niter_weight,
                                   blob=self.blob, device=self.device,
                                   **self._ctf_kw())
        for s in range(0, len(rows), self.batch):
            chunk = rows[s:s + self.batch]
            with timed_phase("read images"):
                imgs = load_image_rows(chunk)
            get = lambda k, d=0.0: np.array(
                [float(r.get(k, d)) for r in chunk], np.float32)
            ctfp = self._ctf_params_for(chunk)
            with timed_phase("add_batch", sync=rec.data_r):
                rec.add_batch(imgs, get("angleRot"), get("angleTilt"),
                              get("anglePsi"), get("shiftX"), get("shiftY"),
                              get("weight", 1.0) if self.use_weights else None,
                              flip=get("flip", 0.0).astype(bool), ctfp=ctfp)
            if self.verbose:
                print(f"  processed {min(s + self.batch, len(rows))}/{len(rows)}")
        with timed_phase("finish"):
            return rec.finish().cpu().numpy()

    def _reconstruct_mesh(self, rows):
        """Mesh-parallel reconstruction (the mpi_reconstruct_fourier
        equivalent, reference programs/reconstruct_fourier.py:123-160): dp =
        particle-sharded + one all_reduce of the cubes; slab/slab2d = kz-slab
        sharding of the cube. Every rank reads the whole stack."""
        with timed_phase("read images"):
            imgs = load_image_rows(rows)
        get = lambda k, d=0.0: np.array(
            [float(r.get(k, d)) for r in rows], np.float32)
        w = get("weight", 1.0) if self.use_weights else None
        flip = get("flip", 0.0).astype(bool)
        kw = dict(weights=w, pad_factor=self.pad, max_freq=self.max_res,
                  interp=self.interp, niter_weight=self.niter_weight,
                  batch=self.batch, ctfp=self._ctf_params_for(rows),
                  **self._ctf_kw())
        if self._mesh_mode in ("slab", "slab2d"):
            if self.sym.lower() not in ("c1", ""):
                raise ValueError("--mesh slab currently supports c1 only; "
                                 "use --mesh dp for symmetric reconstructions")
            fn = slab_reconstruct_2d if self._mesh_mode == "slab2d" \
                else slab_reconstruct
            vol = fn(self._mesh, np.where(flip[:, None, None],
                                          imgs[:, :, ::-1], imgs),
                     get("angleRot"), get("angleTilt"), get("anglePsi"),
                     np.where(flip, -get("shiftX"), get("shiftX")),
                     get("shiftY"), **kw)
        else:
            vol = parallel_reconstruct(
                self._mesh, imgs, get("angleRot"), get("angleTilt"),
                get("anglePsi"), get("shiftX"), get("shiftY"), sym=self.sym,
                flip=flip, **kw)
        return vol.cpu().numpy()

    def run(self):
        self.device = resolve_device(self.device_arg)
        started = maybe_init_distributed(self)
        try:
            self._run()
        finally:
            if started:
                torch.distributed.destroy_process_group()

    def _run(self):
        self._mesh, self._mesh_mode = resolve_mesh(self.mesh_mode,
                                                   device=self.device_arg)
        if self._mesh is not None:
            self.device = self._mesh.device
            if self.verbose:
                print(f"mesh: {self._mesh_mode} {self._mesh.shape} over "
                      f"{self._mesh.size} ranks, rank {self._mesh.rank} on "
                      f"{self.device}, backend {backend()}")
        writes = world()[1] == 0          # only rank 0 writes files
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
            if writes:
                save_image(root + "_1_recons.vol", h1)
                save_image(root + "_2_recons.vol", h2)
            vol = 0.5 * (h1 + h2)
        else:
            vol = self._reconstruct_subset(md, all_idx, N)
        if not writes:
            return
        with timed_phase("write volume"):
            save_image(self.fn_out, vol)
        if self.verbose:
            print(f"Reconstruction written to {self.fn_out}")


PROGRAM = ProgRecFourier
