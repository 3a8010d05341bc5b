"""Classification programs: xmipp_classify_CL2D, xmipp_ml_align2d,
xmipp_mlf_align2d and xmipp_classify_kerdensom.

Contracts: the reference mpi_classify_CL2D, ml_align2d (ml2d.h:59),
mlf_align2d (mlf_align2d.h:70) and classify_kerdensom, with the flags of
the reference package's programs/classify.py. The engines are
models/cl2d.py, ml2d.py and som.py; each runs on the card unless
`--device cpu` is given.

`--mesh dp` (auto = dp on more than one rank) runs CL2D's matching and
ML2D's E and M steps over the ranks of a torch.distributed process group,
started from --dist_coordinator, --dist_nprocs and --dist_procid or by
torchrun (parallel/cli.py); every rank holds the same result and only
rank 0 writes files.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import (is_metadata_file,
                                                    load_image_rows)
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import resolve_device
from xmipp3_tpu_torch.parallel.cli import (MeshProgram, add_mesh_params,
                                           read_mesh_params)


def _read_fractions(fn):
    """--frac docfile: metadata with a weight column, or plain floats."""
    try:
        vals = MetaData(fn).getColumnValues("weight")
        if vals:
            return np.asarray(vals, np.float64)
    except Exception:
        pass
    return np.loadtxt(fn, dtype=np.float64).ravel()


def _load_stack_md(fn):
    """(images (n, H, W) float32, rows) of a metadata file (enabled rows)
    or of a stack (rows naming its slices)."""
    if is_metadata_file(fn):
        md = MetaData(fn)
        md.removeDisabled()
        rows = list(md.iterRows())
        return load_image_rows(rows), rows
    imgs = Image.read_stack(fn).astype(np.float32)
    return imgs, [{"image": f"{i + 1:06d}@{fn}", "itemId": i + 1}
                  for i in range(len(imgs))]


class ProgClassifyCL2D(MeshProgram):
    name = "xmipp_classify_CL2D"

    def defineParams(self):
        self.addUsageLine("Classify a set of images into a given number of "
                          "2D classes (CL2D).")
        self.addParamsLine("   -i <md_or_stack>  : Input images")
        self.addParamsLine("  [--odir <dir=.>]   : Output directory")
        self.addParamsLine("  [--oroot <root=class>] : Output rootname")
        self.addParamsLine("  [--nref <n=4>]     : Final number of classes")
        self.addParamsLine("  [--nref0 <n=1>]    : Initial number of code vectors")
        self.addParamsLine("  [--ref0 <selfile=\"\">] : Selfile with initial code vectors")
        self.addParamsLine("  [--iter <n=10>]    : Number of iterations")
        self.addParamsLine("  [--neigh <n=4>]    : Number of neighbour code vectors (-1 = all)")
        self.addParamsLine("  [--minsize <pct=20>] : Percentage minimum node size; smaller classes are re-split")
        self.addParamsLine("  [--distance <type=correntropy>] : Distance type")
        self.addParamsLine("         where <type>")
        self.addParamsLine("                  correntropy : robust Gaussian-kernel similarity (CL2D paper)")
        self.addParamsLine("                  correlation")
        self.addParamsLine("  [--classicalMultiref] : plain max-correlation instead of enhanced clustering")
        self.addParamsLine("  [--classicalSplit] : classical clustering at the split iterations only")
        self.addParamsLine("  [--maxSplitTrials <n=5>] : Maximum split trials before giving up")
        self.addParamsLine("  [--maxShift <s=8>] : Maximum shift (px)")
        self.addParamsLine("  [--classifyAllImages] : classify low-confidence images too (default marks them disabled)")
        self.addParamsLine("  [--dontNormalizeImages] : skip the 0-mean/1-std input normalization")
        self.addParamsLine("  [--dontMirrorImages] : Do not check mirrors")
        self.addParamsLine("     alias --dont_mirror;")
        self.addParamsLine("  [--useThresholdMask <t=0>] : ignore reference pixels <= t in the comparisons")
        self.addParamsLine("  [--dontAlign]      : do not center the class representatives")
        add_mesh_params(self)

    def readParams(self):
        self.device_arg = self.getParam("--device")
        self.fn_in = self.getParam("-i")
        self.odir = self.getParam("--odir")
        self.oroot = self.getParam("--oroot")
        self.n_refs = self.getIntParam("--nref")
        self.nref0 = self.getIntParam("--nref0")
        self.fn_ref0 = self.getParam("--ref0")
        self.n_iters = self.getIntParam("--iter")
        self.neigh = self.getIntParam("--neigh")
        self.minsize = self.getDoubleParam("--minsize")
        self.distance = self.getParam("--distance")
        self.classical = self.checkParam("--classicalMultiref")
        self.classical_split = self.checkParam("--classicalSplit")
        self.max_split_trials = self.getIntParam("--maxSplitTrials")
        self.max_shift = self.getIntParam("--maxShift")
        self.classify_all = self.checkParam("--classifyAllImages")
        self.normalize = not self.checkParam("--dontNormalizeImages")
        self.mirror = not self.checkParam("--dontMirrorImages")
        self.thr_mask = self.getDoubleParam("--useThresholdMask") \
            if self.checkParam("--useThresholdMask") else None
        self.align_refs = not self.checkParam("--dontAlign")
        read_mesh_params(self)

    def _run(self, mesh):
        from xmipp3_tpu_torch.models.cl2d import classify_cl2d
        with timed_phase("read images"):
            imgs, rows = _load_stack_md(self.fn_in)
            init_refs = _load_stack_md(self.fn_ref0)[0] if self.fn_ref0 \
                else None
        with timed_phase("classify"):
            res = classify_cl2d(
                imgs, self.n_refs, self.n_iters, self.max_shift,
                verbose=self.verbose, check_mirror=self.mirror, mesh=mesh,
                nref0=self.nref0, init_refs=init_refs,
                distance=self.distance, classical_multiref=self.classical,
                classical_split=self.classical_split,
                max_split_trials=self.max_split_trials,
                min_size_pct=self.minsize, normalize=self.normalize,
                threshold_mask=self.thr_mask, align_refs=self.align_refs,
                neigh=self.neigh, device=self.device)
        if self.writer:
            with timed_phase("write outputs"):
                self._write(res, rows)

    def _write(self, res, rows):
        root = os.path.join(self.odir, self.oroot)
        fn_refs = root + "_references.stk"
        save_image(fn_refs, res["refs"])
        # the reference default leaves low-confidence images unclassified
        # (enabled = -1); --classifyAllImages keeps them all
        corr = np.asarray(res["corr"])
        lo = corr.mean() - 3.0 * corr.std()
        out_rows = []
        for i, r in enumerate(rows):
            d = dict(r)
            d.update({"ref": int(res["assignments"][i]) + 1,
                      "anglePsi": float(res["psi"][i]),
                      "shiftX": float(res["sx"][i]),
                      "shiftY": float(res["sy"][i]),
                      "flip": int(res["flip"][i]),
                      "maxCC": float(res["corr"][i])})
            if not self.classify_all:
                d["enabled"] = 1 if corr[i] >= lo else -1
            out_rows.append(d)
        MetaData.fromRows(out_rows).write(root + "_images.xmd")
        MetaData.fromRows([
            {"ref": k + 1, "classCount": int((res["assignments"] == k).sum()),
             "image": f"{k + 1:06d}@{fn_refs}"}
            for k in range(self.n_refs)]).write(root + "_classes.xmd")
        # the reference's hierarchy (mpi_classify_CL2D.cpp writeResults):
        # <odir>/level_%02d/<root>_classes.xmd with a classes@ block and a
        # class%06d_images@ block per class, the layout that
        # classify_CL2D_core_analysis reads
        for lev, L in enumerate(res.get("levels", [])):
            lev_dir = os.path.join(self.odir, f"level_{lev:02d}")
            os.makedirs(lev_dir, exist_ok=True)
            fn_lvl_stk = os.path.join(lev_dir, self.oroot + "_classes.stk")
            save_image(fn_lvl_stk, np.asarray(L["refs"], np.float32))
            fn_lvl = os.path.join(lev_dir, self.oroot + "_classes.xmd")
            assign = np.asarray(L["assignments"])
            MetaData.fromRows([
                {"ref": k + 1, "classCount": int((assign == k).sum()),
                 "image": f"{k + 1:06d}@{fn_lvl_stk}"}
                for k in range(len(L["refs"]))]).write(fn_lvl,
                                                       block="classes")
            for k in range(len(L["refs"])):
                mrows = []
                for i in np.nonzero(assign == k)[0]:
                    d = dict(rows[i])
                    d.update({"ref": k + 1,
                              "anglePsi": float(L["psi"][i]),
                              "shiftX": float(L["sx"][i]),
                              "shiftY": float(L["sy"][i]),
                              "flip": int(L["flip"][i]),
                              "maxCC": float(L["corr"][i])})
                    mrows.append(d)
                MetaData.fromRows(mrows).write(
                    fn_lvl, block=f"class{k + 1:06d}_images", append=True)


class ProgMLAlign2D(MeshProgram):
    """Reference grammar: ml2d.cpp:226-302 (defineBasicParams /
    defineAdditionalParams / defineHiddenParams)."""
    name = "xmipp_ml_align2d"

    def defineParams(self):
        self.addUsageLine("Maximum-likelihood multi-reference 2D alignment "
                          "and classification (ML2D).")
        self.addParamsLine("   -i <md_or_stack>  : Input images")
        self.addParamsLine("  [--nref <n=4>]     : Number of references")
        self.addParamsLine("  [--ref <file=\"\">] : Initial reference image/"
                           "stack/metadata (overrides --nref)")
        self.addParamsLine("  [--oroot <root=ml2d>] : Output rootname")
        self.addParamsLine("  [--iter <n=15>]    : Maximum iterations")
        self.addParamsLine("  [--eps <e=5e-5>]   : Stopping criterium on "
                           "the log-likelihood change")
        self.addParamsLine("  [--maxShift <s=4>] : Translation search (px)")
        self.addParamsLine("  [--sigma <s=-1>]   : Initial noise sigma "
                           "(alias of --noise; <0 = estimate from data)")
        self.addParamsLine("  [--noise <s=-1>]   : Expected pixel-noise "
                           "stddev (<0 = estimate from data)")
        self.addParamsLine("  [--offset <s=3>]   : Expected origin-offset "
                           "stddev (px)")
        self.addParamsLine("  [--mirror]         : Also check the mirror "
                           "image of each reference")
        self.addParamsLine("  [--psi_step <d=-1>] : In-plane rotation "
                           "sampling interval (deg; <0 = full ring-FFT "
                           "resolution)")
        self.addParamsLine("  [--search_rot <d=999>] : Restrict in-plane "
                           "search to +-this angle (deg)")
        self.addParamsLine("  [--frac <docfile=\"\">] : Docfile with "
                           "expected model fractions")
        self.addParamsLine("  [-C <c=1e-12>]     : Significance criterion "
                           "(posterior cells below C x max are dropped)")
        self.addParamsLine("  [--fix_sigma_noise] : Do not re-estimate the "
                           "pixel-noise stddev")
        self.addParamsLine("  [--fix_sigma_offset] : Do not re-estimate the "
                           "origin-offset stddev")
        self.addParamsLine("  [--fix_fractions]  : Do not re-estimate the "
                           "model fractions")
        self.addParamsLine("  [--student <df=6>] : t-distributed instead of "
                           "Gaussian noise (df = degrees of freedom)")
        self.addParamsLine("  [--norm]           : Refine per-particle gray "
                           "normalization (a, b)")
        self.addParamsLine("  [--iem <blocks=1>] : Incremental EM over this "
                           "many blocks")
        self.addParamsLine("  [--no_iem]         : Plain (non-incremental) "
                           "EM")
        self.addParamsLine("  [--random_seed <s=-1>] : Seed for the initial "
                           "reference subsets")
        self.addParamsLine("  [--restart <iter=1>] : Restart from "
                           "<oroot>_references.stk / _classes.xmd")
        add_mesh_params(self)

    def readParams(self):
        self.device_arg = self.getParam("--device")
        self.fn_in = self.getParam("-i")
        self.n_refs = self.getIntParam("--nref")
        self.oroot = self.getParam("--oroot")
        self.n_iters = self.getIntParam("--iter")
        self.max_shift = self.getIntParam("--maxShift")
        sig = self.getDoubleParam("--sigma")
        if self.checkParam("--noise"):
            sig = self.getDoubleParam("--noise")
        self.sigma = sig if sig > 0 else None
        self.ml_kwargs = dict(
            eps=self.getDoubleParam("--eps"),
            offset_sigma=self.getDoubleParam("--offset"),
            mirror=self.checkParam("--mirror"),
            c_significance=self.getDoubleParam("-C")
            if self.checkParam("-C") else 0.0,
            fix_sigma_noise=self.checkParam("--fix_sigma_noise"),
            fix_sigma_offset=self.checkParam("--fix_sigma_offset"),
            fix_fractions=self.checkParam("--fix_fractions"),
            norm=self.checkParam("--norm"),
        )
        ps = self.getDoubleParam("--psi_step")
        if ps > 0:
            self.ml_kwargs["psi_step"] = ps
        sr = self.getDoubleParam("--search_rot")
        if sr < 360:
            self.ml_kwargs["search_rot"] = sr
        if self.checkParam("--student"):
            self.ml_kwargs["student_df"] = self.getDoubleParam("--student")
        if not self.checkParam("--no_iem"):
            blocks = self.getIntParam("--iem")
            if blocks > 1:
                self.ml_kwargs["iem_blocks"] = blocks
        seed = self.getIntParam("--random_seed")
        self.ml_kwargs["seed"] = seed if seed >= 0 else 0
        fn_ref = self.getParam("--ref")
        if self.checkParam("--restart"):
            fn_ref = self.oroot + "_references.stk"
            fn_cls = self.oroot + "_classes.xmd"
            if os.path.exists(fn_cls):
                self.ml_kwargs["fractions_init"] = np.asarray(
                    MetaData(fn_cls).getColumnValues("weight"), np.float64)
        if fn_ref:
            refs = Image.read_stack(fn_ref) if not is_metadata_file(fn_ref) \
                else load_image_rows(list(MetaData(fn_ref).iterRows()))
            self.ml_kwargs["refs_init"] = np.asarray(refs, np.float32)
        fn_frac = self.getParam("--frac")
        if fn_frac:
            self.ml_kwargs["fractions_init"] = _read_fractions(fn_frac)
        read_mesh_params(self)

    def _classify(self, mesh, imgs, **extra):
        from xmipp3_tpu_torch.models.ml2d import ml2d
        with timed_phase("classify"):
            res = ml2d(imgs, self.n_refs, self.n_iters, self.max_shift,
                       self.sigma, verbose=self.verbose, mesh=mesh,
                       device=self.device, **extra, **self.ml_kwargs)
        self.result = res
        return res

    def _run(self, mesh):
        with timed_phase("read images"):
            imgs, rows = _load_stack_md(self.fn_in)
        res = self._classify(mesh, imgs)
        if not self.writer:
            return
        with timed_phase("write outputs"):
            fn_refs = self.oroot + "_references.stk"
            save_image(fn_refs, res["refs"])
            out_rows = []
            for i, r in enumerate(rows):
                d = dict(r)
                d.update({"ref": int(res["assignments"][i]) + 1,
                          "anglePsi": float(res["psi"][i]),
                          "shiftX": float(res["sx"][i]),
                          "shiftY": float(res["sy"][i]),
                          "flip": int(res["flip"][i]),
                          "logLikelihood": float(res["loglike"][-1])})
                out_rows.append(d)
            MetaData.fromRows(out_rows).write(self.oroot + "_images.xmd")
            MetaData.fromRows([
                {"ref": k + 1, "weight": float(res["fractions"][k]),
                 "image": f"{k + 1:06d}@{fn_refs}"}
                for k in range(len(res["refs"]))]).write(
                self.oroot + "_classes.xmd")
        if self.verbose:
            print(f"final sigma={res['sigma']:.4f} "
                  f"sigma_offset={res['sigma_offset']:.4f}")


class ProgKerdensom(XmippProgram):
    name = "xmipp_classify_kerdensom"

    def defineParams(self):
        self.addUsageLine("Kernel-density self-organizing map classification "
                          "of vectors (kerdenSOM).")
        self.addParamsLine("   -i <md_file>  : Metadata with vectors (classificationData)")
        self.addParamsLine("  [--oroot <root=som>] : Output rootname")
        self.addParamsLine("  [--xdim <x=4>]  : SOM grid width")
        self.addParamsLine("  [--ydim <y=4>]  : SOM grid height")
        self.addParamsLine("  [--iter <n=100>] : Training iterations")
        self.addParamsLine("  [--reg0 <r=1000>] : Initial regularization")
        self.addParamsLine("  [--regF <r=100>]  : Final regularization")
        self.addParamsLine("  [--topology <topology=RECT>] : Lattice "
                           "topology: RECT or HEXA")
        self.addParamsLine("  [--deterministic_annealing <steps=10> "
                           "<Initial_reg=1000> <Final_reg=100>] : "
                           "Deterministic annealing schedule; 0 0 0 gives "
                           "kernel C-means")
        self.addParamsLine("  [--eps <epsilon=1e-7>] : Stopping criterion")
        self.addParamsLine("  [--norm] : Normalize input data")
        self.addParamsLine("  [--variant <v=kerdensom>] : kerdensom | som | batch_som | fuzzy_som (reference classification/ kerdensom, som, batch_som, fuzzy_som)")

    def readParams(self):
        self.device_arg = self.getParam("--device")
        self.fn_in = self.getParam("-i")
        self.oroot = self.getParam("--oroot")
        self.xdim = self.getIntParam("--xdim")
        self.ydim = self.getIntParam("--ydim")
        self.n_iters = self.getIntParam("--iter")
        self.reg0 = self.getDoubleParam("--reg0")
        self.regF = self.getDoubleParam("--regF")
        self.topology = self.getParam("--topology")
        if self.checkParam("--deterministic_annealing"):
            self.annealing_steps = self.getIntParam(
                "--deterministic_annealing", 0)
            self.reg0 = self.getDoubleParam("--deterministic_annealing", 1)
            self.regF = self.getDoubleParam("--deterministic_annealing", 2)
        else:
            self.annealing_steps = 0
        self.eps = self.getDoubleParam("--eps") \
            if self.checkParam("--eps") else 1e-7
        self.norm = self.checkParam("--norm")
        self.variant = self.getParam("--variant")

    def run(self):
        from xmipp3_tpu_torch.models.som import (batch_som, fuzzy_som,
                                                 kerdensom, som)
        dev = resolve_device(self.device_arg)
        with timed_phase("read vectors"):
            md = MetaData(self.fn_in)
            X = np.stack([np.asarray(v, np.float32)
                          for v in md.getColumnValues("classificationData")])
        if self.norm:
            # reference --norm: standardise the training vectors
            mu, sd = X.mean(axis=0), X.std(axis=0)
            X = (X - mu) / np.maximum(sd, 1e-12)
        shape = (self.ydim, self.xdim)
        with timed_phase("classify"):
            if self.variant == "som":
                code, assign = som(X, shape, self.n_iters, device=dev)
            elif self.variant == "batch_som":
                code, assign = batch_som(X, shape,
                                         max(self.n_iters // 5, 5),
                                         device=dev)
            elif self.variant == "fuzzy_som":
                code, U = fuzzy_som(X, shape, n_iters=self.n_iters,
                                    device=dev)
                assign = U.argmax(axis=1)
            else:
                code, assign = kerdensom(
                    X, shape, self.n_iters, self.reg0, self.regF,
                    verbose=self.verbose,
                    annealing_steps=self.annealing_steps, eps=self.eps,
                    topology=self.topology, device=dev)
        with timed_phase("write outputs"):
            rows = []
            for i in md:
                r = md.getRow(i)
                r["ref"] = int(assign[i]) + 1
                rows.append(r)
            MetaData.fromRows(rows).write(self.oroot + "_images.xmd")
            np.save(self.oroot + "_codebook.npy", code)


class ProgMLFAlign2D(ProgMLAlign2D):
    """MLF2D: ML2D with the Fourier-space per-resolution noise model
    (reference mlf_align2d.h:70). CTF handling (mlf_align2d.cpp defocus
    groups) is a per-defocus-group Wiener correction before the EM."""
    name = "xmipp_mlf_align2d"

    def defineParams(self):
        super().defineParams()
        self.addParamsLine("  [--no_ctf]         : Images are not CTF "
                           "affected (skip the defocus-group Wiener "
                           "correction)")
        self.addParamsLine("  [--not_phase_flipped] : Input was NOT phase "
                           "flipped (use the signed CTF in the correction)")
        self.addParamsLine("  [--sampling_rate <Tm=1>] : Pixel size "
                           "(Angstrom) for the CTF / resolution limits")
        self.addParamsLine("  [--limit_resolution <A=0>] : Low-pass the "
                           "data to this resolution (Angstrom; 0 = off)")
        self.addParamsLine("  [--include_allfreqs] : Use all frequencies "
                           "(no resolution limit)")
        self.addParamsLine("  [--search_shift <px=-1>] : Translation "
                           "search range (overrides --maxShift)")
        self.addParamsLine("  [--kstest]         : Kolmogorov-Smirnov "
                           "normality test on the whitened residuals each "
                           "iteration")
        self.addParamsLine("  [--iter_histogram] : Write the best-pose "
                           "residual histogram each run")

    def readParams(self):
        super().readParams()
        self.no_ctf = self.checkParam("--no_ctf")
        self.phase_flipped = not self.checkParam("--not_phase_flipped")
        self.sampling_rate = self.getDoubleParam("--sampling_rate")
        self.limit_resolution = 0.0 if self.checkParam("--include_allfreqs")\
            else self.getDoubleParam("--limit_resolution")
        ss = self.getDoubleParam("--search_shift")
        if ss >= 0:
            self.max_shift = int(ss)
        self.ml_kwargs["kstest"] = self.checkParam("--kstest")
        self.iter_histogram = self.checkParam("--iter_histogram")

    def _precorrect(self, imgs, rows):
        """Defocus-group Wiener CTF correction and the optional low-pass
        (mlf_align2d.cpp's defocus-group SNR handling as a pre-whitening),
        on the card; returns the images as a tensor there."""
        imgs = torch.as_tensor(imgs, device=self.device)
        if not self.no_ctf and rows and "ctfDefocusU" in rows[0]:
            from xmipp3_tpu_torch.ops.ctf import wiener_filter_2d
            from xmipp3_tpu_torch.programs.ctf_correct import _row_ctf
            groups = {}
            for i, r in enumerate(rows):
                key = (round(float(r.get("ctfDefocusU", 0.0)), -2),
                       round(float(r.get("ctfDefocusV", 0.0)), -2),
                       round(float(r.get("ctfDefocusAngle", 0.0)), 0))
                groups.setdefault(key, []).append(i)
            out = imgs.clone()
            for idx in groups.values():
                ctf = _row_ctf(rows[idx[0]], sampling=self.sampling_rate)
                sel = torch.as_tensor(idx, device=self.device)
                out[sel] = wiener_filter_2d(imgs[sel], ctf,
                                            phase_flipped=self.phase_flipped)
            imgs = out
            if self.verbose:
                print(f"CTF: Wiener-corrected {len(groups)} defocus "
                      f"group(s)")
        if self.limit_resolution > 0:
            from xmipp3_tpu_torch.ops.fourier_filter import (
                apply_fourier_mask_2d, low_pass_mask)
            H, W = imgs.shape[-2:]
            w1 = self.sampling_rate / self.limit_resolution
            imgs = apply_fourier_mask_2d(
                imgs, torch.as_tensor(low_pass_mask(H, W, w1),
                                      device=self.device))
        return imgs

    def _run(self, mesh):
        with timed_phase("read images"):
            imgs, rows = _load_stack_md(self.fn_in)
        with timed_phase("ctf correction"):
            imgs = self._precorrect(imgs, rows)
        res = self._classify(mesh, imgs, fourier_noise_model=True)
        if not self.writer:
            return
        with timed_phase("write outputs"):
            save_image(self.oroot + "_references.stk", res["refs"])
            out_rows = []
            for i, r in enumerate(rows):
                d = dict(r)
                d.update({"ref": int(res["assignments"][i]) + 1,
                          "flip": int(res["flip"][i]),
                          "logLikelihood": float(res["loglike"][-1])})
                out_rows.append(d)
            MetaData.fromRows(out_rows).write(self.oroot + "_images.xmd")
            if self.ml_kwargs.get("kstest") and res["kstest"]:
                MetaData.fromRows([
                    {"itemId": i + 1, "weight": float(v)}
                    for i, v in enumerate(res["kstest"])]).write(
                    self.oroot + "_kstest.xmd")
                if self.verbose:
                    print(f"KS statistic per iter: "
                          f"{[round(v, 4) for v in res['kstest']]}")
            if self.iter_histogram:
                from xmipp3_tpu_torch.ops.geo import apply_md_geometry
                reg = apply_md_geometry(
                    imgs, res["psi"], res["sx"], res["sy"],
                    res["flip"].astype(bool)).cpu().numpy()
                resid = (reg - res["refs"][res["assignments"]]).ravel()
                hist, edges = np.histogram(resid, bins=100)
                np.savetxt(self.oroot + "_histogram.txt",
                           np.c_[0.5 * (edges[1:] + edges[:-1]), hist])


PROGRAM = None
