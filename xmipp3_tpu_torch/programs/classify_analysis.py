"""Class analysis programs of the reference package's
programs/classify_analysis.py: xmipp_classify_evaluate_classes,
xmipp_classify_analyze_cluster, xmipp_classify_extract_features,
xmipp_classify_compare_classes, xmipp_classify_first_split,
xmipp_classify_first_split3, xmipp_volume_halves_restoration (with
--mesh), xmipp_volume_find_symmetry, xmipp_mpi_run and
xmipp_denoising_tv.

Each runs on the card unless `--device cpu` is given; mpi_run is a host
job farm of shell commands, as in the reference. first_split grids its
reconstructions through K3 (the kb window), first_split3 through K2
(trilinear).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import (XmippMetadataProgram,
                                                    is_metadata_file,
                                                    load_image_rows)
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import fp32_products, resolve_device
from xmipp3_tpu_torch.parallel.cli import (MeshProgram, add_mesh_params,
                                           read_mesh_params)
from xmipp3_tpu_torch.programs.classify import _load_stack_md


def _col(rows, key):
    return np.array([float(r.get(key, 0.0)) for r in rows], np.float32)


def _flips(rows):
    return np.array([bool(r.get("flip", 0)) for r in rows])


def _corr(a, b):
    """Pearson correlation of two tensors of equal size, float64 (the
    reference's np.corrcoef)."""
    a = a.reshape(-1).double()
    b = b.reshape(-1).double()
    a = a - a.mean()
    b = b - b.mean()
    return float((a * b).sum() / torch.sqrt((a * a).sum() * (b * b).sum()))


def _mask_file(prog, flag):
    """The binary mask of a `<type=binary_file> <file>` flag (voxels > 0.5),
    or None."""
    if prog.checkParam(flag) and prog.getParam(flag, 1):
        return np.squeeze(Image(prog.getParam(flag, 1)).data) > 0.5
    return None


class ProgClassifyEvaluateClasses(XmippProgram):
    name = "xmipp_classify_evaluate_classes"

    def defineParams(self):
        self.addUsageLine("Evaluate class quality: FRC-based resolution and "
                          "homogeneity of each 2D class.")
        self.addParamsLine("   -i <classes_md> : _images.xmd from a classification")
        self.addParamsLine("  [-o <md=\"\">]     : Output per-class metrics")

    def run(self):
        from xmipp3_tpu_torch.ops.fsc import frc_2d, fsc_resolution
        from xmipp3_tpu_torch.ops.geo import apply_md_geometry
        dev = resolve_device(self.getParam("--device"))
        md = MetaData(self.getParam("-i"))
        rows = list(md.iterRows())
        imgs = torch.as_tensor(load_image_rows(rows), device=dev)
        registered = apply_md_geometry(imgs, _col(rows, "anglePsi"),
                                       _col(rows, "shiftX"),
                                       _col(rows, "shiftY"), _flips(rows))
        refs = np.array([int(r.get("ref", 1)) for r in rows])
        out = []
        for k in sorted(set(refs)):
            members = registered[torch.as_tensor(refs == k, device=dev)]
            if len(members) < 2:
                continue
            freqs, frc = frc_2d(members[0::2].mean(dim=0),
                                members[1::2].mean(dim=0), device=dev)
            out.append({"ref": int(k), "classCount": int(len(members)),
                        "resolutionFreqReal": float(fsc_resolution(
                            freqs, frc, 0.5)),
                        "weight": float(len(members) / len(rows))})
        if self.checkParam("-o") and self.getParam("-o"):
            MetaData.fromRows(out).write(self.getParam("-o"))
        self.metrics = out
        if self.verbose:
            for m in out:
                print(f"class {m['ref']}: n={m['classCount']} "
                      f"res={m['resolutionFreqReal']:.2f}")


class ProgClassifyAnalyzeCluster(XmippProgram):
    name = "xmipp_classify_analyze_cluster"

    def defineParams(self):
        self.addUsageLine("Score the images in a cluster according to their "
                          "PCA projection (reference ProgAnalyzeCluster, "
                          "classification/analyze_cluster.cpp:30-45).")
        self.addParamsLine("   -i <md_file>  : Class members metadata")
        self.addParamsLine("  [--ref <img=\"\">] : if given, differences are "
                           "computed with respect to this representative")
        self.addParamsLine("  [-o <md=\"\">]   : Output with zScores")
        self.addParamsLine("  [--basis <stackName=\"\">] : write the average "
                           "(image 1), standard deviation (image 2) and the "
                           "PCA basis in a stack")
        self.addParamsLine("  [--NPCA <dim=2>] : PCA dimension")
        self.addParamsLine("  [--iter <N=10>] : Number of iterations")
        self.addParamsLine("  [--maxDist <d=3>] : Mahalanobis outlier "
                           "distance; -1 = keep all")
        self.addParamsLine("  [--dontMask]  : Don't use a circular mask")

    def run(self):
        from xmipp3_tpu_torch.models.dimred import empca
        dev = resolve_device(self.getParam("--device"))
        md = MetaData(self.getParam("-i"))
        rows = list(md.iterRows())
        imgs = load_image_rows(rows).astype(np.float64)
        n = imgs.shape[-1]
        if self.checkParam("--ref") and self.getParam("--ref"):
            imgs = imgs - np.squeeze(Image(self.getParam("--ref")).data) \
                .astype(np.float64)[None]
        mask = None
        if not self.checkParam("--dontMask"):
            yy, xx = np.mgrid[0:n, 0:n].astype(np.float64) - n // 2
            mask = (yy * yy + xx * xx) <= (n / 2) ** 2
            X = imgs[:, mask]
        else:
            X = imgs.reshape(len(imgs), -1)
        npca = max(min(self.getIntParam("--NPCA"), len(imgs) - 1), 1)
        # EM-PCA with --iter refinement steps (reference
        # PCAMahalanobisAnalyzer::learnPCABasis Niter), on the card
        Y, basis, _ = empca(X, d=npca, n_iters=self.getIntParam("--iter"),
                            return_basis=True, device=dev)
        # mahalanobis distance in PCA space
        dist = np.sqrt(((Y / (Y.std(axis=0) + 1e-12)) ** 2).mean(axis=1))
        thr = self.getDoubleParam("--maxDist")
        out = []
        for i, r in enumerate(rows):
            d = dict(r)
            d["zScore"] = float(dist[i])
            d["enabled"] = 1 if (thr < 0 or dist[i] <= thr) else -1
            out.append(d)
        if self.checkParam("-o") and self.getParam("-o"):
            MetaData.fromRows(out).write(self.getParam("-o"))
        if self.checkParam("--basis") and self.getParam("--basis"):
            # avg (1), std (2), then the NPCA basis images (reference
            # --basis stack contract)
            stack = np.zeros((2 + npca, n, n), np.float32)
            stack[0] = imgs.mean(axis=0)
            stack[1] = imgs.std(axis=0)
            for k in range(npca):
                if mask is not None:
                    stack[2 + k][mask] = basis[k]
                else:
                    stack[2 + k] = basis[k].reshape(n, n)
            save_image(self.getParam("--basis"), stack)
        self.distances = dist


# extractor flag -> (metadata label, function name in ops/features.py)
_EXTRACTORS = {
    "--entropy": ("scoreByEntropy", "extract_entropy"),
    "--granulo": ("scoreByGranulo", "extract_granulo"),
    "--histdist": ("scoreByHistDist", "extract_histdist"),
    "--lbp": ("scoreByLBP", "extract_lbp"),
    "--ramp": ("scoreByRamp", "extract_ramp"),
    "--variance": ("scoreByVariance", "extract_variance"),
    "--zernike": ("scoreByZernike", "extract_zernike"),
}


class ProgClassifyExtractFeatures(XmippProgram):
    """The reference's classify_extract_features (.h/.cpp): 7 selectable
    extractor families over translationally-centered (and optionally
    TV-denoised) images, each writing its own scoreBy* vector label; with
    no extractor flag, the rotation-invariant ring statistics under
    classificationData. Every extractor runs on the card."""
    name = "xmipp_classify_extract_features"

    def defineParams(self):
        self.addUsageLine("Extract feature vectors from images for "
                          "clustering/screening.")
        self.addParamsLine("   -i <md_or_stack> : Input images")
        self.addParamsLine("  [-o <md_file=\"\">] : Output metadata "
                           "(default: input)")
        self.addParamsLine("  [--applyDenoising] : TV-denoise before "
                           "extraction")
        self.addParamsLine("  [--entropy]        : Extract entropy features")
        self.addParamsLine("  [--granulo]        : Extract granulometry "
                           "features")
        self.addParamsLine("  [--histdist]       : Extract histogram "
                           "distances")
        self.addParamsLine("  [--lbp]            : Extract LBP features")
        self.addParamsLine("  [--ramp]           : Extract ramp coefficients")
        self.addParamsLine("  [--variance]       : Extract variance features")
        self.addParamsLine("  [--zernike]        : Extract Zernike moments")

    def run(self):
        from xmipp3_tpu_torch.ops import features as F
        dev = resolve_device(self.getParam("--device"))
        fn = self.getParam("-i")
        # the reference reads every row here, disabled ones too
        if is_metadata_file(fn):
            rows = list(MetaData(fn).iterRows())
            imgs = load_image_rows(rows)
        else:
            imgs, rows = _load_stack_md(fn)
        fn_out = (self.getParam("-o")
                  if self.checkParam("-o") and self.getParam("-o") else fn)
        imgs = torch.as_tensor(imgs, device=dev)
        chosen = [(lab, getattr(F, f)) for flag, (lab, f) in
                  _EXTRACTORS.items() if self.checkParam(flag)]
        if not chosen:
            # rotation-invariant ring statistics
            from xmipp3_tpu_torch.ops.polar import cartesian_to_polar
            pol = cartesian_to_polar(imgs, 2, imgs.shape[-1] // 2 - 2)
            cols = {"classificationData": torch.cat(
                [pol.mean(dim=2), pol.std(dim=2, correction=0)], dim=1).cpu().numpy()}
        else:
            with timed_phase("features", sync=imgs):
                proc = F.center_translationally(imgs)
                if self.checkParam("--applyDenoising"):
                    proc = F.tv_denoise_spg(proc)
                cols = {lab: f(proc).cpu().numpy() for lab, f in chosen}
        out = []
        for i, r in enumerate(rows):
            d = dict(r)
            for lab, vals in cols.items():
                d[lab] = vals[i].astype(np.float32)
            out.append(d)
        MetaData.fromRows(out).write(fn_out)
        self.features = cols


class ProgClassifyCompareClasses(XmippProgram):
    """Compare two classifications (reference classify_compare_classes.cpp
    :31-137): both inputs are multi-block class metadata files
    ('classes@f' with a ref column, one 'class%06d_images@f' block per
    class); the comparison matrix counts shared image names between every
    class pair, and the text report gives the percentage flow of each
    class of one classification into the classes of the other. --append
    appends the report to the output file. Host work, as in the
    reference."""
    name = "xmipp_classify_compare_classes"

    def defineParams(self):
        self.addUsageLine("Compare two classifications: which class of "
                          "classification 1 corresponds to which of 2.")
        self.addParamsLine("   --i1 <infile1> : Classification-1 metadata")
        self.addParamsLine("   --i2 <infile2> : Classification-2 metadata")
        self.addParamsLine("   -o <outfile>  : Output text file")
        self.addParamsLine("  [--append]     : Append text to output")

    @staticmethod
    def _read_classification(fn):
        md = MetaData(fn, block="classes")
        refs = [int(v) for v in md.getColumnValues("ref")]
        members = [set(str(v) for v in MetaData(
            fn, block=f"class{ref:06d}_images").getColumnValues("image"))
            for ref in refs]
        return refs, members

    def run(self):
        fn1, fn2 = self.getParam("--i1"), self.getParam("--i2")
        ref1, mem1 = self._read_classification(fn1)
        ref2, mem2 = self._read_classification(fn2)
        cmat = np.array([[len(m1 & m2) for m2 in mem2] for m1 in mem1],
                        np.int64)
        mode = "a" if self.checkParam("--append") else "w"
        with open(self.getParam("-o"), mode) as fh:
            if mode == "a":
                fh.write("\n\n" + "-" * 72 + "\n")
            fh.write(f"Comparison of {fn1} and {fn2}\n")
            fh.write(f"Analysis of {fn1} =======================\n")
            for i, ref in enumerate(ref1):
                n1 = max(len(mem1[i]), 1)
                fh.write(f"Class class{ref:06d}_images@{fn1}: "
                         f"{len(mem1[i])} images\n")
                for j in range(len(ref2)):
                    if cmat[i, j] > 0:
                        fh.write(f"   {100.0 * cmat[i, j] / n1}% are in "
                                 f"class class{j + 1:06d}_images@{fn2}\n")
            fh.write(f"\n\nAnalysis of {fn2} =======================\n")
            for j, ref in enumerate(ref2):
                n2 = max(len(mem2[j]), 1)
                fh.write(f"Class class{ref:06d}_images@{fn2}: "
                         f"{len(mem2[j])} images\n")
                for i in range(len(ref1)):
                    if cmat[i, j] > 0:
                        fh.write(f"   {100.0 * cmat[i, j] / n2}% are in "
                                 f"class class{i + 1:06d}_images@{fn1}\n")
        self.comparison_matrix = cmat


class ProgClassifyFirstSplit(XmippProgram):
    """Random-subset-reconstruction PCA split (reference
    classify_first_split.cpp:61-199): the average volume from the
    directional classes, then --Nrec reconstructions of random
    --Nsamples-image subsets with symmetry-randomized angles (--sym); the
    first principal axis of the (V - Vavg) differences (inside an optional
    --mask) and the --alpha/2, 1-alpha/2 quantiles of the projections on
    it give the two volumes v1/v2, with an x-mirror check of v2 by FRM
    alignment. The subsets and symmetry picks are numpy's Generator(0)
    draws of the reference package, so the subsets are its own.

    On the card: the average's views are gridded in one K3 launch, and the
    subsets share one reconstructor whose cubes are zeroed between them
    (each subset is one K3 launch); the differences, their Gram matrix and
    its eigenvector stay on the card. FRM failures are not caught: the
    reference package's FRM raises on no valid input."""
    name = "xmipp_classify_first_split"

    def defineParams(self):
        self.addUsageLine("Split a directional-class set into 2 volumes "
                          "along the first heterogeneity axis.")
        self.addParamsLine("   -i <metadata> : Directional classes with "
                           "angles")
        self.addParamsLine("  [--oroot <root=split>] : Output rootname")
        self.addParamsLine("  [--Nrec <n=100>]  : Number of reconstructions")
        self.addParamsLine("  [--Nsamples <n=8>] : Images per reconstruction")
        self.addParamsLine("  [--sym <sym=c1>]  : Symmetry")
        self.addParamsLine("  [--alpha <a=0.05>] : Quantile for the two "
                           "separated volumes")
        self.addParamsLine("  [--mask <type=binary_file> <file=\"\">] : "
                           "Restrict the PCA to this binary mask")

    def run(self):
        from xmipp3_tpu_torch.core.geometry import euler_matrix, \
            matrix_to_euler
        from xmipp3_tpu_torch.core.sym import SymList
        from xmipp3_tpu_torch.ops.frm import frm_align_volumes
        from xmipp3_tpu_torch.ops.geo import apply_affine_3d
        from xmipp3_tpu_torch.ops.reconstruct import (FourierReconstructor,
                                                      reconstruct_fourier)
        dev = resolve_device(self.getParam("--device"))
        md = MetaData(self.getParam("-i"))
        md.removeDisabled()
        rows = list(md.iterRows())
        with timed_phase("read images"):
            imgs = torch.as_tensor(load_image_rows(rows), device=dev)
        root = self.getParam("--oroot")
        n_rec = self.getIntParam("--Nrec")
        n_samp = min(self.getIntParam("--Nsamples"), len(rows))
        sym = self.getParam("--sym")
        alpha = self.getDoubleParam("--alpha")
        rot, tilt, psi = (_col(rows, k) for k in
                          ("angleRot", "angleTilt", "anglePsi"))
        sx, sy = _col(rows, "shiftX"), _col(rows, "shiftY")
        flip = _flips(rows)
        N = imgs.shape[-1]

        with timed_phase("average", sync=imgs):
            v_avg = reconstruct_fourier(imgs, rot, tilt, psi, sx, sy,
                                        flip=flip, sym=sym, max_freq=0.25,
                                        batch=len(rows), device=dev)
        save_image(root + "_avg.vol", v_avg.cpu().numpy())

        sym_mats = np.asarray(SymList(sym).sym_matrices())  # incl. identity
        mask = _mask_file(self, "--mask")
        mask = torch.ones(v_avg.shape, dtype=torch.bool, device=dev) \
            if mask is None else torch.as_tensor(mask, device=dev)

        rng = np.random.default_rng(0)
        rec = FourierReconstructor(N, sym="c1", max_freq=0.25, device=dev)
        diffs = torch.empty((n_rec, int(mask.sum())), device=dev)
        with timed_phase("subsets", sync=imgs):
            for n in range(n_rec):
                idx = rng.choice(len(rows), n_samp, replace=False)
                r_n, t_n, p_n = rot[idx].copy(), tilt[idx].copy(), \
                    psi[idx].copy()
                if len(sym_mats) > 1:
                    # symmetry-randomize the subset angles
                    # (classify_first_split.cpp:106-127 Euler_apply_transf)
                    pick = rng.integers(0, len(sym_mats), len(idx))
                    for j, s in enumerate(pick):
                        if s > 0:
                            E = euler_matrix(r_n[j], t_n[j], p_n[j])
                            r_n[j], t_n[j], p_n[j] = matrix_to_euler(
                                E @ sym_mats[s])
                for cube in (rec.data_r, rec.data_i, rec.weights):
                    cube.zero_()
                rec.add_batch(imgs[torch.as_tensor(idx, device=dev)], r_n,
                              t_n, p_n, sx[idx], sy[idx], flip=flip[idx])
                diffs[n] = (rec.finish() - v_avg)[mask]
                if self.verbose and (n + 1) % 20 == 0:
                    print(f"  reconstruction {n + 1}/{n_rec}")

        with timed_phase("pca", sync=diffs):
            mu = diffs.mean(dim=0)
            Xc = diffs - mu
            # first principal axis via the (Nrec x Nrec) gram matrix
            with fp32_products():
                _, U = torch.linalg.eigh(Xc @ Xc.T)
                c1 = Xc.T @ U[:, -1]
                c1 = c1 / torch.clamp(torch.linalg.vector_norm(c1),
                                      min=1e-12)
                zn = Xc @ c1
            zs = torch.sort(zn)[0].cpu().numpy()
        z1 = float(zs[int(alpha / 2 * n_rec)])
        z2 = float(zs[min(int((1 - alpha / 2) * n_rec), n_rec - 1)])
        if self.verbose:
            print(f"z1={z1:.4f} z2={z2:.4f}")

        base = v_avg.clone()
        base[mask] += mu
        c1_vol = torch.zeros_like(v_avg)
        c1_vol[mask] = c1
        v1 = base + z1 * c1_vol
        v2 = base + z2 * c1_vol
        save_image(root + "_v1.vol", v1.cpu().numpy())
        # mirror disambiguation (classify_first_split.cpp:176-194): if the
        # x-mirrored v2 aligns better to v1, keep the aligned mirror
        with timed_phase("mirror check", sync=v1):
            corr0 = _corr(v1, v2)
            v2m = v2.flip(2)
            M = frm_align_volumes(v1, v2m)
            v2m_al = apply_affine_3d(v2m, M[None])[0]
            corr_m = _corr(v1, v2m_al)
        if self.verbose:
            print(f"Correlation unmirrored: {corr0:.4f}\n"
                  f"Correlation   mirrored: {corr_m:.4f}")
        if corr_m > corr0:
            v2 = v2m_al
        save_image(root + "_v2.vol", v2.cpu().numpy())
        save_image(root + "_pc1.vol", (v1 - v2).cpu().numpy())
        self.v1, self.v2 = v1.cpu().numpy(), v2.cpu().numpy()
        self.zn = zn.cpu().numpy()


class ProgVolumeHalvesRestoration(MeshProgram):
    """The reference's volume_halves_restoration (.cpp:73-86): real-space
    significance denoising (--denoising), Fourier Gaussian deconvolution
    with per-half sigma Powell fits (--deconvolution), a
    probability-weighted frequency filter bank (--filterBank) and
    difference shrinkage (--difference), under an optional mask; engine
    ops/halves_restoration.py on the card. With --mesh dp the filter
    bank's bands are dealt to the ranks (parallel_filter_bank); every rank
    runs the other steps, rank 0 writes."""
    name = "xmipp_volume_halves_restoration"

    def defineParams(self):
        self.addUsageLine("Given two half maps (and an optional mask), "
                          "produce a better estimate of the volume.")
        self.addParamsLine("   --i1 <half1>  : Half map 1")
        self.addParamsLine("   --i2 <half2>  : Half map 2")
        self.addParamsLine("  [--oroot <root=volumeRestored>] : Output "
                           "rootname")
        self.addParamsLine("  [--denoising <N=0>] : Iterations of real-"
                           "space significance denoising")
        self.addParamsLine("  [--deconvolution <N=0> <sigma0=0.2> "
                           "<lambda=0.001>] : Iterations of Fourier "
                           "deconvolution, initial sigma and lambda")
        self.addParamsLine("  [--filterBank <step=0> <overlap=0.5> "
                           "<weightFun=1> <weightPower=3>] : Filter-bank "
                           "step (0,0.5), overlap (0,1), weight function "
                           "(0=mean, 1=min, 2=mean*diff) and weight power")
        self.addParamsLine("  [--difference <N=0> <K=1.5>] : Iterations "
                           "of real-space difference shrinkage and Kdiff")
        self.addParamsLine("  [--mask <type=binary_file> <file=\"\">] : "
                           "Restrict the estimate to a binary mask")
        add_mesh_params(self)

    def readParams(self):
        self.device_arg = self.getParam("--device")
        read_mesh_params(self)

    def _save(self, suffix, vol):
        if self.writer:
            save_image(self.getParam("--oroot") + suffix,
                       vol.cpu().numpy().astype(np.float32))

    def _run(self, mesh):
        from xmipp3_tpu_torch.ops import halves_restoration as hr
        dev = self.device
        read = lambda f: torch.as_tensor(np.squeeze(Image(
            self.getParam(f)).data).astype(np.float32), device=dev)
        v1r, v2r = read("--i1"), read("--i2")
        shape = tuple(v1r.shape)
        n_real = self.getIntParam("--denoising")
        n_four, sigma0, lam = (self.getIntParam("--deconvolution", 0),
                               self.getDoubleParam("--deconvolution", 1),
                               self.getDoubleParam("--deconvolution", 2))
        bank_step, bank_overlap, weight_fun, weight_power = (
            self.getDoubleParam("--filterBank", 0),
            self.getDoubleParam("--filterBank", 1),
            self.getIntParam("--filterBank", 2),
            self.getDoubleParam("--filterBank", 3))
        n_diff, kdiff = (self.getIntParam("--difference", 0),
                         self.getDoubleParam("--difference", 1))
        m = _mask_file(self, "--mask")
        mask = torch.ones(shape, device=dev) if m is None else \
            torch.as_tensor(m.astype(np.float32), device=dev)
        r2 = torch.as_tensor(hr.make_r2(shape), device=dev)

        with timed_phase("denoising", sync=v1r):
            for it in range(n_real):
                if self.verbose:
                    print(f"Denoising iteration {it}")
                s, cdf_s, n_valid = hr.estimate_s(v1r, v2r, mask, r2, shape)
                v1r = hr.significance_real_space(v1r, s, cdf_s, n_valid)
                v2r = hr.significance_real_space(v2r, s, cdf_s, n_valid)

        if n_four > 0:
            with timed_phase("deconvolution", sync=v1r):
                sig1 = sig2 = sigma0
                for it in range(n_four):
                    if self.verbose:
                        print(f"Deconvolution iteration {it}")
                    s, _, _ = hr.estimate_s(v1r, v2r, mask, r2, shape)
                    f_s, f_v1, f_v2 = hr.forward_ffts(s, v1r, v2r, shape)
                    sig1, sig2 = hr.optimize_sigma(f_s, f_v1, f_v2, r2,
                                                   sig1, sig2)
                    if self.verbose:
                        print(f"   Deconvolving with sigma={sig1} {sig2}")
                    f_vol, v1r, v2r = hr.deconvolve_s(
                        f_s, f_v1, f_v2, r2, lam, sig1, sig2, shape)
            self._save("_deconvolved.vol", s)
            self._save("_convolved.vol", hr.convolve_s(
                f_vol, r2, 0.5 * (sig1 + sig2), shape))

        if bank_step > 0:
            with timed_phase("filter bank", sync=v1r):
                if mesh is not None:
                    from xmipp3_tpu_torch.parallel.engines import \
                        parallel_filter_bank
                    v1r, v2r, s_bank = parallel_filter_bank(
                        mesh, v1r, v2r, r2, shape, float(bank_step),
                        float(bank_overlap), int(weight_fun),
                        float(weight_power))
                else:
                    v1r, v2r, s_bank = hr.filter_bank(
                        v1r, v2r, r2, shape, float(bank_step),
                        float(bank_overlap), int(weight_fun),
                        float(weight_power))
            self._save("_filterBank.vol", s_bank)

        for it in range(n_diff):
            if self.verbose:
                print(f"Difference iteration {it}")
            v1r, v2r = hr.evaluate_difference(v1r, v2r, mask, kdiff)
        if n_diff > 0:
            self._save("_avgDiff.vol", 0.5 * (v1r + v2r))
        self._save("_restored1.vol", v1r)
        self._save("_restored2.vol", v2r)
        self.restored = (0.5 * (v1r + v2r)).cpu().numpy()


class ProgVolumeFindSymmetry(XmippProgram):
    """The reference's volume_find_symmetry (.cpp:30-429): grid or local
    Powell search for a rotational symmetry axis (--sym rot n over
    --rot/--tilt or --localRot), or for helical parameters (--sym
    helical|helicalDihedral over --rotHelical x -z, with --sym2 Cn,
    --heightFraction, --sampling, --localHelical), writing the (rot x z)
    correlation map to <o>.xmp. The grid's candidates are warped and
    scored on the card, its argmax read once; --useSplines warps on the
    host with scipy, as in the reference package. --thr is declared and
    never read there; the port refuses a value other than 1 (ROADMAP.md
    section 3, item 17)."""
    name = "xmipp_volume_find_symmetry"

    def defineParams(self):
        self.addUsageLine("Find a symmetry rotational axis or helical "
                          "parameters.")
        self.addParamsLine("   -i <volume>  : Input volume")
        self.addParamsLine("  [-o <md=\"\">]  : Output metadata")
        self.addParamsLine("   --sym <mode> <n=2> : rot <n> | helical | "
                           "helicalDihedral")
        self.addParamsLine("  [--sym2 <Cn=C1>] : Additional Cn symmetry "
                           "(helical modes)")
        self.addParamsLine("  [--rot <rot0=0> <rotF=355> <step=5>] : "
                           "Rotational-angle search range")
        self.addParamsLine("  [--tilt <tilt0=0> <tiltF=90> <step=5>] : "
                           "Tilt-angle search range")
        self.addParamsLine("  [--localRot <rot0> <tilt0>] : Local search "
                           "around this axis")
        self.addParamsLine("  [--useSplines] : Cubic B-spline interpolation")
        self.addParamsLine("  [-z <z0=1> <zF=10> <zstep=0.5>] : Helical "
                           "z-shift search range (Angstroms)")
        self.addParamsLine("  [--sampling <T=1>] : Sampling rate (A/pix)")
        self.addParamsLine("  [--rotHelical <rot0=-357> <rotF=357> "
                           "<step=3>] : Helical rotation search range")
        self.addParamsLine("  [--localHelical <z> <rot>] : Local search "
                           "around this helical parameter pair")
        self.addParamsLine("  [--heightFraction <f=1>] : Use this fraction "
                           "of the volume height")
        self.addParamsLine("  [--mask <type=circular> <R=-1>] : Restrict "
                           "the comparison to a mask area")
        self.addParamsLine("  [--thr <N=1>] : Host threads (device batching "
                           "replaces the thread pool)")

    # candidates warped together on the grid search
    AXIS_CHUNK = 16

    def _mask(self, vol):
        from xmipp3_tpu_torch.ops.mask import circular_mask
        m = np.ones(vol.shape, np.float32)
        if self.checkParam("--mask"):
            r = self.getDoubleParam("--mask", 1)
            m = circular_mask(vol.shape, None if r == -1 else abs(r))
        return torch.as_tensor(m, device=self.dev)

    @staticmethod
    def _axis_mats(rot, tilt, order_n):
        """(order_n - 1, 3, 3) rotations by 360/n * k about the (rot, tilt)
        axis (Rodrigues), float64 numpy."""
        from xmipp3_tpu_torch.core.geometry import euler_matrix
        axis = np.asarray(euler_matrix(rot, tilt, 0.0))[2]
        kx, ky, kz = axis / max(np.linalg.norm(axis), 1e-12)
        K = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]])
        a = np.deg2rad(360.0 / order_n * np.arange(1, order_n))
        return (np.eye(3) + np.sin(a)[:, None, None] * K
                + (1 - np.cos(a))[:, None, None] * (K @ K))

    def _axis_corrs(self, vol, mask, axes, order_n, use_splines):
        """Correlation of the volume with its n-fold symmetrized copy about
        each (rot, tilt) of `axes`, inside mask: a (len(axes),) tensor."""
        from xmipp3_tpu_torch.ops.geo import apply_affine_3d
        m = mask > 0
        a = vol[m] - vol[m].mean()
        out = []
        for c in range(0, len(axes), self.AXIS_CHUNK):
            part = axes[c:c + self.AXIS_CHUNK]
            mats = np.concatenate([self._axis_mats(r, t, order_n)
                                   for r, t in part])
            if use_splines:
                from scipy.ndimage import affine_transform
                v = vol.cpu().numpy()
                ctr = np.asarray(v.shape) // 2
                warped = []
                for R in mats:
                    Rz = np.linalg.inv(R[::-1, ::-1])  # (z,y,x) index order
                    warped.append(affine_transform(
                        v, Rz, offset=ctr - Rz @ ctr, order=3,
                        mode="constant"))
                warped = torch.as_tensor(np.stack(warped), device=vol.device)
            else:
                warped = apply_affine_3d(vol, mats.astype(np.float32))
            vsym = vol + warped.reshape(len(part), order_n - 1,
                                        *vol.shape).sum(dim=1)
            b = vsym[:, m]
            b = b - b.mean(dim=1, keepdim=True)
            out.append((a * b).sum(dim=1) / torch.clamp(
                torch.linalg.vector_norm(a)
                * torch.linalg.vector_norm(b, dim=1), min=1e-12))
        return torch.cat(out)

    def run(self):
        self.refuse_unread("--thr", item=17)
        self.dev = resolve_device(self.getParam("--device"))
        vol = torch.as_tensor(np.squeeze(Image(self.getParam("-i")).data)
                              .astype(np.float32), device=self.dev)
        mask = self._mask(vol)
        mode = self.getParam("--sym")
        fn_out = self.getParam("-o") if self.checkParam("-o") else ""
        if mode in ("helical", "helicalDihedral"):
            self._run_helical(vol, mask, mode == "helicalDihedral", fn_out)
            return
        order_n = self.getIntParam("--sym", 1)
        use_splines = self.checkParam("--useSplines")
        with timed_phase("axis search", sync=vol):
            if self.checkParam("--localRot"):
                from scipy.optimize import minimize
                p0 = [self.getDoubleParam("--localRot", 0),
                      self.getDoubleParam("--localRot", 1)]
                res = minimize(lambda p: -float(self._axis_corrs(
                    vol, mask, [(p[0], p[1])], order_n, use_splines)[0]),
                    p0, method="Powell", options={"xtol": 0.01})
                best_rot, best_tilt = float(res.x[0]), float(res.x[1])
                best_corr = -float(res.fun)
            else:
                rng = lambda f: np.arange(self.getDoubleParam(f, 0),
                                          self.getDoubleParam(f, 1) + 1e-6,
                                          self.getDoubleParam(f, 2))
                axes = [(float(r), float(t)) for r in rng("--rot")
                        for t in rng("--tilt")]
                corrs = self._axis_corrs(vol, mask, axes, order_n,
                                         use_splines)
                k = int(torch.argmax(corrs))     # the first maximum
                best_rot, best_tilt = axes[k]
                best_corr = float(corrs[k])
        from xmipp3_tpu_torch.core.geometry import euler_matrix
        axis = np.asarray(euler_matrix(best_rot, best_tilt, 0.0))[2]
        self.best_rot, self.best_tilt = best_rot, best_tilt
        self.best_corr = best_corr
        if self.verbose:
            print(f"Symmetry axis (rot,tilt)= {best_rot} {best_tilt} --> "
                  f"{axis}")
        if fn_out:
            MetaData.fromRows([{"angleRot": best_rot,
                                "angleTilt": best_tilt,
                                "direction": np.asarray(axis, float)}]
                              ).write(fn_out)

    def _run_helical(self, vol, mask, dihedral, fn_out):
        from xmipp3_tpu_torch.ops.helical import (helical_correlation,
                                                  helical_correlation_grid)
        Ts = self.getDoubleParam("--sampling")
        hf = self.getDoubleParam("--heightFraction")
        cn = int(self.getParam("--sym2").lstrip("Cc") or 1)
        with timed_phase("helical search", sync=vol):
            if self.checkParam("--localHelical"):
                from scipy.optimize import minimize
                z_loc = self.getDoubleParam("--localHelical", 0) / Ts
                rot_loc = self.getDoubleParam("--localHelical", 1)
                l_max = int(np.ceil(vol.shape[0] / max(z_loc * 0.5, 0.5)))
                res = minimize(lambda p: -float(helical_correlation(
                    vol, max(p[0], 0.1), p[1], cn=cn, dihedral=dihedral,
                    height_fraction=hf, mask=mask, l_max=l_max)),
                    [z_loc, rot_loc], method="Powell",
                    options={"xtol": 0.01})
                best_z, best_rot = float(res.x[0]), float(res.x[1])
                best_corr = -float(res.fun)
                cmap = None
            else:
                zs = np.arange(self.getDoubleParam("-z", 0),
                               self.getDoubleParam("-z", 1) + 1e-6,
                               self.getDoubleParam("-z", 2)) / Ts
                zs = zs[zs > 0]
                rots = np.arange(self.getDoubleParam("--rotHelical", 0),
                                 self.getDoubleParam("--rotHelical", 1)
                                 + 1e-6,
                                 self.getDoubleParam("--rotHelical", 2))
                cmap = helical_correlation_grid(
                    vol, zs, rots, cn=cn, dihedral=dihedral,
                    height_fraction=hf, mask=mask).cpu().numpy()
                ri, zi = np.unravel_index(np.argmax(cmap), cmap.shape)
                best_rot, best_z = float(rots[ri]), float(zs[zi])
                best_corr = float(cmap[ri, zi])
        self.best_z, self.best_rot = best_z * Ts, best_rot
        self.best_corr = best_corr
        if self.verbose:
            print(f"Symmetry parameters (z,rot)= {best_z * Ts} {best_rot} "
                  f"correlation={best_corr}")
        if fn_out:
            MetaData.fromRows([{"angleRot": best_rot,
                                "shiftZ": best_z * Ts}]).write(fn_out)
            if cmap is not None:
                save_image(os.path.splitext(fn_out)[0] + ".xmp",
                           cmap.astype(np.float32))


class ProgMpiRun(XmippProgram):
    """A file of shell command lines run by -j host workers (the job-farm
    role of the reference's mpi_run, parallel/mpi_run.cpp:80-160). A
    failing command fails the program once all have run."""
    name = "xmipp_mpi_run"

    def defineParams(self):
        self.addUsageLine("Execute a file of shell command lines, "
                          "distributing them over host workers (the job-farm "
                          "role of the reference's mpi_run).")
        self.addParamsLine("   -i <commands_file> : One shell command per line")
        self.addParamsLine("  [-j <threads=4>]    : Concurrent workers")

    def run(self):
        import concurrent.futures
        import subprocess
        with open(self.getParam("-i")) as f:
            cmds = [l.strip() for l in f
                    if l.strip() and not l.strip().startswith("#")]

        def exec_one(cmd):
            r = subprocess.run(cmd, shell=True, capture_output=True,
                               text=True)
            return cmd, r.returncode, r.stderr[-500:]

        failures = []
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=self.getIntParam("-j")) as pool:
            for cmd, rc, err in pool.map(exec_one, cmds):
                if rc != 0:
                    failures.append((cmd, rc, err))
                if self.verbose:
                    print(f"[{'ok' if rc == 0 else 'FAIL'}] {cmd}")
        self.n_failed = len(failures)
        if failures:
            raise XmippError(ErrCode.UNCLASSIFIED,
                             f"{len(failures)}/{len(cmds)} commands failed")


class ProgDenoisingTV(XmippMetadataProgram):
    """Total-variation denoising of images by Chambolle's dual projection
    (ops/denoise.py::tv_denoise_2d), a batch at a time on the card."""
    name = "xmipp_denoising_tv"

    def defineProcessParams(self):
        self.addUsageLine("Total-variation denoising of images "
                          "(Chambolle dual projection).")
        self.addParamsLine(" [--weight <w=0.1>] : Regularization strength")
        self.addParamsLine(" [--iter <n=50>]    : Iterations")

    def readProcessParams(self):
        self.weight = self.getDoubleParam("--weight")
        self.iters = self.getIntParam("--iter")

    def processBatch(self, imgs, rows):
        from xmipp3_tpu_torch.ops.denoise import tv_denoise_2d
        return tv_denoise_2d(imgs, self.weight, self.iters,
                             device=self.device)


class ProgClassifyFirstSplit3(XmippProgram):
    """First volume split of directional classes by stochastic 2-volume
    K-means (reference classify_first_split3.cpp: random initial split,
    reconstruct both halves, swap members whose projections correlate
    better with the other volume, with a decaying random-swap rate). As in
    the reference package, every sweep scores ALL members against BOTH
    volumes, swaps a balanced set of the strongest misfits plus a random
    fraction, and re-reconstructs; the random draws are its Generator(0)
    draws.

    On the card: each half is gridded in one K2 launch (interp tri) with
    the members weighted 1 and the rest 0, so both halves grid every view
    (adding zero changes no accumulator); the registration of the views is
    done once; the projections, correlations and the balanced swap stay on
    the card. The host reads the membership once a sweep, for the random
    swaps. --mask is declared and never read in the reference package
    ("accepted"); the port refuses a value (ROADMAP.md section 3,
    item 17)."""
    name = "xmipp_classify_first_split3"

    def defineParams(self):
        self.addUsageLine("Produce a first volume split from a set of "
                          "directional classes using K-means.")
        self.addParamsLine("   -i <metadata>  : Directional classes with angles")
        self.addParamsLine("  [--oroot <fnroot=split>] : Output rootname")
        self.addParamsLine("  [--Niter <n=5000>] : Reference-equivalent iteration count (mapped to batched sweeps)")
        self.addParamsLine("  [--sym <sym=c1>]   : Symmetry")
        self.addParamsLine("  [--mask <m=\"\">]   : (accepted; mask applied upstream)")

    def _reconstruct(self, sel):
        from xmipp3_tpu_torch.ops.reconstruct import FourierReconstructor
        rec = FourierReconstructor(self.imgs.shape[-1],
                                   sym=self.getParam("--sym"),
                                   max_freq=0.25, interp="tri",
                                   device=self.imgs.device)
        rows = self.rows
        rec.add_batch(self.imgs, _col(rows, "angleRot"),
                      _col(rows, "angleTilt"), _col(rows, "anglePsi"),
                      _col(rows, "shiftX"), _col(rows, "shiftY"),
                      weights=sel.astype(np.float32), flip=_flips(rows))
        return rec.finish()

    def _correlations(self, vol):
        from xmipp3_tpu_torch.ops.project import FourierProjector
        rows = self.rows
        P = FourierProjector(vol, device=vol.device).project_euler(
            _col(rows, "angleRot"), _col(rows, "angleTilt"),
            _col(rows, "anglePsi"))
        a = P - P.mean(dim=(1, 2), keepdim=True)
        b = self.reg_c
        num = (a * b).sum(dim=(1, 2))
        den = torch.sqrt((a ** 2).sum(dim=(1, 2)) * (b ** 2).sum(dim=(1, 2)))
        return num / torch.clamp(den, min=1e-12)

    def run(self):
        from xmipp3_tpu_torch.ops.geo import apply_md_geometry
        self.refuse_unread("--mask", item=17)
        dev = resolve_device(self.getParam("--device"))
        rng = np.random.default_rng(0)
        md = MetaData(self.getParam("-i"))
        md.removeDisabled()
        self.rows = rows = list(md.iterRows())
        with timed_phase("read images"):
            self.imgs = torch.as_tensor(load_image_rows(rows), device=dev)
        B = len(rows)
        reg = apply_md_geometry(self.imgs, np.zeros(B, np.float32),
                                _col(rows, "shiftX"), _col(rows, "shiftY"),
                                flip=_flips(rows))
        self.reg_c = reg - reg.mean(dim=(1, 2), keepdim=True)
        sel1 = rng.random(B) < 0.5
        if sel1.all() or not sel1.any():
            sel1[: B // 2] = True
            sel1[B // 2:] = False
        sweeps = max(3, min(12, self.getIntParam("--Niter") // 500))
        th = 0.05
        swapped_total = 0
        rank = torch.empty(B, dtype=torch.int64, device=dev)
        arange = torch.arange(B, device=dev)
        self.sweeps_run = 0
        for it in range(sweeps):
            with timed_phase("sweeps", sync=self.imgs):
                c1 = self._correlations(self._reconstruct(sel1))
                c2 = self._correlations(self._reconstruct(~sel1))
                s1 = torch.as_tensor(sel1, device=dev)
                want2 = s1 & (c2 > c1)      # in set1, prefers v2
                want1 = ~s1 & (c1 > c2)
                k = torch.minimum(want2.sum(), want1.sum())
                # the k strongest misfits of each side change sides
                moves = []
                for want, gain in ((want2, c2 - c1), (want1, c1 - c2)):
                    order = torch.argsort(
                        torch.where(want, gain, -torch.inf),
                        descending=True, stable=True)
                    rank[order] = arange
                    moves.append(rank < k)
                s1 = (s1 & ~moves[0]) | moves[1]
                # the one host read of the sweep
                state = torch.cat([s1.to(torch.int64), k[None]]).cpu().numpy()
            sel1, k = state[:B].astype(bool), int(state[B])
            moved = 2 * k
            # decaying random swap (reference th=0.05 exploratory swaps)
            nrand = max(int(th * B * (1 - it / sweeps)), 0)
            if nrand:
                i1 = np.flatnonzero(sel1)
                i2 = np.flatnonzero(~sel1)
                if len(i1) > nrand and len(i2) > nrand:
                    sw1 = rng.choice(i1, nrand, replace=False)
                    sw2 = rng.choice(i2, nrand, replace=False)
                    sel1[sw1] = False
                    sel1[sw2] = True
                    moved += 2 * nrand
            swapped_total += moved
            self.sweeps_run += 1
            if self.verbose:
                print(f"  sweep {it + 1}/{sweeps}: set1={int(sel1.sum())} "
                      f"set2={int((~sel1).sum())} moved={moved}")
            if moved == 0:
                break
        root = self.getParam("--oroot")
        with timed_phase("final volumes", sync=self.imgs):
            v1 = self._reconstruct(sel1).cpu().numpy()
            v2 = self._reconstruct(~sel1).cpu().numpy()
        save_image(root + "_avg1.vol", v1)
        save_image(root + "_avg2.vol", v2)
        MetaData.fromRows([rows[i] for i in np.flatnonzero(sel1)]).write(
            root + "_avg1.xmd")
        MetaData.fromRows([rows[i] for i in np.flatnonzero(~sel1)]).write(
            root + "_avg2.xmd")
        self.sel1 = sel1
        if self.verbose:
            print(f"split: {int(sel1.sum())} / {int((~sel1).sum())} "
                  f"(total moves {swapped_total})")


PROGRAM = None  # registered individually
