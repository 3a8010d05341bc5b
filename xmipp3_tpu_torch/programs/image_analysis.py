"""Image analysis and screening programs of the reference package's
programs/image_analysis.py: xmipp_image_vectorize, xmipp_image_sort,
xmipp_image_sort_by_statistics, xmipp_image_find_center, xmipp_image_ssnr,
xmipp_image_eliminate_empty_particles, xmipp_matrix_dimred,
xmipp_image_rotational_pca (with --mesh) and
xmipp_image_eliminate_byEnergy.

Each runs on the card unless `--device cpu` is given. Metadata and text
files are read and written on the host, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import (is_metadata_file,
                                                    load_image_rows)
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import resolve_device
from xmipp3_tpu_torch.parallel.cli import (MeshProgram, add_mesh_params,
                                           read_mesh_params)
from xmipp3_tpu_torch.programs.classify import _load_stack_md as _load


class ProgImageVectorize(XmippProgram):
    name = "xmipp_image_vectorize"

    def defineParams(self):
        self.addUsageLine("Convert images <-> metadata vectors "
                          "(classificationData).")
        self.addParamsLine("   -i <input>  : Images (stack/md) or vector metadata")
        self.addParamsLine("   -o <output> : Vector metadata or image stack")
        self.addParamsLine("  [--mask <m=\"\">] : Only pixels inside this mask")

    def run(self):
        fn_in, fn_out = self.getParam("-i"), self.getParam("-o")
        if fn_out.endswith((".xmd", ".star")):
            imgs, rows = _load(fn_in)
            mask = None
            if self.checkParam("--mask") and self.getParam("--mask"):
                mask = np.squeeze(Image(self.getParam("--mask")).data) > 0.5
            out_rows = []
            for i, r in enumerate(rows):
                vec = imgs[i][mask] if mask is not None else imgs[i].ravel()
                d = dict(r)
                d["classificationData"] = vec.astype(np.float32)
                d["classificationDataSize"] = len(vec)
                out_rows.append(d)
            MetaData.fromRows(out_rows).write(fn_out)
        else:
            md = MetaData(fn_in)
            vecs = [np.asarray(v, np.float32)
                    for v in md.getColumnValues("classificationData")]
            n = int(np.sqrt(len(vecs[0])))
            save_image(fn_out, np.stack(vecs).reshape(len(vecs), n, n))


class ProgImageSortChain(XmippProgram):
    """The reference's greedy similarity chain (parallel/mpi_image_sort.cpp
    :85-260): from the first image, align every remaining image to the
    LAST image of the chain (mirror-aware, circular mask) and append the
    best-correlated one, centering the images first unless told not to.
    Writes <oroot>.stk (the aligned chain) and <oroot>.xmd (imageOriginal
    and the correlation with the predecessor, maxCC).

    On the card the N - 1 steps run without reading the host. The
    remaining images are the first N - j entries of a permutation kept on
    the card (its length is known on the host at every step, its entries
    are not): a step aligns those images to the chain's last image, and
    the chosen one swaps places with the last remaining entry. The chain's
    order, correlations and images are written into tensors on the card
    and read once at the end."""
    name = "xmipp_image_sort"

    def defineParams(self):
        self.addUsageLine("Sort a set of images by gradually increasing "
                          "dissimilarity to a growing aligned chain.")
        self.addParamsLine("   -i <selfile>       : Selfile of images")
        self.addParamsLine("   --oroot <rootname> : Output rootname "
                           "(.stk aligned chain + .xmd bookkeeping)")
        self.addParamsLine("  [--dont_center]     : Do not center images "
                           "as they are sorted")

    def run(self):
        from xmipp3_tpu_torch.ops.align import align_considering_mirrors
        from xmipp3_tpu_torch.ops.features import center_translationally
        from xmipp3_tpu_torch.ops.mask import circular_mask
        dev = resolve_device(self.getParam("--device"))
        md = MetaData(self.getParam("-i"))
        rows = list(md.iterRows())
        if rows and "classCount" in rows[0]:
            rows = [r for r in rows if int(r.get("classCount", 1)) > 0]
        with timed_phase("read images"):
            imgs = torch.as_tensor(load_image_rows(rows).astype(np.float32),
                                   device=dev)
        N, H, W = imgs.shape
        mask = torch.as_tensor(circular_mask((H, W), W / 2.0), device=dev)
        with timed_phase("sort", sync=imgs):
            if not self.checkParam("--dont_center"):
                imgs = center_translationally(imgs)
            order = torch.zeros(N, dtype=torch.int64, device=dev)
            ccs = torch.ones(N, device=dev)
            chain = torch.empty_like(imgs)
            chain[0] = imgs[0]
            # remaining images: perm[:N - j] before step j
            perm = torch.arange(1, N + 1, device=dev) % N
            for j in range(1, N):
                rest = perm[:N - j]
                _, _, _, _, corr, aligned = align_considering_mirrors(
                    chain[j - 1] * mask, imgs[rest], n_iters=3)
                k = torch.argmax(corr)
                order[j] = rest[k]
                ccs[j] = corr[k]
                chain[j] = aligned[k]
                swap = torch.stack([k, torch.full_like(k, N - j - 1)])
                perm[swap] = perm[swap.flip(0)]
            order, ccs = order.cpu().numpy(), ccs.cpu().numpy()
            chain = chain.cpu().numpy()
        if self.verbose:
            for j in range(1, N):
                print(f"Images to go={N - 1 - j} current "
                      f"correlation= {ccs[j]:.4f}")
        root = self.getParam("--oroot")
        save_image(root + ".stk", chain)
        out_rows = []
        for j, (idx, cc) in enumerate(zip(order, ccs)):
            d = dict(rows[idx])
            d["imageOriginal"] = str(d.get("image", ""))
            d["image"] = f"{j + 1:06d}@{root}.stk"
            d["maxCC"] = float(cc)
            out_rows.append(d)
        MetaData.fromRows(out_rows).write(root + ".xmd")
        self.order = [int(i) for i in order]
        self.ccs = [float(c) for c in ccs]


class ProgImageSortByStatistics(XmippProgram):
    """Multivariate outlier z-scores over intensity and shape statistics
    (reference image_sort_by_statistics.cpp:55-82): optional training set
    (-t) fixing the feature statistics, --percent / --zcut disabling,
    --dim pre-scaling, --addFeatures vectors (scoreByScreening) and
    --addToInput write-back. The statistics are taken on the card."""
    name = "xmipp_image_sort_by_statistics"

    def defineParams(self):
        self.addUsageLine("Screen particles by statistical outlier scores "
                          "(zScore over intensity/shape features).")
        self.addParamsLine("   -i <md_or_stack> : Input particles")
        self.addParamsLine("  [-o <md=\"\">]      : Output sorted metadata")
        self.addParamsLine("  [-t <selfile=\"\">] : Train on this selfile "
                           "of good particles")
        self.addParamsLine("  [--zcut <z=-1>]   : Disable particles above "
                           "this zScore")
        self.addParamsLine("  [--percent <p=0>] : Disable this percentage "
                           "of largest z-scores")
        self.addParamsLine("  [--addFeatures]   : Add feature vectors to "
                           "the output metadata")
        self.addParamsLine("  [--addToInput]    : Also write the score "
                           "columns back into the input metadata")
        self.addParamsLine("  [--dim <d=50>]    : Scale images down to "
                           "this size first (-1 = no rescaling)")

    def _features(self, imgs, dev):
        """(B, 5) float32 numpy: mean, std, max |x|, skewness, kurtosis of
        each image, after the --dim rescaling."""
        from xmipp3_tpu_torch.ops.resize import fourier_resize_2d
        imgs = torch.as_tensor(imgs, device=dev)
        dim = self.getIntParam("--dim")
        if 0 < dim < imgs.shape[-1]:
            imgs = fourier_resize_2d(imgs, dim, dim)
        flat = imgs.reshape(len(imgs), -1)
        mu = flat.mean(dim=1, keepdim=True)
        sd = flat.std(dim=1, correction=0)
        sd1 = torch.clamp(sd, min=1e-12)
        return torch.stack([
            mu[:, 0], sd, flat.abs().amax(dim=1),
            ((flat - mu) ** 3).mean(dim=1) / sd1 ** 3,     # skewness
            ((flat - mu) ** 4).mean(dim=1) / sd1 ** 4,     # kurtosis
        ], dim=1).cpu().numpy()

    def run(self):
        dev = resolve_device(self.getParam("--device"))
        imgs, rows = _load(self.getParam("-i"))
        with timed_phase("features"):
            feats = self._features(imgs, dev)
            if self.checkParam("-t") and self.getParam("-t"):
                t_feats = self._features(_load(self.getParam("-t"))[0], dev)
            else:
                t_feats = feats
        mu = t_feats.mean(axis=0)
        sd = np.maximum(t_feats.std(axis=0), 1e-12)
        z = np.abs((feats - mu) / sd)
        zscore = z.max(axis=1)
        order = np.argsort(zscore)
        zcut = self.getDoubleParam("--zcut")
        pct = self.getDoubleParam("--percent")
        pct_thr = (np.percentile(zscore, 100 - pct) if pct > 0
                   else np.inf)
        add_feats = self.checkParam("--addFeatures")

        def annotate(r, i):
            r["zScore"] = float(zscore[i])
            r["zScoreShape1"] = float(z[i, 3])
            r["zScoreSNR1"] = float(z[i, 1])
            if add_feats:
                r["scoreByScreening"] = feats[i].astype(np.float32)
            if zcut > 0 or pct > 0:
                bad = (zcut > 0 and zscore[i] > zcut) or zscore[i] > pct_thr
                r["enabled"] = -1 if bad else 1
            return r

        fn_in = self.getParam("-i")
        fn_out = self.getParam("-o") if self.checkParam("-o") and \
            self.getParam("-o") else fn_in
        MetaData.fromRows([annotate(dict(rows[i]), i)
                           for i in order]).write(fn_out)
        if self.checkParam("--addToInput") and is_metadata_file(fn_in) \
                and fn_in != fn_out:
            MetaData.fromRows([annotate(dict(rows[i]), i)
                               for i in range(len(rows))]).write(fn_in)
        self.zscores = zscore


class ProgImageFindCenter(XmippProgram):
    """Center of the --harm rotational harmonic of the average image's
    angular profile (reference image_find_center.cpp:591-759, the classic
    busca/ergrot search), integrated over rings --r1..--r2 (% of the
    radius) after --r3..--r4 raised-cosine apodization, from (--x0, --y0),
    minimizing (--opt -1) or maximizing (+1). Five grid refinements of 25
    candidate centers, each level's candidates resampled together on the
    card."""
    name = "xmipp_image_find_center"

    def defineParams(self):
        self.addUsageLine("Find the best center of rotation of an image "
                          "or collection of images.")
        self.addParamsLine("   -i <file> : Image, stack or selfile")
        self.addParamsLine("  [--oroot <root=\"\">] : Output rootname "
                           "(<root>_center.xmd)")
        self.addParamsLine("  [--r1 <radius=15>] : Lowest integration "
                           "radius (% of image radius)")
        self.addParamsLine("  [--r2 <radius=80>] : Highest integration "
                           "radius (%)")
        self.addParamsLine("  [--r3 <radius=90>] : Lowest smoothing "
                           "radius (%)")
        self.addParamsLine("  [--r4 <radius=100>] : Highest smoothing "
                           "radius (%)")
        self.addParamsLine("  [--x0 <x=-1>] : Initial center x")
        self.addParamsLine("  [--y0 <y=-1>] : Initial center y")
        self.addParamsLine("  [--harm <n=1>] : Harmonic to optimize")
        self.addParamsLine("  [--opt <o=-1>] : -1 = minimize, +1 = "
                           "maximize the harmonic energy")

    @staticmethod
    def _harmonic_energy(img, centers, radii, ncic, n_theta=128):
        """E(c) = sum_r r*|sum_theta I(c + r e^{i theta}) e^{i n theta}|^2
        for (C, 2) candidate centers (x, y): (C,) on the image's device."""
        H, W = img.shape
        dev = img.device
        theta = torch.arange(n_theta, device=dev) * (2 * np.pi / n_theta)
        cs = torch.stack([torch.cos(ncic * theta), torch.sin(ncic * theta)],
                         dim=1)                                   # (T, 2)
        xs = centers[:, 0, None, None] + radii[:, None] * torch.cos(theta)
        ys = centers[:, 1, None, None] + radii[:, None] * torch.sin(theta)
        x0, y0 = torch.floor(xs), torch.floor(ys)
        fx, fy = xs - x0, ys - y0
        x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
        flat = img.reshape(-1)
        vals = 0.0
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
                v = flat[yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)]
                vals = vals + torch.where(inside, v, 0.0) * (
                    (fx if dx else 1 - fx) * (fy if dy else 1 - fy))
        reim = vals @ cs                                          # (C,R,2)
        return (radii * (reim ** 2).sum(dim=-1)).sum(dim=1)

    def run(self):
        from xmipp3_tpu_torch.ops.mask import circular_mask
        dev = resolve_device(self.getParam("--device"))
        imgs, _ = _load(self.getParam("-i"))
        img = torch.as_tensor(imgs, device=dev).mean(dim=0)
        H, W = img.shape
        lo, hi = img.min(), img.max()
        img = (img - lo) * (255.0 / torch.clamp(hi - lo, min=1e-12))
        r1, r2, r3, r4 = (self.getDoubleParam(f) / 100.0 * W / 2.0
                          for f in ("--r1", "--r2", "--r3", "--r4"))
        ncic = self.getIntParam("--harm")
        indmul = self.getIntParam("--opt")
        if np.pi / 2 * r2 / ncic < 3:
            raise XmippError(ErrCode.ARG_INCORRECT,
                             "A higher integration radius is needed "
                             "(r2>6*harm/pi)")
        # edge apodization between r3 and r4
        img = img * torch.as_tensor(circular_mask(
            (H, W), r4, inner=r3, mode="raised_cosine"), device=dev)
        x0 = self.getDoubleParam("--x0")
        y0 = self.getDoubleParam("--y0")
        xc = x0 if x0 >= 0 else W / 2.0
        yc = y0 if y0 >= 0 else H / 2.0
        radii = torch.as_tensor(np.arange(max(r1, 1.0), max(r2, r1 + 1), 1.0)
                                .astype(np.float32), device=dev)
        delta = 2.0
        with timed_phase("search", sync=img):
            for _ in range(5):                 # DEF_IT refinement levels
                gx, gy = np.meshgrid(xc + delta * np.arange(-2, 3),
                                     yc + delta * np.arange(-2, 3))
                cand = np.stack([gx.ravel(), gy.ravel()], axis=1)
                e = self._harmonic_energy(
                    img, torch.as_tensor(cand, dtype=torch.float32,
                                         device=dev), radii, ncic)
                k = int(torch.argmax(e) if indmul > 0 else torch.argmin(e))
                xc, yc = float(cand[k, 0]), float(cand[k, 1])
                delta *= 0.5
        self.center = (xc, yc)
        self.centers = np.asarray([[xc, yc]])
        if self.verbose:
            print(f"Optimal center coordinates: x= {xc} ,y= {yc}")
        root = self.getParam("--oroot")
        if root:
            MetaData.fromRows([{"X": xc, "Y": yc}]).write(
                root + "_center.xmd")


class ProgImageSSNR(XmippProgram):
    """Per-image SSNR (reference program_image_ssnr.cpp:31-173): signal =
    image inside a raised-cosine radius-R mask, noise = outside; SSNR =
    mean over the [fmin, fmax] band of 10*(log10 S(f) - log10 N(f)) dB,
    with --ssnrcut/--ssnrpercent disabling and --normalizessnr weights.
    The masked spectra and their radial profiles are taken on the card."""
    name = "xmipp_image_ssnr"

    def defineParams(self):
        self.addUsageLine("Analyze image SSNR (in-mask signal vs "
                          "out-of-mask noise spectra).")
        self.addParamsLine("   -i <md_or_stack> : Input particles")
        self.addParamsLine("  [-o <md=\"\">]      : Output metadata")
        self.addParamsLine("  [-R <r=-1>] : Particle radius (default "
                           "half image size)")
        self.addParamsLine("  [--Rwidth <r=3>] : Mask transition width")
        self.addParamsLine("  [--fmin <f=40>] : Minimum frequency (A)")
        self.addParamsLine("  [--fmax <f=3>]  : Maximum frequency (A)")
        self.addParamsLine("  [--sampling <Ts=1>] : Sampling (A/px)")
        self.addParamsLine("  [--ssnrcut <s=-1>] : Disable images with "
                           "SSNR below this value")
        self.addParamsLine("  [--ssnrpercent <p=-1>] : Disable images "
                           "with SSNR below this percentile")
        self.addParamsLine("  [--normalizessnr] : Write weightSSNR = "
                           "SSNR / max SSNR")

    def run(self):
        from xmipp3_tpu_torch.ops.fourier import radial_average_half
        from xmipp3_tpu_torch.ops.mask import circular_mask
        dev = resolve_device(self.getParam("--device"))
        imgs, rows = _load(self.getParam("-i"))
        H = imgs.shape[-1]
        Rwidth = self.getDoubleParam("--Rwidth")
        R = self.getDoubleParam("-R")
        if R == -1:
            R = 0.5 * H - Rwidth
        Ts = self.getDoubleParam("--sampling")
        imin = int(max(3.0, 0.5 * H * (Ts / self.getDoubleParam("--fmin"))))
        imax = int(min(H - 3.0, 0.5 * H * (Ts / self.getDoubleParam("--fmax"))))
        nbins = H // 2
        imax = min(imax, nbins - 1)
        maskS = torch.as_tensor(circular_mask(
            (H, H), R + Rwidth, inner=R - Rwidth, mode="raised_cosine"),
            device=dev)
        x = torch.as_tensor(imgs, device=dev)
        with timed_phase("spectra", sync=x):
            prof = torch.stack([radial_average_half(
                torch.abs(torch.fft.rfft2(x * m)) ** 2, nbins)
                for m in (maskS, 1.0 - maskS)])[:, :, imin:imax + 1]
            valid = (prof[0] > 0) & (prof[1] > 0)
            logs = torch.log10(torch.clamp(prof.double(), min=1e-300))
            terms = torch.where(valid, logs[0] - logs[1], 0.0)
            ssnr = (terms.sum(dim=1) * 10.0
                    / max(imax - imin + 1, 1)).cpu().numpy()
        enabled = np.asarray([int(r.get("enabled", 1)) for r in rows])
        cut = self.getDoubleParam("--ssnrcut")
        if cut > 0:
            enabled = np.where(ssnr < cut, -1, enabled)
        pct = self.getDoubleParam("--ssnrpercent")
        if pct > 0:
            srt = np.sort(ssnr)
            thr = srt[min(int(pct / 100.0 * len(srt)), len(srt) - 1)]
            enabled = np.where(ssnr < thr, -1, enabled)
        weights = None
        if self.checkParam("--normalizessnr") and ssnr.max() > 0:
            weights = ssnr / ssnr.max()
        out_rows = []
        for i, r in enumerate(rows):
            d = dict(r)
            d["cumulativeSSNR"] = float(ssnr[i])
            d["enabled"] = int(enabled[i])
            if weights is not None:
                d["weightSSNR"] = float(weights[i])
            out_rows.append(d)
        fn_out = self.getParam("-o") if self.checkParam("-o") and \
            self.getParam("-o") else self.getParam("-i")
        MetaData.fromRows(out_rows).write(fn_out)
        self.ssnr = ssnr


class ProgEliminateEmptyParticles(XmippProgram):
    """Emptiness score = the inner/outer 4x4-block variance ratio (the
    variance extractor's last feature) of the centered, bandpassed (and
    optionally Gaussian-denoised) particle (reference
    image_eliminate_empty_particles.cpp:33-135); kept rows go to -o,
    eliminated to -e. The Gaussian denoising runs on the host with scipy,
    as in the reference package; the rest on the card."""
    name = "xmipp_image_eliminate_empty_particles"

    def defineParams(self):
        self.addUsageLine("Eliminate empty particles (no structural "
                          "content) from a particle set.")
        self.addParamsLine("   -i <md_or_stack> : Input particles")
        self.addParamsLine("  [-o <md=output.xmd>] : Output selfile "
                           "(kept particles)")
        self.addParamsLine("  [-e <md=eliminated.xmd>] : Eliminated "
                           "particles selfile")
        self.addParamsLine("  [-t <t=-1>] : Emptiness-score threshold "
                           "(-1 = no elimination)")
        self.addParamsLine("   alias --threshold;")
        self.addParamsLine("  [--addFeatures] : Add the variance feature "
                           "vector (scoreByVariance) to the rows")
        self.addParamsLine("  [--useDenoising] : Gaussian-denoise before "
                           "computing the emptiness feature")
        self.addParamsLine("  [-d <int=50>] : Denoising strength "
                           "(real-space Gaussian sigma)")

    def run(self):
        from xmipp3_tpu_torch.ops import features as F
        from xmipp3_tpu_torch.ops.fourier_filter import (
            apply_fourier_mask_2d, band_pass_mask)
        dev = resolve_device(self.getParam("--device"))
        imgs, rows = _load(self.getParam("-i"))
        H, W = imgs.shape[-2:]
        with timed_phase("scores"):
            proc = F.center_translationally(imgs, device=dev)
            if self.checkParam("--useDenoising"):
                from scipy.ndimage import gaussian_filter
                d = self.getIntParam("-d")
                # reference realGaussianFilter(I, d): real-space sigma = d px
                proc = torch.as_tensor(np.stack(
                    [gaussian_filter(p, d / 6.0)
                     for p in proc.cpu().numpy()]), device=dev)
            # reference quirk: the bandpass is OUTSIDE the if (missing
            # braces, image_eliminate_empty_particles.cpp:106-108) so it
            # always runs
            proc = apply_fourier_mask_2d(proc,
                                         band_pass_mask(H, W, 0.0, 0.1, 0.02))
            fv = F.extract_variance(proc).cpu().numpy()
        ratio = fv[:, -1]
        thr = self.getDoubleParam("-t")
        kept, elim = [], []
        for i, r in enumerate(rows):
            d = dict(r)
            d["scoreByEmptiness"] = float(ratio[i])
            if self.checkParam("--addFeatures"):
                d["scoreByVariance"] = fv[i].astype(np.float32)
            (kept if thr < 0 or ratio[i] > thr else elim).append(d)
        if kept:
            MetaData.fromRows(kept).write(self.getParam("-o"))
        if elim:
            MetaData.fromRows(elim).write(self.getParam("-e"))
        self.ratio = ratio
        self.n_kept = len(kept)
        self.n_eliminated = len(elim)


# The sub-arguments of -m that the reference drops without a word
# (ROADMAP.md section 3, item 16): it passes them to a function that does
# not take them, catches the TypeError and runs the method with its own
# defaults (image_analysis.py:562-591); LLE's k it never reads. The port
# runs those defaults too and refuses any other value of these
# sub-arguments: method -> {sub-argument index: documented default}.
_DROPPED_SUBARGS = {"LPP": {1: 12.0, 2: 1.0}, "kPCA": {1: 1.0},
                    "SPE": {1: 12.0, 2: 1.0}, "LLE": {1: 12.0}}
# the sub-arguments that reach the method: method -> [(name, index, type)]
_SUBARGS = {
    "LTSA": [("k", 1, int)], "LLTSA": [("k", 1, int)],
    "LE": [("k", 1, int), ("sigma", 2, float)], "HLLE": [("k", 1, int)],
    "NPE": [("k", 1, int)], "DM": [("sigma", 1, float), ("t", 2, float)],
    "pPCA": [("n_iters", 1, int)],
}


class ProgMatrixDimred(XmippProgram):
    """Dimension reduction of the rows of a matrix (reference
    dimred/matrix_dimred.cpp:175-252, ProgDimRed grammar :63-118):
    text-matrix input with --din/--samples, -m method with its
    sub-arguments, --dout -1 intrinsic-dimension estimation (CorrDim/MLE,
    dimred_tools.cpp:341-448), --saveMapping for the linear methods
    (Y = Xc @ M); metadata input with classificationData vectors. The
    reductions run on the card (models/dimred.py)."""
    name = "xmipp_matrix_dimred"

    def defineParams(self):
        self.addUsageLine("Project each observation (row) of the input "
                          "matrix onto a lower dimensional space.")
        self.addParamsLine("   -i <file>  : Input matrix (text, one "
                           "observation per row) or metadata with "
                           "classificationData vectors")
        self.addParamsLine("  [-o <file=\"\">] : Output matrix / metadata")
        self.addParamsLine("  [-m <dimRefMethod=PCA>] : Dimensionality "
                           "reduction method")
        self.addParamsLine("   alias --method;")
        self.addParamsLine("      where <dimRefMethod>")
        self.addParamsLine("             PCA            : Principal Component Analysis")
        self.addParamsLine("             LTSA <k=12>    : Local Tangent Space Alignment")
        self.addParamsLine("             DM <s=1> <t=1> : Diffusion map")
        self.addParamsLine("             LLTSA <k=12>   : Linear Local Tangent Space Alignment")
        self.addParamsLine("             LPP <k=12> <s=1> : Linearity Preserving Projection")
        self.addParamsLine("             kPCA <s=1>     : Kernel PCA")
        self.addParamsLine("             pPCA <n=200>   : Probabilistic PCA")
        self.addParamsLine("             LE <k=7> <s=1> : Laplacian Eigenmap")
        self.addParamsLine("             HLLE <k=12>    : Hessian Locally Linear Embedding")
        self.addParamsLine("             SPE <k=12> <global=1> : Stochastic Proximity Embedding")
        self.addParamsLine("             NPE <k=12>     : Neighborhood Preserving Embedding")
        self.addParamsLine("             LLE <k=12>     : Locally Linear Embedding")
        self.addParamsLine("             Sammon         : Sammon mapping")
        self.addParamsLine("             NCA            : Neighborhood Component Analysis")
        self.addParamsLine("             GPLVM          : Gaussian Process Latent Variable Model")
        self.addParamsLine("  [--din <d=-1>]     : Input dimension (text input; -1 = infer)")
        self.addParamsLine("  [--samples <N=-1>] : Number of observations (text input; -1 = infer)")
        self.addParamsLine("  [--dout <d=2> <estimator=CorrDim>] : Output dimension; -1 estimates it (CorrDim or MLE)")
        self.addParamsLine("  [--saveMapping <fn=\"\">] : Save the linear mapping M (Y = Xc*M) as a text matrix (PCA, LLTSA, LPP, pPCA, NPE)")

    def _subarg(self, idx):
        """-m's sub-argument `idx` (its documented default when not given),
        or None where the method declares none there."""
        try:
            return self.getParam("-m", idx)
        except XmippError:
            return None

    def run(self):
        from xmipp3_tpu_torch.models.dimred import (intrinsic_dimensionality,
                                                    reduce_dimensionality)
        dev = resolve_device(self.getParam("--device"))
        fn_in = self.getParam("-i")
        md = None
        if is_metadata_file(fn_in):
            md = MetaData(fn_in)
            X = np.stack([np.asarray(v, np.float64)
                          for v in md.getColumnValues("classificationData")])
        else:
            X = np.loadtxt(fn_in, ndmin=2)
            din = self.getIntParam("--din")
            ns = self.getIntParam("--samples")
            if din > 0 and X.shape[1] != din:
                X = X.reshape(-1, din)
            if ns > 0:
                X = X[:ns]
        method = self.getParam("-m")
        for idx, default in _DROPPED_SUBARGS.get(method, {}).items():
            got = self._subarg(idx)
            if got is not None and float(got) != default:
                raise XmippError(
                    ErrCode.ARG_INCORRECT,
                    f"-m {method}: the reference drops its sub-argument "
                    f"{idx} ({got}) and runs its own default; the port "
                    "refuses it rather than ignore it (ROADMAP.md section "
                    "3, item 16)")
        d = self.getIntParam("--dout")
        if d < 0:
            est = self.getParam("--dout", 1)
            d = max(int(round(intrinsic_dimensionality(X.copy(), est,
                                                       device=dev))), 1)
            if self.verbose:
                print(f"Estimated intrinsic dimension ({est}): {d}")
        kw = {}
        for key, idx, typ in _SUBARGS.get(method, []):
            got = self._subarg(idx)
            if got is not None:
                kw[key] = typ(float(got))
        with timed_phase("dimred"):
            Y = reduce_dimensionality(X, method, d, device=dev, **kw)
        if self.checkParam("--saveMapping") and \
                self.getParam("--saveMapping"):
            if method not in ("PCA", "LLTSA", "LPP", "pPCA", "NPE"):
                print(f"WARNING: {method} has no linear mapping; "
                      "--saveMapping skipped")
            else:
                # linear methods satisfy Y = Xc @ M exactly; recover M by
                # least squares on the centered data
                M, *_ = np.linalg.lstsq(X - X.mean(axis=0), Y, rcond=None)
                np.savetxt(self.getParam("--saveMapping"), M)
        fn_out = self.getParam("-o")
        if md is not None:
            rows = []
            for k, i in enumerate(md):
                r = md.getRow(i)
                r.pop("classificationData", None)
                r["dimred"] = np.asarray(Y[k], np.float32)
                rows.append(r)
            if fn_out:
                MetaData.fromRows(rows).write(fn_out)
        elif fn_out:
            np.savetxt(fn_out, Y)
        self.Y = Y


class ProgImageRotationalPCA(MeshProgram):
    """Rotation-invariant PCA basis of a particle set: the images and
    their copies rotated over the --psi_step grid (or --shuffles random
    angles, numpy's Generator(0)) and shifted over the --max_shift_change
    grid, then the top --eigenvectors components. Serially an exact SVD
    when the data hold at most 4e7 values, else a randomised sketch with
    --iterations QR rounds (numpy's Gaussian test matrix, float64 on the
    card); with --mesh dp the samples are dealt over the ranks and their
    moments meet in one all_reduce (parallel_pca_components). Each
    component's largest entry is made positive."""
    name = "xmipp_image_rotational_pca"

    def defineParams(self):
        self.addUsageLine("Rotation-invariant PCA basis of a particle set "
                          "(PCA over randomly rotated copies).")
        self.addParamsLine("   -i <md_or_stack> : Input particles")
        self.addParamsLine("   --oroot <root>   : Output rootname (basis stack)")
        self.addParamsLine("  [--eigenvectors <n=8>] : Number of eigenimages")
        self.addParamsLine("  [--shuffles <n=0>] : Random in-plane rotations "
                           "per image (0 = use the --psi_step grid)")
        self.addParamsLine("  [--iterations <n=2>] : Power-iteration "
                           "refinements of the eigenbasis")
        self.addParamsLine("  [--psi_step <a=15>] : Psi expansion step (deg)")
        self.addParamsLine("  [--max_shift_change <r=0>] : Maximum shift "
                           "perturbation (px)")
        self.addParamsLine("  [--shift_step <s=1>] : Shift expansion step")
        self.addParamsLine("  [--maxImages <n=-1>] : Use at most this many "
                           "input images")
        add_mesh_params(self)

    def readParams(self):
        self.device_arg = self.getParam("--device")
        read_mesh_params(self)

    def _expanded(self, imgs, rng):
        """(samples, H*W) float32 on the card: the images and their
        rotated and shifted copies, in the reference's order."""
        from xmipp3_tpu_torch.ops.geo import rotate_2d, shift_2d_real
        B = len(imgs)
        full = lambda v: torch.full((B,), float(v), device=imgs.device)
        expanded = [imgs]
        n_shuf = self.getIntParam("--shuffles")
        if n_shuf > 1:
            for _ in range(n_shuf - 1):
                angles = rng.uniform(0, 360, B).astype(np.float32)
                expanded.append(rotate_2d(imgs, angles))
        else:
            # rotational expansion over the psi grid + shift perturbations
            # (image_rotational_pca.cpp:96-101)
            psi_step = self.getDoubleParam("--psi_step")
            for a in np.arange(psi_step, 360.0, psi_step):
                expanded.append(rotate_2d(imgs, full(np.float32(a))))
            msc = self.getDoubleParam("--max_shift_change")
            sst = max(self.getDoubleParam("--shift_step"), 0.5)
            if msc > 0:
                for sx in np.arange(-msc, msc + 1e-6, sst):
                    for sy in np.arange(-msc, msc + 1e-6, sst):
                        if sx == 0 and sy == 0:
                            continue
                        expanded.append(shift_2d_real(
                            imgs, full(np.float32(sx)), full(np.float32(sy))))
        return torch.cat(expanded).reshape(-1, imgs.shape[-2]
                                           * imgs.shape[-1])

    def _run(self, mesh):
        dev = self.device
        imgs, _ = _load(self.getParam("-i"))
        max_imgs = self.getIntParam("--maxImages")
        if 0 < max_imgs < len(imgs):
            imgs = imgs[:max_imgs]
        n_eig = self.getIntParam("--eigenvectors")
        H = imgs.shape[-1]
        rng = np.random.default_rng(0)
        with timed_phase("expand"):
            X = self._expanded(torch.as_tensor(imgs, device=dev), rng)
        n_its = max(self.getIntParam("--iterations"), 1)
        with timed_phase("pca", sync=X):
            if mesh is not None:
                from xmipp3_tpu_torch.parallel.engines import \
                    parallel_pca_components
                comps = parallel_pca_components(mesh, X, n_eig)
            else:
                Xc = X - X.mean(dim=0)
                if Xc.numel() <= 4e7:          # exact SVD when it fits
                    comps = torch.linalg.svd(Xc, full_matrices=False)[2][
                        :n_eig]
                else:
                    # randomised sketch with --iterations QR rounds, float64
                    # as the reference's numpy upcasts it
                    G = torch.as_tensor(rng.standard_normal(
                        (X.shape[1], min(n_eig + 8, min(X.shape)))),
                        device=dev)
                    Xc = Xc.double()
                    Q = torch.linalg.qr(Xc @ G)[0]
                    for _ in range(n_its):
                        Q = torch.linalg.qr(Xc.T @ Q)[0]
                        Q = torch.linalg.qr(Xc @ Q)[0]
                    comps = torch.linalg.svd(Q.T @ Xc,
                                             full_matrices=False)[2][:n_eig]
                comps = comps.cpu().numpy()
        # deterministic sign: largest-|entry| coefficient positive (the
        # serial SVD and the mesh eigh agree only up to sign)
        j = np.argmax(np.abs(comps), axis=1)
        comps = comps * np.where(comps[np.arange(len(comps)), j] < 0,
                                 -1.0, 1.0)[:, None]
        basis = np.asarray(comps).reshape(n_eig, H, H).astype(np.float32)
        if self.writer:
            save_image(self.getParam("--oroot") + ".stk", basis)
        self.basis = basis


class ProgEliminateByEnergy(XmippProgram):
    """Eliminate images whose variance is extreme (reference
    image_eliminate_byEnergy.cpp: z-test of sigma^2/sigma2_0 against a
    confidence bound + minimum-variance and mean-offset gates). The
    statistics are taken on the card."""
    name = "xmipp_image_eliminate_byEnergy"

    def defineParams(self):
        self.addUsageLine("Eliminate images whose variance is extremely "
                          "large or small.")
        self.addParamsLine("   -i <md_file>  : Input particles")
        self.addParamsLine("   -o <md_file>  : Output metadata (disabled rows removed)")
        self.addParamsLine("  [--confidence <conf=0.99>] : Remove an image if its variance is outside this confidence beyond sigma^2_0")
        self.addParamsLine("  [--sigma2 <sigma20=1>]     : Reference variance")
        self.addParamsLine("  [--minSigma2 <sigma2=0.01>] : Minimum variance")

    def run(self):
        import scipy.stats
        dev = resolve_device(self.getParam("--device"))
        md = MetaData(self.getParam("-i"))
        rows = list(md.iterRows())
        imgs = torch.as_tensor(load_image_rows(rows), device=dev)
        sigma20 = self.getDoubleParam("--sigma2")
        zalpha = abs(scipy.stats.norm.ppf(self.getDoubleParam("--confidence")))
        flat = imgs.reshape(len(imgs), -1)
        avg = flat.mean(dim=1).cpu().numpy()
        s2 = flat.var(dim=1, correction=0).cpu().numpy()
        bad = ((s2 / sigma20 - 1.0 > zalpha)
               | (s2 < self.getDoubleParam("--minSigma2"))
               | ~np.isfinite(s2) | (np.abs(avg) > sigma20 / 9.0))
        out = []
        for i, r in enumerate(rows):
            if not bad[i]:
                d = dict(r)
                d["enabled"] = 1
                out.append(d)
        MetaData.fromRows(out).write(self.getParam("-o"))
        self.energy_outliers = bad
        if self.verbose:
            print(f"kept {len(out)}/{len(rows)} images "
                  f"(removed {int(bad.sum())})")


PROGRAM = None  # registered individually
