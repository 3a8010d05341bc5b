"""The script programs of the reference package's programs/scripts_misc.py:
metadata_selfile_create, pdb_center, pdb_select, coordinates_consensus,
pick_noise, preprocess_mics, volume_consensus, cl2d_clustering,
alignPCA_2D (align_pca_2d), graph_max_cut, extract_particles,
tomo_misalignment_resid_statistics and the swiftalign pair, with the
k-means that they, classify_FTTRI and classify_CLTomo_prog share
(`_kmeans`).

Image work runs on the card unless `--device cpu` is given: the phase
flip, Fourier downsampling and normalisation of preprocess_mics, the
wavelet consensus, the polar features and silhouettes of cl2d_clustering,
the alignment and EM-PCA of align_pca_2d and of the swiftalign
classification, the Wiener correction (every row's CTF in one batch) and
the box cutting of extract_particles. Metadata, PDB text, coordinate
votes, the noise picks and the max-cut's greedy flips stay on the host,
as in the reference. `_kmeans` draws its starting centroids from the
caller's numpy Generator on the host, in the reference's order, and runs
its distances, centroid means and inertia in float64 on `device`.
"""
from __future__ import annotations

import glob as _glob
import os

import numpy as np
import torch

from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import load_image_rows
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import as_tensor, resolve_device


def _kmeans(X, k, rng, iters=50, restarts=8, device=None):
    """Labels (numpy int64, (n,)) of the rows of X (an array, or a tensor)
    from the lowest-inertia run of `restarts`
    Lloyd runs of at most `iters` steps, each started from k rows drawn
    without replacement by `rng` (numpy Generator). A run stops when no
    label changes (from all-zero labels at the first step, as in the
    reference)."""
    dev = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float64, device=dev)
    best = None
    for _ in range(restarts):
        C = X[torch.as_tensor(rng.choice(len(X), k, replace=False),
                              device=dev)].clone()
        labels = torch.zeros(len(X), dtype=torch.int64, device=dev)
        for _ in range(iters):
            d = torch.stack([((X - C[c]) ** 2).sum(-1) for c in range(k)],
                            dim=1)
            new = d.argmin(dim=1)
            if bool((new == labels).all()):
                break
            labels = new
            for c in range(k):
                m = labels == c
                if bool(m.any()):
                    C[c] = X[m].mean(dim=0)
        inertia = float(((X - C[labels]) ** 2).sum())
        if best is None or inertia < best[0]:
            best = (inertia, labels)
    return best[1].cpu().numpy()


class ProgTomoMisalignmentResidStatistics(XmippProgram):
    name = "xmipp_tomo_misalignment_resid_statistics"

    def defineParams(self):
        self.addUsageLine("Aggregate statistics over landmark-residual files "
                          "(per-chain rms, per-image mean, histograms).")
        self.addParamsLine("   -i <listOrFile> : Residual .xmd, or text list of them")
        self.addParamsLine("   -o <md>         : Output statistics metadata")

    def run(self):
        fn = self.getParam("-i")
        files = [fn]
        if not fn.endswith(".xmd"):
            files = [ln.strip() for ln in open(fn) if ln.strip()]
        rows = []
        for f in files:
            md = MetaData(f)
            rx = np.asarray(md.getColumn("shiftX"), float)
            ry = np.asarray(md.getColumn("shiftY"), float)
            r = np.sqrt(rx ** 2 + ry ** 2)
            frames = np.asarray(md.getColumn("frameId"), int)
            for fr in np.unique(frames):
                m = r[frames == fr]
                rows.append({"image": f, "frameId": int(fr),
                             "min": float(m.min()), "max": float(m.max()),
                             "avg": float(m.mean()),
                             "stddev": float(m.std())})
        MetaData.fromRows(rows).write(self.getParam("-o"))
        if self.verbose:
            tot = np.mean([r["avg"] for r in rows]) if rows else 0.0
            print(f"{len(rows)} frame statistics; overall mean residual "
                  f"{tot:.2f} px")


def _silhouette(X, labels, device=None) -> float:
    """Mean silhouette of the rows of X (float64 on `device`) under
    integer labels; -1 for fewer than two clusters."""
    k = int(labels.max()) + 1
    if k < 2:
        return -1.0
    dev = resolve_device(device)
    X = torch.as_tensor(np.asarray(X, np.float64), device=dev)
    lab = torch.as_tensor(labels, device=dev)
    n = len(X)
    d = torch.cdist(X, X, compute_mode="donot_use_mm_for_euclid_dist")
    onehot = torch.nn.functional.one_hot(lab, k).double()      # (n, k)
    counts = onehot.sum(0)
    sums = d @ onehot                                          # (n, k)
    own = counts[lab] - 1
    a = torch.where(own > 0, sums.gather(1, lab[:, None])[:, 0]
                    / own.clamp(min=1), torch.zeros_like(own))
    means = sums / counts.clamp(min=1)
    means[:, counts == 0] = float("inf")
    means[torch.arange(n, device=dev), lab] = float("inf")
    b = means.min(dim=1).values
    s = (b - a) / torch.clamp(torch.maximum(a, b), min=1e-12)
    return float(s.mean())


def _read_coords_any(fn):
    """A coordinate file -> (N, 2) array: .xmd/.pos metadata or plain
    two-column text."""
    try:
        md = MetaData(fn)
        if md.containsLabel("xcoor"):
            return np.stack([np.asarray(md.getColumn("xcoor"), float),
                             np.asarray(md.getColumn("ycoor"), float)], 1)
    except Exception:
        pass
    try:
        return np.loadtxt(fn, ndmin=2)[:, :2]
    except Exception:
        return np.zeros((0, 2))


class ProgMetadataSelfileCreate(XmippProgram):
    name = "xmipp_metadata_selfile_create"

    def defineParams(self):
        self.addUsageLine("Create a metadata from a file pattern.")
        self.addParamsLine("   -p <pattern>      : Pattern to match")
        self.addParamsLine("     alias --pattern;")
        self.addParamsLine("   -o <metadata>     : Output metadata")
        self.addParamsLine("  [-l <label=image>] : Label for the matches")
        self.addParamsLine("  [-s]               : Expand stacks to n@stack rows")
        self.addParamsLine("     alias --isstack;")

    def run(self):
        label = self.getParam("-l") if self.checkParam("-l") else "image"
        rows = []
        for fn in sorted(_glob.glob(self.getParam("-p"))):
            if self.checkParam("-s"):
                hdr = Image()
                hdr.read(fn, header_only=True)
                rows += [{label: f"{i + 1:06d}@{fn}"}
                         for i in range(hdr.header.shape[0])]
            else:
                rows.append({label: fn})
        MetaData.fromRows(rows).write(self.getParam("-o"))
        if self.verbose:
            print(f"{len(rows)} entries")


class ProgPdbCenter(XmippProgram):
    name = "xmipp_pdb_center"

    def defineParams(self):
        self.addUsageLine("Center a PDB at its center of mass (text-level: "
                          "all records preserved).")
        self.addParamsLine("   -i <pdb>  : Input PDB")
        self.addParamsLine("   -o <pdb>  : Output centered PDB")

    def run(self):
        with open(self.getParam("-i")) as f:
            lines = f.readlines()
        atom = ("ATOM", "HETATM")
        c = np.asarray([(float(ln[30:38]), float(ln[38:46]),
                         float(ln[46:54]))
                        for ln in lines if ln.startswith(atom)]).mean(axis=0)
        with open(self.getParam("-o"), "w") as f:
            for ln in lines:
                if ln.startswith(atom):
                    x, y, z = (float(ln[30:38]) - c[0],
                               float(ln[38:46]) - c[1],
                               float(ln[46:54]) - c[2])
                    ln = ln[:30] + f"{x:8.3f}{y:8.3f}{z:8.3f}" + ln[54:]
                f.write(ln)
        if self.verbose:
            print(f"centered at {-c.round(3)}")


class ProgPdbSelect(XmippProgram):
    name = "xmipp_pdb_select"

    def defineParams(self):
        self.addUsageLine("Select PDB atoms by chain and/or atom name.")
        self.addParamsLine("   -i <pdb>       : Input PDB")
        self.addParamsLine("   -o <pdb>       : Output PDB")
        self.addParamsLine("  [--chain <c=\"\">] : Keep only this chain")
        self.addParamsLine("  [--atom <a=\"\">]  : Keep only this atom name (e.g. CA)")

    def run(self):
        chain = self.getParam("--chain") if self.checkParam("--chain") else ""
        atom = self.getParam("--atom") if self.checkParam("--atom") else ""
        kept = 0
        with open(self.getParam("-i")) as fin, \
                open(self.getParam("-o"), "w") as f:
            for ln in fin:
                if ln.startswith(("ATOM", "HETATM")):
                    if chain and ln[21].strip() != chain:
                        continue
                    if atom and ln[12:16].strip() != atom:
                        continue
                    kept += 1
                f.write(ln)
        if self.verbose:
            print(f"kept {kept} atoms")


class ProgCoordinatesConsensus(XmippProgram):
    name = "xmipp_coordinates_consensus"

    def defineParams(self):
        self.addUsageLine("Consensus of several picking coordinate sets: "
                          "keep coordinates selected by >= c pickers within "
                          "a distance tolerance.")
        self.addParamsLine("   -i <listFile>    : Text file listing coordinate files (one per line)")
        self.addParamsLine("   -s <particleSize> : Particle size (px)")
        self.addParamsLine("   -c <consensus>   : Votes needed (-1 = all pickers)")
        self.addParamsLine("   -o <outFile>     : Output coordinates (.xmd)")
        self.addParamsLine("  [-d <tol=0.1>]    : Distance tolerance as a size fraction")

    def run(self):
        with open(self.getParam("-i")) as f:
            files = [ln.strip() for ln in f if ln.strip()]
        sets = [_read_coords_any(fn) for fn in files]
        size = self.getDoubleParam("-s")
        votes_needed = self.getIntParam("-c")
        if votes_needed < 0:
            votes_needed = len(sets)
        tol = max(self.getDoubleParam("-d") * size if self.checkParam("-d")
                  else 0.1 * size, 1.0)
        filled = [(i, s) for i, s in enumerate(sets) if len(s)]
        pts = np.concatenate([s for _, s in filled]) if filled else \
            np.zeros((0, 2))
        owners = np.concatenate([np.full(len(s), i) for i, s in filled]) \
            if filled else np.zeros(0, int)
        used = np.zeros(len(pts), bool)
        out = []
        for i in range(len(pts)):
            if used[i]:
                continue
            group = (np.linalg.norm(pts - pts[i], axis=1) <= tol) & ~used
            voters = np.unique(owners[group])
            used |= group
            if len(voters) >= votes_needed:
                c = pts[group].mean(axis=0)
                out.append({"xcoor": int(round(c[0])),
                            "ycoor": int(round(c[1])),
                            "enabled": 1, "scoreByVar": float(len(voters))})
        MetaData.fromRows(out).write(self.getParam("-o"))
        if self.verbose:
            print(f"{len(out)} consensus coordinates from {len(sets)} sets")


class ProgPickNoise(XmippProgram):
    name = "xmipp_pick_noise"

    def defineParams(self):
        self.addUsageLine("Pick random coordinates away from existing picks "
                          "(negative examples for training).")
        self.addParamsLine("   -i <mic>        : Micrograph (image file)")
        self.addParamsLine("   -c <coords>     : Already-picked coordinates (.xmd)")
        self.addParamsLine("   -o <outCoords>  : Output noise coordinates (.xmd)")
        self.addParamsLine("   -s <boxSize>    : Box size (px)")
        self.addParamsLine("  [-n <num=-1>]    : How many (-1 = as many as picked)")
        self.addParamsLine("  [--seed <s=0>]   : RNG seed")

    def run(self):
        hdr = Image()
        hdr.read(self.getParam("-i"), header_only=True)
        _, _, H, W = hdr.header.shape
        picked = _read_coords_any(self.getParam("-c"))
        n = self.getIntParam("-n") if self.checkParam("-n") else -1
        if n < 0:
            n = max(len(picked), 1)
        s = self.getIntParam("-s")
        rng = np.random.default_rng(self.getIntParam("--seed")
                                    if self.checkParam("--seed") else 0)
        out = []
        tries = 0
        while len(out) < n and tries < 200 * n:
            tries += 1
            x = rng.integers(s, max(W - s, s + 1))
            y = rng.integers(s, max(H - s, s + 1))
            if len(picked) and np.min(np.linalg.norm(
                    picked - [x, y], axis=1)) < 1.5 * s:
                continue
            out.append({"xcoor": int(x), "ycoor": int(y), "enabled": 1})
        MetaData.fromRows(out).write(self.getParam("-o"))
        if self.verbose:
            print(f"picked {len(out)} noise boxes")


class ProgPreprocessMics(XmippProgram):
    name = "xmipp_preprocess_mics"

    def defineParams(self):
        self.addUsageLine("Preprocess micrographs: downsample, contrast "
                          "inversion, optional CTF phase flipping, "
                          "normalization.")
        self.addParamsLine("   -i <md>          : Metadata with micrograph column (+ optional ctfparam)")
        self.addParamsLine("   -s <sampling>    : Sampling rate (A/px)")
        self.addParamsLine("   -o <outDir>      : Output directory")
        self.addParamsLine("  [-d <down=1>]     : Downsample factor")
        self.addParamsLine("  [--invert_contrast] : Invert contrast")
        self.addParamsLine("  [--phase_flip]    : CTF phase flip (needs ctfparam column)")

    def run(self):
        from xmipp3_tpu_torch.ops.resize import fourier_resize_2d
        dev = resolve_device(self.getParam("--device"))
        outdir = self.getParam("-o")
        os.makedirs(outdir, exist_ok=True)
        down = self.getDoubleParam("-d") if self.checkParam("-d") else 1.0
        rows = []
        for r in MetaData(self.getParam("-i")).iterRows():
            fn = r.get("micrograph", r.get("image"))
            mic = as_tensor(np.squeeze(Image(fn).data).astype(np.float32),
                            dev)
            if self.checkParam("--phase_flip") and r.get("ctfModel"):
                from xmipp3_tpu_torch.ops.ctf import CTFDescription, phase_flip
                mic = phase_flip(mic[None], CTFDescription.from_metadata(
                    r["ctfModel"]))[0]
            if down > 1.0:
                H, W = mic.shape
                mic = fourier_resize_2d(mic[None], int(H / down),
                                        int(W / down))[0]
            if self.checkParam("--invert_contrast"):
                mic = -mic
            mic = (mic - mic.mean()) / torch.clamp(
                mic.std(unbiased=False), min=1e-8)
            out = os.path.join(outdir, os.path.splitext(
                os.path.basename(fn))[0] + ".mrc")
            save_image(out, mic.cpu().numpy())
            d = dict(r)
            d["micrograph"] = out
            rows.append(d)
        MetaData.fromRows(rows).write(os.path.join(outdir,
                                                   "preprocessed_mics.xmd"))
        if self.verbose:
            print(f"{len(rows)} micrographs -> {outdir}")


class ProgVolumeConsensus(XmippProgram):
    name = "xmipp_volume_consensus"

    def defineParams(self):
        self.addUsageLine("Wavelet consensus of several volumes: per "
                          "coefficient keep the minimum-energy agreement "
                          "(reference volume_consensus.py SWT consensus).")
        self.addParamsLine("   -i <listFile> : Text file listing input volumes")
        self.addParamsLine("   -o <volume>   : Output consensus volume")

    def run(self):
        from xmipp3_tpu_torch.ops.denoise import dwt3, idwt3
        dev = resolve_device(self.getParam("--device"))
        with open(self.getParam("-i")) as f:
            files = [ln.strip() for ln in f if ln.strip()]
        vols = [np.squeeze(Image(fn).data).astype(np.float32)
                for fn in files]
        if any(v.shape != vols[0].shape for v in vols):
            raise ValueError("volumes must share dimensions")
        coeffs = [dwt3(v, device=dev) for v in vols]
        cons = []
        for band in range(len(coeffs[0])):
            stack = torch.stack([c[band] for c in coeffs])
            # the coefficient of smallest magnitude keeps only the signal
            # that every volume reproduces
            idx = stack.abs().argmin(dim=0)
            cons.append(stack.gather(0, idx[None])[0])
        save_image(self.getParam("-o"), idwt3(cons).cpu().numpy()
                   .astype(np.float32))
        if self.verbose:
            print(f"consensus of {len(vols)} volumes -> {self.getParam('-o')}")


class ProgCl2dClustering(XmippProgram):
    name = "xmipp_cl2d_clustering"

    def defineParams(self):
        self.addUsageLine("Group similar 2D class averages: rotation/shift-"
                          "invariant features + k-means with silhouette "
                          "model selection.")
        self.addParamsLine("   -i <stack>  : 2D averages (.mrcs)")
        self.addParamsLine("   -o <outDir> : Output directory")
        self.addParamsLine("  [-m <minC=2>]  : Minimum clusters")
        self.addParamsLine("  [-M <maxC=-1>] : Maximum clusters (-1: N/2)")

    def run(self):
        from xmipp3_tpu_torch.ops.polar import cartesian_to_polar
        dev = resolve_device(self.getParam("--device"))
        imgs = Image.read_stack(self.getParam("-i"))
        N = len(imgs)
        # rotation-invariant features: the rings' |FFT| magnitudes
        pol = cartesian_to_polar(as_tensor(imgs, dev), 2).double()
        feat = torch.fft.rfft(pol, dim=-1).abs()[..., :16].reshape(N, -1) \
            .cpu().numpy()
        feat = (feat - feat.mean(0)) / np.maximum(feat.std(0), 1e-8)
        mn = self.getIntParam("-m") if self.checkParam("-m") else 2
        mx = self.getIntParam("-M") if self.checkParam("-M") else -1
        if mx <= 0:
            mx = max(N // 2, mn)
        best = None
        rng = np.random.default_rng(0)
        for k in range(mn, min(mx, N - 1) + 1):
            labels = _kmeans(feat, k, rng, device=dev)
            score = _silhouette(feat, labels, device=dev)
            if best is None or score > best[0]:
                best = (score, k, labels)
        _, k, labels = best
        outdir = self.getParam("-o")
        os.makedirs(outdir, exist_ok=True)
        MetaData.fromRows(
            [{"image": f"{i + 1:06d}@{self.getParam('-i')}",
              "ref": int(labels[i]) + 1} for i in range(N)]).write(
            os.path.join(outdir, "clusters.xmd"))
        avgs = np.stack([imgs[labels == c].mean(axis=0) for c in range(k)])
        save_image(os.path.join(outdir, "cluster_averages.mrcs"),
                   avgs.astype(np.float32))
        self.n_clusters = k
        if self.verbose:
            print(f"{k} clusters (silhouette {best[0]:.3f})")


class ProgAlignPCA2D(XmippProgram):
    name = "xmipp_align_pca_2d"

    def defineParams(self):
        self.addUsageLine("Iteratively align a 2D stack to its average and "
                          "report the PCA eigenimages (alignPCA_2D script).")
        self.addParamsLine("   -i <stack>    : Input images")
        self.addParamsLine("   -o <outDir>   : Output directory")
        self.addParamsLine("  [--iter <n=3>] : Alignment iterations")
        self.addParamsLine("  [--ncomp <c=5>] : PCA components to save")

    def run(self):
        from xmipp3_tpu_torch.models.dimred import empca
        from xmipp3_tpu_torch.ops.align import iterative_align
        dev = resolve_device(self.getParam("--device"))
        imgs = as_tensor(Image.read_stack(self.getParam("-i")), dev)
        it = self.getIntParam("--iter") if self.checkParam("--iter") else 3
        ref = imgs.mean(dim=0)
        aligned = imgs
        with timed_phase("align"):
            for _ in range(it):
                aligned = iterative_align(ref, imgs, n_iters=2)[4]
                ref = aligned.mean(dim=0)
        N = len(imgs)
        d = min(self.getIntParam("--ncomp") if self.checkParam("--ncomp")
                else 5, N - 1)
        aligned = aligned.cpu().numpy()
        with timed_phase("empca"):
            proj, basis, _ = empca(aligned.reshape(N, -1), d=d, n_iters=20,
                                   return_basis=True, device=dev)
        outdir = self.getParam("-o")
        os.makedirs(outdir, exist_ok=True)
        save_image(os.path.join(outdir, "aligned.mrcs"),
                   aligned.astype(np.float32))
        save_image(os.path.join(outdir, "average.mrc"),
                   ref.cpu().numpy().astype(np.float32))
        save_image(os.path.join(outdir, "eigenimages.mrcs"),
                   np.asarray(basis).reshape(d, *imgs.shape[1:])
                   .astype(np.float32))
        MetaData.fromRows(
            [{"image": f"{i + 1:06d}@aligned.mrcs",
              **{f"autoParticles{j + 1}": float(proj[i, j])
                 for j in range(d)}}
             for i in range(N)]).write(os.path.join(outdir, "pca.xmd"))
        if self.verbose:
            print(f"aligned {N} images, {d} eigenimages -> {outdir}")


class ProgGraphMaxCut(XmippProgram):
    name = "xmipp_graph_max_cut"

    def defineParams(self):
        self.addUsageLine("Max-cut bipartition of a similarity graph "
                          "(spectral relaxation + greedy 1-swap refinement).")
        self.addParamsLine("   -i <matrix>  : Weight matrix (text, N x N)")
        self.addParamsLine("   -o <labels>  : Output text labels (0/1 per node)")

    def run(self):
        W = np.loadtxt(self.getParam("-i"), ndmin=2)
        n = len(W)
        W = 0.5 * (W + W.T)
        # spectral: the sign of -W's leading eigenvector
        _, V = np.linalg.eigh(-W)
        x = np.sign(V[:, -1])
        x[x == 0] = 1
        # greedy refinement: flip while a flip raises the cut. A node's
        # gain leaves out its own weight W[i, i]: the reference's keeps it,
        # and with a positive diagonal it flips one node back and forth
        # for ever (ROADMAP.md section 3); with a zero diagonal the two
        # are the same.
        diag = np.diag(W)
        improved = True
        while improved:
            improved = False
            for i in range(n):
                if x[i] * (W[i] @ x) - diag[i] > 1e-12:
                    x[i] = -x[i]
                    improved = True
        np.savetxt(self.getParam("-o"), ((x + 1) // 2).astype(int),
                   fmt="%d")
        self.cut_value = 0.25 * float(np.sum(W) - x @ W @ x)
        if self.verbose:
            print(f"cut value {self.cut_value:.4f}")


class ProgExtractParticles(XmippProgram):
    name = "xmipp_extract_particles"

    def defineParams(self):
        self.addUsageLine("Extract particle boxes from micrographs listed in "
                          "a metadata with per-mic coordinate files.")
        self.addParamsLine("   -i <md>       : Metadata with micrograph + coordinates columns")
        self.addParamsLine("   -s <boxSize>  : Box size (px)")
        self.addParamsLine("   -o <outDir>   : Output directory")
        self.addParamsLine("  [--invert]     : Invert contrast")
        self.addParamsLine("  [--normalize]  : Zero-mean/unit-std particles")

    def run(self):
        dev = resolve_device(self.getParam("--device"))
        b = self.getIntParam("-s")
        half = b // 2
        outdir = self.getParam("-o")
        os.makedirs(outdir, exist_ok=True)
        ar = torch.arange(b, device=dev)
        all_rows = []
        for r in MetaData(self.getParam("-i")).iterRows():
            fn = r.get("micrograph", r.get("image"))
            mic = as_tensor(np.squeeze(Image(fn).data).astype(np.float32),
                            dev)
            H, W = mic.shape
            xy = _read_coords_any(r["coordinates"] if "coordinates" in r
                                  else r["image"]).astype(int)
            inside = [(x, y) for x, y in xy
                      if half <= x < W - half and half <= y < H - half]
            if not inside:
                continue
            x0 = torch.as_tensor([x - half for x, _ in inside], device=dev)
            y0 = torch.as_tensor([y - half for _, y in inside], device=dev)
            # every box in one gather: (n, b, b)
            parts = mic[(y0[:, None] + ar)[:, :, None],
                        (x0[:, None] + ar)[:, None, :]]
            if self.checkParam("--invert"):
                parts = -parts
            if self.checkParam("--normalize"):
                parts = (parts - parts.mean(dim=(1, 2), keepdim=True)) / \
                    torch.clamp(parts.std(dim=(1, 2), unbiased=False,
                                          keepdim=True), min=1e-8)
            stk = os.path.join(outdir, os.path.splitext(
                os.path.basename(fn))[0] + "_particles.mrcs")
            save_image(stk, parts.cpu().numpy())
            all_rows += [{"xcoor": int(x), "ycoor": int(y),
                          "micrograph": fn, "image": f"{k + 1:06d}@{stk}"}
                         for k, (x, y) in enumerate(inside)]
        MetaData.fromRows(all_rows).write(os.path.join(outdir,
                                                       "particles.xmd"))
        if self.verbose:
            print(f"extracted {len(all_rows)} particles")


def _row_ctfs(rows, Ts):
    """One CTFDescription a row from its ctf* labels (the reference's
    defaults where a label is missing)."""
    from xmipp3_tpu_torch.ops.ctf import CTFDescription
    return [CTFDescription(
        sampling_rate=Ts, voltage=float(r.get("ctfVoltage", 300.0)),
        defocusU=float(r.get("ctfDefocusU", 10000.0)),
        defocusV=float(r.get("ctfDefocusV", r.get("ctfDefocusU", 10000.0))),
        azimuthal_angle=float(r.get("ctfDefocusAngle", 0.0)),
        Cs=float(r.get("ctfSphericalAberration", 2.7)),
        Q0=float(r.get("ctfQ0", 0.07))) for r in rows]


class ProgSwiftalignWiener2D(XmippProgram):
    name = "xmipp_swiftalign_wiener_2d"

    def defineParams(self):
        self.addUsageLine("Batched 2D Wiener CTF correction of a particle "
                          "set (swiftalign_wiener_2d role on the jitted "
                          "Wiener op).")
        self.addParamsLine("   -i <md>       : Particles with CTF columns")
        self.addParamsLine("   -o <stack>    : Corrected output stack")
        self.addParamsLine("  [--sampling <s=1>] : Sampling rate (A/px)")
        self.addParamsLine("  [--wc <c=0.1>] : Wiener constant")

    def run(self):
        from xmipp3_tpu_torch.ops.ctf import wiener_filter_2d
        dev = resolve_device(self.getParam("--device"))
        rows = list(MetaData(self.getParam("-i")).iterRows())
        imgs = load_image_rows(rows)
        wc = self.getDoubleParam("--wc") if self.checkParam("--wc") else 0.1
        Ts = self.getDoubleParam("--sampling") if \
            self.checkParam("--sampling") else 1.0
        ctfs = _row_ctfs(rows, Ts)
        out = np.empty_like(imgs)
        chunk = 1024
        with timed_phase("wiener"):
            for i in range(0, len(rows), chunk):
                out[i:i + chunk] = wiener_filter_2d(
                    as_tensor(imgs[i:i + chunk], dev), ctfs[i:i + chunk],
                    wiener_constant=wc).cpu().numpy()
        save_image(self.getParam("-o"), out.astype(np.float32))
        for i, r in enumerate(rows):
            r["image"] = f"{i + 1:06d}@{self.getParam('-o')}"
        MetaData.fromRows(rows).write(
            os.path.splitext(self.getParam("-o"))[0] + ".xmd")
        if self.verbose:
            print(f"Wiener-corrected {len(rows)} particles")


class ProgSwiftalignAligned2DClassification(XmippProgram):
    name = "xmipp_swiftalign_aligned_2d_classification"

    def defineParams(self):
        self.addUsageLine("2D classification of pre-aligned particles: "
                          "EM-PCA features + k-means (swiftalign role).")
        self.addParamsLine("   -i <md>      : Aligned particles")
        self.addParamsLine("   -o <outDir>  : Output directory")
        self.addParamsLine("  [--nClasses <k=4>] : Number of classes")

    def run(self):
        from xmipp3_tpu_torch.models.dimred import empca
        from xmipp3_tpu_torch.ops.geo import apply_md_geometry
        dev = resolve_device(self.getParam("--device"))
        rows = list(MetaData(self.getParam("-i")).iterRows())
        imgs = load_image_rows(rows)
        if any("anglePsi" in r for r in rows):
            get = lambda k: np.array([float(r.get(k, 0.0)) for r in rows],
                                     np.float32)
            imgs = apply_md_geometry(
                imgs, get("anglePsi"), get("shiftX"), get("shiftY"),
                np.array([bool(r.get("flip", 0)) for r in rows]),
                device=dev).cpu().numpy()
        k = self.getIntParam("--nClasses") if self.checkParam("--nClasses") \
            else 4
        N = len(imgs)
        feat = empca(imgs.reshape(N, -1), d=min(10, N - 1), n_iters=15,
                     device=dev)
        labels = _kmeans(feat, min(k, N), np.random.default_rng(0),
                         device=dev)
        outdir = self.getParam("-o")
        os.makedirs(outdir, exist_ok=True)
        save_image(os.path.join(outdir, "classes.mrcs"),
                   np.stack([imgs[labels == c].mean(axis=0)
                             for c in range(labels.max() + 1)])
                   .astype(np.float32))
        out = []
        for i, r in enumerate(rows):
            d = dict(r)
            d["ref"] = int(labels[i]) + 1
            out.append(d)
        MetaData.fromRows(out).write(os.path.join(outdir, "classes.xmd"))
        if self.verbose:
            print(f"{labels.max() + 1} classes of {N} particles")
