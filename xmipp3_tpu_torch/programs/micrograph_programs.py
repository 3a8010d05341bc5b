"""Micrograph programs of the reference package's
programs/micrograph_programs.py: xmipp_micrograph_scissor (particle
extraction, a host crop as in the reference) and
xmipp_micrograph_automatic_picking (template-correlation picking, the
filter-bank invariants, PCA and the two-stage SVM picker with the
reference's mode protocol, micrograph_automatic_picking2.h:61-97 and
.cpp:1778-1824; libsvm is replaced by the random-Fourier-feature SVM of
models/svm.py).

Picking runs on the card unless `--device cpu` is given: the band-pass,
the template correlations, the filter bank, the invariants and the SVMs'
training. Random positions are drawn from numpy Generators on the host as
the reference draws them.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import load_image_rows
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import as_tensor, resolve_device
from xmipp3_tpu_torch.models.svm import (GaussianNB, LinearSVM, RBFSVM,
                                         particle_features)
from xmipp3_tpu_torch.ops.fourier_filter import (apply_fourier_mask_2d,
                                                 band_pass_mask)


def _scissor_cut(mic, coords, Xdim, Ydim, invert, log_trans, fill_borders,
                 Dmin, Dmax):
    """templateScissor (data/micrograph.h:263-327) for a coordinate list:
    window [c - size//2, c - size//2 + size), optional transmitance
    (log10) and inverse normalization, border fill-or-blank."""
    H, W = mic.shape
    irange = 1.0 / max(Dmax - Dmin, 1e-30)
    parts = np.zeros((len(coords), Ydim, Xdim), np.float32)
    ok = np.ones(len(coords), bool)
    for n, (x, y) in enumerate(coords):
        i0 = int(round(y)) - Ydim // 2
        j0 = int(round(x)) - Xdim // 2
        if not fill_borders and (i0 < 0 or i0 + Ydim > H or
                                 j0 < 0 or j0 + Xdim > W):
            ok[n] = False
            continue
        ii = np.clip(np.arange(i0, i0 + Ydim), 0, H - 1)
        jj = np.clip(np.arange(j0, j0 + Xdim), 0, W - 1)
        val = mic[np.ix_(ii, jj)].astype(np.float64)
        if log_trans:
            val = np.where(val < 1, val, np.log10(np.maximum(val, 1e-30)))
            val = ((Dmax - val) if invert else (val - Dmin)) * irange
        elif invert:
            val = (Dmax - val) * irange
        parts[n] = val
    return parts, ok


class ProgMicrographScissor(XmippProgram):
    """Full reference surface micrograph_scissor.cpp:37-208 +
    Micrograph::produce_all_images (data/micrograph.cpp:326-470)."""
    name = "xmipp_micrograph_scissor"

    def defineParams(self):
        self.addUsageLine("Extract (cut out) particles from a micrograph at "
                          "given coordinates.")
        self.addParamsLine("   -i <micrograph>   : Untilted micrograph to "
                           "cut from")
        self.addParamsLine("     alias --untilted;")
        self.addParamsLine("  [--orig <micrograph=\"\">] : Cut from this "
                           "original micrograph instead (coordinates are "
                           "rescaled)")
        self.addParamsLine("  [-o <stack=\"\">]  : Output particle stack "
                           "(+ .xmd with names, micrograph, coordinates)")
        self.addParamsLine("     alias --untiltfn;")
        self.addParamsLine("  [--oroot <root=\"\">] : Alias of -o")
        self.addParamsLine("  [--pos <coords_md=\"\">] : Particle "
                           "coordinates (xcoor/ycoor)")
        self.addParamsLine("     alias --untiltPos;")
        self.addParamsLine("  [--extractNoise <n=-1>] : Extract n noise "
                           "particles instead (-1 = as many as "
                           "coordinates); the pos file is rewritten with "
                           "the noise coordinates")
        self.addParamsLine("   --Xdim <window_X_dim> : Box width (pixels)")
        self.addParamsLine("  [--downsampling <float=1.>] : The positions "
                           "were determined with this downsampling rate")
        self.addParamsLine("  [--Ydim <window_Y_dim=-1>] : Box height "
                           "(default = Xdim)")
        self.addParamsLine("  [--invert] : Invert contrast")
        self.addParamsLine("  [--log] : Take logarithm (compute "
                           "transmitance)")
        self.addParamsLine("  [--appendToStack] : Append to an existing "
                           "output stack instead of overwriting")
        self.addParamsLine("  [--fillBorders] : Fill missing pixels for "
                           "boxes outside the micrograph instead of "
                           "blanking the image")
        self.addParamsLine("  [-t <tilted_micrograph=\"\">] : Tilted "
                           "micrograph for tilt pairs")
        self.addParamsLine("     alias --tilted;")
        self.addParamsLine("  [--tiltfn <stack=\"\">] : Output stack for "
                           "the tilted images")
        self.addParamsLine("  [--tiltAngles <angles_file=\"\">] : Metadata "
                           "with the estimated tilt angles "
                           "(angleY/angleY2/angleTilt)")
        self.addParamsLine("  [--tiltPos <position_file=\"\">] : Tilted "
                           "particle coordinates")
        self.addParamsLine("  [--ctfparam <ctfparam=\"\">] : Metadata with "
                           "CTF parameters, copied into the output rows")

    def _read_coords(self, fn, factor):
        md = MetaData(fn)
        coords, extras = [], []
        for i in md:
            r = md.getRow(i)
            x, y = float(r["xcoor"]), float(r["ycoor"])
            if factor != 1.0:
                x, y = int(x / factor), int(y / factor)
            coords.append((x, y))
            extras.append({k: r[k] for k in ("scoreByVariance",
                                             "scoreByGiniCoeff")
                           if k in r})
        return coords, extras

    def _cut_one(self, fn_mic, fn_pos, fn_out, box, ydim, factor,
                 invert, log_trans, append, fill_borders, extract_noise,
                 n_noise, ctf_row):
        mic = np.squeeze(Image(fn_mic).data).astype(np.float32)
        # --orig: coordinates come from the -i micrograph's frame
        fn_orig = self.getParam("--orig") if self.checkParam("--orig") and \
            self.getParam("--orig") else ""
        src = np.squeeze(Image(fn_orig).data).astype(np.float32) \
            if fn_orig else mic
        scale_x = src.shape[1] / mic.shape[1]
        scale_y = src.shape[0] / mic.shape[0]
        coords, extras = self._read_coords(fn_pos, factor)
        Dmin, Dmax = float(mic.min()), float(mic.max())
        if log_trans:
            if Dmin > 1:
                Dmin = float(np.log10(Dmin))
            if Dmax > 1:
                Dmax = float(np.log10(Dmax))
        if extract_noise:
            # random coords a half-window away from every particle
            # (produce_all_images, micrograph.cpp:403-440)
            rng = np.random.default_rng(0)
            n_out = n_noise if n_noise > 0 else len(coords)
            min_d = ydim // 2
            px = np.array([c[0] for c in coords], float)
            py = np.array([c[1] for c in coords], float)
            noise = []
            H, W = mic.shape
            while len(noise) < n_out:
                x = rng.uniform(box, W - box)
                y = rng.uniform(ydim, H - ydim)
                if len(px) == 0 or not ((np.abs(x - px) < min_d) &
                                        (np.abs(y - py) < min_d)).any():
                    noise.append((int(x), int(y)))
            self._rewrite_pos(fn_pos, noise)
            coords = noise
            extras = [{} for _ in noise]
        cut_coords = [(x * scale_x, y * scale_y) for x, y in coords]
        parts, ok = _scissor_cut(src, cut_coords, box, ydim, invert,
                                 log_trans, fill_borders, Dmin, Dmax)
        if not fn_out.rsplit("/", 1)[-1].count("."):
            fn_out = fn_out + ".stk"
        start = 0
        if append and os.path.exists(fn_out):
            old = Image.read_stack(fn_out)
            parts = np.concatenate([old.astype(np.float32), parts])
            start = len(old)
        save_image(fn_out, parts)
        rows = []
        for n, (x, y) in enumerate(coords):
            mean = float(parts[start + n].mean())
            d = {"image": f"{start + n + 1:06d}@{fn_out}",
                 "micrograph": fn_mic,
                 "xcoor": int(x), "ycoor": int(y),
                 "enabled": 1 if ok[n] else -1,
                 "localAverage": (Dmax - (Dmax - Dmin) * mean)
                 if invert else mean,
                 "itemId": start + n + 1}
            d.update(extras[n])
            if ctf_row:
                d.update(ctf_row)
            rows.append(d)
        MetaData.fromRows(rows).write(fn_out.rsplit(".", 1)[0] + ".xmd")
        if self.verbose:
            print(f"Extracted {len(coords)} particles of {box}x{ydim} "
                  f"from {fn_mic}")

    @staticmethod
    def _rewrite_pos(fn_pos, noise_coords):
        md = MetaData(fn_pos)
        mic_id = None
        for i in md:
            r = md.getRow(i)
            mic_id = r.get("micrographId")
            break
        rows = [{"xcoor": int(x), "ycoor": int(y),
                 **({"micrographId": mic_id} if mic_id is not None else {})}
                for x, y in noise_coords]
        MetaData.fromRows(rows).write(fn_pos)

    def run(self):
        box = self.getIntParam("--Xdim")
        ydim = self.getIntParam("--Ydim")
        if ydim <= 0:
            ydim = box
        factor = self.getDoubleParam("--downsampling")
        invert = self.checkParam("--invert")
        log_trans = self.checkParam("--log")
        append = self.checkParam("--appendToStack")
        fill_borders = self.checkParam("--fillBorders")
        extract_noise = self.checkParam("--extractNoise")
        n_noise = self.getIntParam("--extractNoise") if extract_noise else -1
        fn_out = self.getParam("-o") or self.getParam("--oroot")
        ctf_row = None
        if self.checkParam("--ctfparam") and self.getParam("--ctfparam"):
            ctf_md = MetaData(self.getParam("--ctfparam"))
            ctf_row = {k: v for k, v in
                       ctf_md.getRow(next(iter(ctf_md))).items()
                       if str(k).startswith("ctf")}
        pair_mode = self.checkParam("-t") and self.getParam("-t")
        self._cut_one(self.getParam("-i"), self.getParam("--pos"), fn_out,
                      box, ydim, factor, invert, log_trans, append,
                      fill_borders, extract_noise and not pair_mode,
                      n_noise, ctf_row)
        if pair_mode:
            # tilt angles are read for reporting; the rotation is not
            # applied (commented out in the reference,
            # micrograph.cpp:456 `// if (ang!=0) I().rotate(-ang);`)
            if self.getParam("--tiltAngles") and self.verbose:
                amd = MetaData(self.getParam("--tiltAngles"))
                r = amd.getRow(next(iter(amd)))
                print(f"Angle from Y axis to tilt axis "
                      f"{r.get('angleY', 0.0)}")
            self._cut_one(self.getParam("-t"), self.getParam("--tiltPos"),
                          self.getParam("--tiltfn"), box, ydim, factor,
                          invert, log_trans, append, fill_borders, False,
                          -1, ctf_row)


class ProgMicrographAutomaticPicking(XmippProgram):
    """Template-correlation picking with an optional SVM second stage, and
    the reference's Scipion mode protocol (buildinv -> train ->
    try/autoselect). On the card: the band-pass and the template
    correlations (rfft2 products), the filter bank (one rfft2 of the
    micrograph, the bands' irfft2 in batches), the boxes' gather and
    their invariants (batched polar ring spectra), and the SVMs'
    training. The greedy peak loops read the score map to the host once
    and run there in numpy, as in the reference; the PCA, the bases and
    the decisions stay in host numpy too."""
    name = "xmipp_micrograph_automatic_picking"

    #: complex spectrum bytes one batch of filter-bank bands may hold
    BANK_BYTES = 1 << 31

    def defineParams(self):
        self.addUsageLine("Automatic particle picking by template correlation "
                          "(train with --ref particles or pick by blob "
                          "detection).")
        self.addParamsLine("   -i <micrograph>  : Input micrograph")
        self.addParamsLine("  [-o <coords_md=\"\">] : Output coordinates "
                           "(mode-less picking; modes use --outputRoot)")
        self.addParamsLine("   --particleSize <s> : Particle diameter (px)")
        self.addParamsLine("  [--ref <stack=\"\">] : Reference particles/templates")
        self.addParamsLine("  [--thr <t=3.0>]   : Peak threshold (sigma over background)")
        self.addParamsLine("  [--max_peaks <n=500>] : Maximum number of picks")
        self.addParamsLine("  [--svm <model=\"\">]  : SVM model for the second classification stage (candidates are kept only if the SVM accepts them)")
        self.addParamsLine("  [--trainSVM]      : Train the --svm model from --trainPos/--trainNeg and exit")
        self.addParamsLine("  [--kernel <k=rbf>] : SVM kernel for training: rbf (random-Fourier-feature C-SVC, the reference libsvm equivalent) or linear")
        self.addParamsLine("  [--fastBayes]     : Also train/use a Gaussian naive-Bayes fast-rejection stage before the SVM (reference two-stage classifier, micrograph_automatic_picking2.h:61-97)")
        self.addParamsLine("  [--trainPos <md=\"\">] : Positive training particles")
        self.addParamsLine("  [--trainNeg <md=\"\">] : Negative training particles")
        # --- reference Scipion-facing mode protocol
        # (micrograph_automatic_picking2.cpp:1778-1804)
        self.addParamsLine("  [--mode <m=\"\"> <posfile=\"\">] : Operation "
                           "mode: try | train | autoselect | "
                           "buildinv <posfile>")
        self.addParamsLine("  [--model <root=\"\">] : Model rootname "
                           "(PCA bases + templates + SVM classifiers)")
        self.addParamsLine("  [--outputRoot <root=\"\">] : Output rootname "
                           "for .pos / feature-vector files")
        self.addParamsLine("  [--NPCA <n=4>]       : PCA components per "
                           "filter-bank channel")
        self.addParamsLine("  [--NCORR <n=2>]      : Template-correlation "
                           "features")
        self.addParamsLine("  [--filter_num <n=6>] : Filters in the "
                           "raised-cosine band-pass bank")
        self.addParamsLine("  [--fast]             : Fast preprocessing "
                           "(single band-pass instead of the full bank)")
        self.addParamsLine("  [--autoPercent <n=90>] : Percentage of "
                           "candidate peaks kept for classification")

    # ---------------------------------------------------------------
    # The reference's mode protocol: buildinv -> train -> try/autoselect.
    # ---------------------------------------------------------------

    def _read_mic(self):
        with timed_phase("read micrograph"):
            return np.squeeze(Image(self.getParam("-i")).data).astype(
                np.float32)

    def _bank(self, mic):
        """(F, H, W) raised-cosine band-pass bank on the card,
        filterBankGenerator (w1 = 0.025 i, w2 = w1 + 0.025, raised_w =
        0.02); --fast takes the single particle-scale band-pass of the
        reference's fast path. One rfft2 of the micrograph; the bands'
        irfft2 run as batches of at most BANK_BYTES of spectra."""
        H, W = mic.shape
        if self.checkParam("--fast"):
            size = self.getIntParam("--particleSize")
            masks = [band_pass_mask(H, W, 1.0 / size,
                                    min(0.45, 4.0 / size), 0.02)]
        else:
            fnum = self.getIntParam("--filter_num")
            masks = [band_pass_mask(H, W, 0.025 * i, 0.025 * i + 0.025,
                                    0.02) for i in range(fnum)]
        with timed_phase("filter bank"):
            F = torch.fft.rfft2(as_tensor(mic, self.dev))
            per = max(1, self.BANK_BYTES // (F.numel() * 8))
            out = torch.empty((len(masks), H, W), device=self.dev)
            for s in range(0, len(masks), per):
                mk = torch.as_tensor(np.stack(masks[s:s + per]),
                                     device=self.dev)
                out[s:s + len(mk)] = torch.fft.irfft2(F * mk, s=(H, W))
        return out

    def _extract_boxes(self, chans, coords, box):
        """(N, F, box, box) channel boxes at integer centers (those a half
        box inside the frame), gathered in one indexing of `chans` (a
        tensor or a numpy array), and the centers kept."""
        half = box // 2
        C, H, W = chans.shape
        kept = []
        for (x, y) in coords:
            x, y = int(round(x)), int(round(y))
            if half <= x < W - half and half <= y < H - half:
                kept.append((x, y))
        if not kept:
            z = np.zeros((0, C, box, box), np.float32)
            return (z if isinstance(chans, np.ndarray)
                    else torch.as_tensor(z, device=chans.device)), []
        xy = np.asarray(kept)
        r = np.arange(box) - half
        iy = (xy[:, 1, None] + r)[:, :, None]
        ix = (xy[:, 0, None] + r)[:, None, :]
        if isinstance(chans, torch.Tensor):
            iy = torch.as_tensor(iy, device=chans.device)
            ix = torch.as_tensor(ix, device=chans.device)
            return chans[:, iy, ix].transpose(0, 1).contiguous(), kept
        return np.ascontiguousarray(
            chans[:, iy, ix].transpose(1, 0, 2, 3)).astype(np.float32), kept

    def _invariants(self, chan_boxes):
        """Rotation-invariant features of each channel box, batched on the
        boxes' device: polar ring means and the first 6 ring-FFT
        magnitudes. Returns host (N, F, D) float32."""
        from xmipp3_tpu_torch.ops.polar import cartesian_to_polar
        N, F, H, W = chan_boxes.shape
        flat = as_tensor(chan_boxes, self.dev).reshape(N * F, H, W)
        mu = flat.mean(dim=(1, 2), keepdim=True)
        sd = torch.clamp_min(flat.std(dim=(1, 2), correction=0,
                                      keepdim=True), 1e-8)
        pol = cartesian_to_polar((flat - mu) / sd, 2)
        spec = torch.abs(torch.fft.rfft(pol, dim=-1))[..., :6]
        feats = torch.cat([pol.mean(dim=-1), spec.reshape(N * F, -1)], 1)
        return feats.reshape(N, F, -1).cpu().numpy().astype(np.float32)

    def _model_paths(self, root):
        return {"training": root + "_training.npz",
                "pca": root + "_pca.npz",
                "svm": root + "_svm",
                "svm2": root + "_svm2",
                "avg": root + "_particle_avg.mrc"}

    def _negatives_from(self, mic, pos_coords, box, n_neg):
        """Random positions far from every positive (the reference's
        extractNonParticles: negatives at > particle radius), drawn from
        numpy's default_rng(0) as the reference draws them."""
        rng = np.random.default_rng(0)
        H, W = mic.shape
        half = box // 2
        pts = np.asarray(pos_coords, float) if pos_coords else \
            np.zeros((0, 2))
        out = []
        tries = 0
        while len(out) < n_neg and tries < n_neg * 50:
            tries += 1
            x = rng.integers(half, W - half)
            y = rng.integers(half, H - half)
            if len(pts) and (np.hypot(pts[:, 0] - x, pts[:, 1] - y)
                             < box).any():
                continue
            out.append((int(x), int(y)))
        return out

    def _mode_buildinv(self, posfile):
        mic = self._read_mic()
        box = self.getIntParam("--particleSize")
        paths = self._model_paths(self.getParam("--model"))
        md = MetaData(posfile)
        pos_coords = [(float(r["xcoor"]), float(r["ycoor"]))
                      for r in md.iterRows()]
        chans = self._bank(mic)
        with timed_phase("invariants"):
            pb, pos_kept = self._extract_boxes(chans, pos_coords, box)
            neg_coords = self._negatives_from(mic, pos_kept, box,
                                              max(len(pos_kept), 8))
            nb, _ = self._extract_boxes(chans, neg_coords, box)
            inv_p = self._invariants(pb)
            inv_n = self._invariants(nb)
        del chans
        raw_p, _ = self._extract_boxes(mic[None], pos_coords, box)
        if os.path.exists(paths["training"]):
            z = np.load(paths["training"])
            inv_p = np.concatenate([z["inv_pos"], inv_p])
            inv_n = np.concatenate([z["inv_neg"], inv_n])
            avg_sum = z["avg_sum"] + raw_p[:, 0].sum(axis=0)
            avg_n = int(z["avg_n"]) + len(raw_p)
            res = np.concatenate([z["reservoir"],
                                  raw_p[:, 0]])[:512]
        else:
            avg_sum = raw_p[:, 0].sum(axis=0)
            avg_n = len(raw_p)
            res = raw_p[:512, 0]
        np.savez(paths["training"], inv_pos=inv_p, inv_neg=inv_n,
                 avg_sum=avg_sum, avg_n=avg_n, reservoir=res)
        if self.verbose:
            print(f"buildinv: {len(inv_p)} positives / {len(inv_n)} "
                  f"negatives accumulated")

    def _pca_project(self, inv, pca):
        """(N, F, D) -> (N, F*NPCA) projection (host einsum)."""
        mean = pca["mean"]                       # (F, D)
        basis = pca["basis"]                     # (F, NPCA, D)
        return np.einsum("nfd,fkd->nfk", inv - mean[None],
                         basis).reshape(len(inv), -1)

    def _mode_train(self):
        paths = self._model_paths(self.getParam("--model"))
        z = np.load(paths["training"])
        inv_p, inv_n = z["inv_pos"], z["inv_neg"]
        npca = self.getIntParam("--NPCA")
        ncorr = self.getIntParam("--NCORR")
        allinv = np.concatenate([inv_p, inv_n])          # (N, F, D)
        mean = allinv.mean(axis=0)                       # (F, D)
        basis = []
        for f in range(allinv.shape[1]):
            X = allinv[:, f] - mean[f]
            _, _, vt = np.linalg.svd(X, full_matrices=False)
            basis.append(vt[:npca])
        basis = np.stack(basis)                          # (F, NPCA, D)
        avg = (z["avg_sum"] / max(int(z["avg_n"]), 1)).astype(np.float32)
        # NCORR templates: the particle average and the top eigen-boxes of
        # the reservoir (the reference's rotational-PCA templates)
        res = z["reservoir"].reshape(len(z["reservoir"]), -1)
        res = res - res.mean(axis=0)
        _, _, vt = np.linalg.svd(res, full_matrices=False)
        templates = np.concatenate(
            [avg[None], vt[:max(ncorr - 1, 0)].reshape(-1, *avg.shape)])
        templates = templates[:ncorr] if ncorr > 0 else templates[:1]
        np.savez(paths["pca"], mean=mean, basis=basis, templates=templates)
        save_image(paths["avg"], avg)
        pca = {"mean": mean, "basis": basis}
        Xp = self._pca_project(inv_p, pca)
        Xn = self._pca_project(inv_n, pca)
        X = np.concatenate([Xp, Xn])
        y = np.concatenate([np.ones(len(Xp)), np.zeros(len(Xn))])
        with timed_phase("train svm"):
            svm = RBFSVM(device=self.dev).fit(X, y)
        svm.save(paths["svm"])
        acc = ((svm.predict(X) > 0).astype(int) == y).mean()
        self.train_accuracy = float(acc)
        # second classifier: particles against the user's corrected false
        # positives
        root = self.getParam("--outputRoot")
        fn_fp = (root + "_false_positives.xmd") if root else ""
        if fn_fp and os.path.exists(fn_fp):
            mic = self._read_mic()
            box = self.getIntParam("--particleSize")
            fp_md = MetaData(fn_fp)
            fp_coords = [(float(r["xcoor"]), float(r["ycoor"]))
                         for r in fp_md.iterRows()]
            chans = self._bank(mic)
            fb, _ = self._extract_boxes(chans, fp_coords, box)
            del chans
            if len(fb):
                Xf = self._pca_project(self._invariants(fb), pca)
                X2 = np.concatenate([Xp, Xf])
                y2 = np.concatenate([np.ones(len(Xp)), np.zeros(len(Xf))])
                with timed_phase("train svm"):
                    RBFSVM(device=self.dev).fit(X2, y2).save(paths["svm2"])
        # config.xmd beside the model (read back by autoselect,
        # micrograph_automatic_picking2.cpp:1820-1822)
        cfgdir = os.path.dirname(self.getParam("--model")) or "."
        MetaData.fromRows([{"pickingAutopickpercent":
                            self.getIntParam("--autoPercent")}]).write(
            os.path.join(cfgdir, "config.xmd"))
        if self.verbose:
            print(f"train: SVM on {len(y)} invariants "
                  f"(train accuracy {acc:.3f})")

    def _correlate(self, mic_dev, templates):
        """max over templates of the circular correlation of mic_dev with
        each template's zero-padded, normalised copy, rolled to the box's
        centre: rfft2 products on the card, one template's spectrum at a
        time. Returns the score map on the host."""
        H, W = mic_dev.shape
        fm = torch.fft.rfft2(mic_dev)
        score = None
        for t in templates:
            th, tw = t.shape
            tt = torch.zeros((H, W), device=self.dev)
            tt[:th, :tw] = as_tensor(
                (t - t.mean()) / max(t.std(), 1e-8), self.dev)
            corr = torch.fft.irfft2(fm * torch.conj(torch.fft.rfft2(tt)),
                                    s=(H, W))
            corr = torch.roll(corr, (th // 2, tw // 2), dims=(0, 1))
            score = corr if score is None else torch.maximum(score, corr)
        return score.cpu().numpy()

    def _mode_autoselect(self, write_features=False):
        paths = self._model_paths(self.getParam("--model"))
        mic = self._read_mic()
        box = self.getIntParam("--particleSize")
        pz = np.load(paths["pca"])
        pca = {"mean": pz["mean"], "basis": pz["basis"]}
        templates = pz["templates"]
        svm = RBFSVM.load(paths["svm"], device=self.dev)
        svm2 = RBFSVM.load(paths["svm2"], device=self.dev) \
            if os.path.exists(paths["svm2"] + ".npz") else None
        auto_pct = self.getIntParam("--autoPercent")
        H, W = mic.shape
        # candidates: the particle average correlated with the micrograph
        # (convolveAvgFilterBank), local maxima above the score
        # percentile of (100 - autoPercent) / 4
        avg = templates[0]
        with timed_phase("correlate"):
            corr = self._correlate(as_tensor(mic - mic.mean(), self.dev),
                                   [avg[:box, :box]])
        s = corr.copy()
        half = box // 2
        with timed_phase("peaks"):
            thr = np.percentile(corr, 100 - min(max(auto_pct, 1), 99)
                                * 0.25)
            cands = []
            for _ in range(800):
                idx = np.argmax(s)
                y, x = divmod(int(idx), W)
                if s[y, x] < thr:
                    break
                if half <= x < W - half and half <= y < H - half:
                    cands.append((x, y))
                s[max(y - half, 0):y + half, max(x - half, 0):x + half] = \
                    -np.inf
        chans = self._bank(mic)
        rows = []
        feats_out = []
        with timed_phase("classify"):
            cb, kept = self._extract_boxes(chans, cands, box)
            del chans
            if len(cb):
                Xc = self._pca_project(self._invariants(cb), pca)
                dec = svm.decision(Xc)
                ok = dec > 0
                if svm2 is not None:
                    ok &= svm2.decision(Xc) > 0
                for i, (x, y) in enumerate(kept):
                    if ok[i]:
                        rows.append({"xcoor": x, "ycoor": y,
                                     "cost": float(dec[i])})
                        feats_out.append(Xc[i])
        root = self.getParam("--outputRoot")
        MetaData.fromRows(rows).write(
            f"particles_auto@{root}.pos" if root else self.getParam("-o"))
        if write_features and root:
            with open(root + "_auto_feature_vectors.txt", "w") as fh:
                fh.write(f"{len(feats_out)} "
                         f"{len(feats_out[0]) if feats_out else 0}\n")
                for v in feats_out:
                    fh.write("1\n" + " ".join(f"{x:g}" for x in v) + "\n")
        self.n_picked = len(rows)
        if self.verbose:
            print(f"autoselect: {len(rows)} particles")

    def run(self):
        self.dev = resolve_device(self.getParam("--device"))
        if self.checkParam("--mode") and self.getParam("--mode"):
            mode = self.getParam("--mode")
            if mode == "buildinv":
                self._mode_buildinv(self.getParam("--mode", 1))
            elif mode == "train":
                self._mode_train()
            elif mode == "try":
                self._mode_autoselect(write_features=True)
            elif mode == "autoselect":
                self._mode_autoselect()
            else:
                raise XmippError(ErrCode.ARG_INCORRECT,
                                 f"unknown --mode {mode}")
            return
        if self.checkParam("--trainSVM"):
            self._train_svm()
            return
        mic = self._read_mic()
        size = self.getIntParam("--particleSize")
        thr = self.getDoubleParam("--thr")
        max_peaks = self.getIntParam("--max_peaks")
        H, W = mic.shape
        # band-pass to particle scale (DoG-style)
        f_lo = 1.0 / (2.0 * size)
        f_hi = 1.0 / (0.5 * size)
        with timed_phase("filter"):
            filt = apply_fourier_mask_2d(
                mic - mic.mean(), band_pass_mask(H, W, f_lo, min(f_hi, 0.45)),
                device=self.dev)
        if self.checkParam("--ref") and self.getParam("--ref"):
            refs = Image.read_stack(self.getParam("--ref"))
            # template matching: max over templates of the normalised
            # correlation
            with timed_phase("correlate"):
                score = self._correlate(filt, refs)
        else:
            # particles darker than the background by convention
            score = (-filt).cpu().numpy()
        del filt
        mu, sd = score.mean(), score.std()
        peaks = []
        s = score.copy()
        half = size // 2
        with timed_phase("peaks"):
            for _ in range(max_peaks):
                idx = np.argmax(s)
                y, x = divmod(int(idx), W)
                if s[y, x] < mu + thr * sd:
                    break
                if half <= x < W - half and half <= y < H - half:
                    peaks.append((x, y, float(s[y, x])))
                # suppress the neighbourhood
                y0, y1 = max(y - half, 0), min(y + half, H)
                x0, x1 = max(x - half, 0), min(x + half, W)
                s[y0:y1, x0:x1] = -np.inf
        # SVM second stage: classify the candidates' boxes, keep the
        # accepted ones (correlation candidates -> SVM)
        if self.checkParam("--svm") and self.getParam("--svm") and peaks:
            fn_model = self.getParam("--svm")
            fz = fn_model if fn_model.endswith(".npz") else fn_model + ".npz"
            z = np.load(fz, allow_pickle=True)
            svm = RBFSVM.load(fn_model, device=self.dev) \
                if "kind" in z.files and str(z["kind"]) == "rbf" \
                else LinearSVM.load(fn_model, device=self.dev)
            nb = None
            if os.path.exists(fn_model + "_nb.npz"):
                nb = GaussianNB.load(fn_model + "_nb.npz")
            boxes = []
            kept_idx = []
            for i, (x, y, c) in enumerate(peaks):
                if half <= x < W - half and half <= y < H - half:
                    boxes.append(mic[y - half:y - half + 2 * half,
                                     x - half:x - half + 2 * half])
                    kept_idx.append(i)
            if boxes:
                with timed_phase("classify"):
                    feats = particle_features(np.stack(boxes),
                                              device=self.dev)
                    ok = np.asarray(svm.predict(feats)) > 0
                    if nb is not None:
                        # fast-rejection stage: candidates the naive Bayes
                        # calls noise are dropped with the SVM's verdict
                        ok &= np.asarray(nb.predict(feats)) > 0
                peaks = [peaks[kept_idx[j]] for j in range(len(boxes))
                         if ok[j]]
        MetaData.fromRows([
            {"xcoor": x, "ycoor": y, "cost": c, "itemId": i + 1}
            for i, (x, y, c) in enumerate(peaks)]).write(self.getParam("-o"))
        if self.verbose:
            print(f"Picked {len(peaks)} particles")
        self.n_picked = len(peaks)

    def _train_svm(self):
        pos = load_image_rows(list(MetaData(
            self.getParam("--trainPos")).iterRows()))
        neg = load_image_rows(list(MetaData(
            self.getParam("--trainNeg")).iterRows()))
        X = particle_features(np.concatenate([pos, neg]), device=self.dev)
        y = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
        kind = self.getParam("--kernel")
        with timed_phase("train svm"):
            svm = (RBFSVM(device=self.dev) if kind == "rbf"
                   else LinearSVM(device=self.dev)).fit(X, y)
        svm.save(self.getParam("--svm"))
        if self.checkParam("--fastBayes"):
            GaussianNB().fit(X, y).save(self.getParam("--svm") + "_nb")
        pred = svm.predict(X)
        acc = ((pred > 0).astype(int) == y).mean()
        self.train_accuracy = float(acc)
        if self.verbose:
            print(f"{kind} SVM trained on {len(y)} boxes "
                  f"(train accuracy {acc:.3f}) -> {self.getParam('--svm')}")


PROGRAM = None
