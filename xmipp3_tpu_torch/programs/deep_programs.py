"""The deep_* programs of the reference package's programs/deep_programs.py
on the port's torch.nn networks (models/deep.py): the same command lines,
train and predict, the same output files.

- deep_consensus: particle-vs-noise box classifier;
- deep_micrograph_cleaner: per-patch micrograph scoring -> mask;
- deep_hand: handedness classifier on whole volumes;
- deepRes_resolution: local-resolution regression from volume patches;
- deep_global_assignment (+ _predict): projection-direction regression;
- deep_misalignment_detection: aligned-vs-misaligned subtomogram
  classifier;
- deep_volume_postprocessing: volume-to-volume residual U-net.

Images are read, normalised (float32, per image) and cut into patches on
the host, as in the reference; training and inference run on the card
unless `--device cpu` is given, in full float32. A model file holds the
flax parameter tree as numpy arrays (models/deep.py). The class
probabilities are the softmax of the logits in its stable form: the
reference's exp(l1) / sum(exp(l)) gives the same values and overflows to
nan once a logit passes about 88 (ROADMAP.md section 3).
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.metadata_program import load_image_rows
from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.core.timing import timed_phase
from xmipp3_tpu_torch.device import fp32_products, resolve_device


def _norm(x):
    x = np.asarray(x, np.float32)
    ax = tuple(range(1, x.ndim))
    mu = x.mean(axis=ax, keepdims=True)
    sd = x.std(axis=ax, keepdims=True)
    return (x - mu) / np.maximum(sd, 1e-8)


def _prob_of_class1(logits):
    """softmax(logits)[:, 1], in the stable form."""
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return e[:, 1] / e.sum(axis=1)


class _DeepBase(XmippProgram):
    def _common_params(self):
        self.addParamsLine("  [--model <path=model.pkl>] : Model file (written in train mode, read otherwise)")
        self.addParamsLine("  [--train]          : Train a model")
        self.addParamsLine("  [--epochs <e=20>]  : Training epochs")
        self.addParamsLine("  [--lr <l=0.001>]   : Learning rate")

    def _train_args(self):
        return dict(n_epochs=self.getIntParam("--epochs")
                    if self.checkParam("--epochs") else 20,
                    lr=self.getDoubleParam("--lr")
                    if self.checkParam("--lr") else 1e-3,
                    verbose=self.verbose, device=self.device)

    def _model_path(self):
        return self.getParam("--model") if self.checkParam("--model") \
            else "model.pkl"

    def _train_and_save(self, model, kind, X, y, loss_kind):
        from xmipp3_tpu_torch.models.deep import save_params, train_model
        with timed_phase("train"):
            model, hist = train_model(model, X, y, loss_kind,
                                      **self._train_args())
        save_params(self._model_path(), kind, model)
        self.loss_history = hist
        if self.verbose:
            print(f"trained: loss {hist[0]:.3f} -> {hist[-1]:.3f}")

    def _predict(self, model, X):
        from xmipp3_tpu_torch.models.deep import load_params, predict
        load_params(self._model_path(), model)
        with timed_phase("predict"):
            return predict(model, X, device=self.device)

    @property
    def device(self):
        return resolve_device(self.getParam("--device"))


def _labelled(pos, neg):
    X = np.concatenate([pos, neg])
    y = np.concatenate([np.ones(len(pos), np.int32),
                        np.zeros(len(neg), np.int32)])
    return X, y


class ProgDeepConsensus(_DeepBase):
    name = "xmipp_deep_consensus"

    def defineParams(self):
        self.addUsageLine("Particle-picking consensus CNN: train on "
                          "positive particle boxes + noise boxes, then "
                          "score candidate particles.")
        self.addParamsLine("   -i <md>          : Candidate particles (metadata with image column)")
        self.addParamsLine("  [-o <md=scored.xmd>] : Scored output")
        self.addParamsLine("  [--posTrain <md=\"\">] : Positive training particles")
        self.addParamsLine("  [--negTrain <md=\"\">] : Negative (noise) training particles")
        self._common_params()

    def run(self):
        from xmipp3_tpu_torch.models.deep import ConvNet2D
        model = ConvNet2D(n_out=2)
        if self.checkParam("--train"):
            pos = _norm(load_image_rows(list(MetaData(
                self.getParam("--posTrain")).iterRows())))
            neg = _norm(load_image_rows(list(MetaData(
                self.getParam("--negTrain")).iterRows())))
            self._train_and_save(model, "ConvNet2D", *_labelled(pos, neg),
                                 "xent")
        rows = list(MetaData(self.getParam("-i")).iterRows())
        p = _prob_of_class1(self._predict(model, _norm(load_image_rows(
            rows))))
        out = []
        for i, r in enumerate(rows):
            d = dict(r)
            d["zScoreDeepLearning1"] = float(p[i])
            d["enabled"] = 1 if p[i] > 0.5 else -1
            out.append(d)
        MetaData.fromRows(out).write(self.getParam("-o")
                                     if self.checkParam("-o")
                                     else "scored.xmd")
        self.scores = p
        if self.verbose:
            print(f"scored {len(p)} candidates; {int((p > .5).sum())} kept")


class ProgDeepMicrographCleaner(_DeepBase):
    name = "xmipp_deep_micrograph_cleaner"

    def defineParams(self):
        self.addUsageLine("Score micrograph patches (carbon/contamination "
                          "vs clean ice) and write a mask.")
        self.addParamsLine("   -i <mic>        : Micrograph")
        self.addParamsLine("  [-o <mask=mask.mrc>] : Output goodness mask (1 = clean)")
        self.addParamsLine("  [--boxSize <b=64>] : Patch size")
        self.addParamsLine("  [--goodTrain <md=\"\">] : Clean training patches")
        self.addParamsLine("  [--badTrain <md=\"\">]  : Contaminated training patches")
        self._common_params()

    def run(self):
        from xmipp3_tpu_torch.models.deep import ConvNet2D
        model = ConvNet2D(n_out=2)
        b = self.getIntParam("--boxSize") if self.checkParam("--boxSize") \
            else 64
        if self.checkParam("--train"):
            good = _norm(load_image_rows(list(MetaData(
                self.getParam("--goodTrain")).iterRows())))
            bad = _norm(load_image_rows(list(MetaData(
                self.getParam("--badTrain")).iterRows())))
            self._train_and_save(model, "ConvNet2D", *_labelled(good, bad),
                                 "xent")
        mic = np.squeeze(Image(self.getParam("-i")).data).astype(np.float32)
        H, W = mic.shape
        ys = list(range(0, H - b + 1, b // 2)) or [0]
        xs = list(range(0, W - b + 1, b // 2)) or [0]
        patches = np.stack([mic[y:y + b, x:x + b] for y in ys for x in xs])
        p = _prob_of_class1(self._predict(model, _norm(patches)))
        mask = np.zeros((H, W), np.float32)
        wsum = np.zeros((H, W), np.float32)
        k = 0
        for y in ys:
            for x in xs:
                mask[y:y + b, x:x + b] += p[k]
                wsum[y:y + b, x:x + b] += 1
                k += 1
        mask /= np.maximum(wsum, 1)
        save_image(self.getParam("-o") if self.checkParam("-o")
                   else "mask.mrc", mask)
        self.mask = mask
        if self.verbose:
            print(f"mean cleanliness {mask.mean():.3f}")


class ProgDeepHand(_DeepBase):
    name = "xmipp_deep_hand"

    def defineParams(self):
        self.addUsageLine("Predict volume handedness (deep_hand role). "
                          "Chirality is a 3D property (a mirrored 2D slice "
                          "is just another in-plane pose), so the classifier "
                          "is a 3D CNN on the whole volume, trained on "
                          "correct volumes vs their mirrors with z-rotation "
                          "augmentation.")
        self.addParamsLine("   -i <vol>       : Input volume")
        self.addParamsLine("  [-o <txt=hand.txt>] : Output (probability the hand is correct)")
        self.addParamsLine("  [--trainVols <md=\"\">] : Metadata listing correctly-handed volumes for training")
        self._common_params()

    @staticmethod
    def _augment(vol):
        """4 z-rotations (k*90 deg) of the volume: chirality-preserving."""
        return [np.rot90(vol, k, axes=(1, 2)) for k in range(4)]

    def run(self):
        from xmipp3_tpu_torch.models.deep import ConvNet3D
        model = ConvNet3D(n_out=2)
        if self.checkParam("--train"):
            X, y = [], []
            for r in MetaData(self.getParam("--trainVols")).iterRows():
                v = np.squeeze(Image(r["image"]).data).astype(np.float32)
                X += self._augment(v)
                y += [1] * 4
                X += self._augment(v[:, :, ::-1])   # mirror = wrong hand
                y += [0] * 4
            self._train_and_save(model, "ConvNet3D", _norm(np.stack(X)),
                                 np.asarray(y, np.int32), "xent")
        vol = np.squeeze(Image(self.getParam("-i")).data).astype(np.float32)
        p = float(np.mean(_prob_of_class1(self._predict(
            model, _norm(np.stack(self._augment(vol)))))))
        out = self.getParam("-o") if self.checkParam("-o") else "hand.txt"
        with open(out, "w") as f:
            f.write(f"{p:.6f}\n")
        self.hand_prob = p
        if self.verbose:
            print(f"P(correct hand) = {p:.3f}")


class ProgDeepResResolution(_DeepBase):
    name = "xmipp_deepRes_resolution"

    def defineParams(self):
        self.addUsageLine("Local resolution by regression on volume patches "
                          "(deepRes role).")
        self.addParamsLine("   -i <vol>       : Input volume")
        self.addParamsLine("  [-o <vol=deepres.mrc>] : Local resolution map")
        self.addParamsLine("  [--sampling <s=1>] : Sampling (A/px)")
        self.addParamsLine("  [--trainVols <md=\"\">] : Training metadata: image + resolution columns")
        self.addParamsLine("  [--patch <p=16>] : Patch size")
        self._common_params()

    def run(self):
        from xmipp3_tpu_torch.models.deep import ConvNet3D
        model = ConvNet3D(n_out=1)
        p_sz = self.getIntParam("--patch") if self.checkParam("--patch") \
            else 16
        if self.checkParam("--train"):
            X, y = [], []
            for r in MetaData(self.getParam("--trainVols")).iterRows():
                v = np.squeeze(Image(r["image"]).data).astype(np.float32)
                res = float(r["resolution"])
                rng = np.random.default_rng(len(X))
                for _ in range(16):
                    z, yy, xx = (rng.integers(0, s - p_sz + 1)
                                 for s in v.shape)
                    X.append(v[z:z + p_sz, yy:yy + p_sz, xx:xx + p_sz])
                    y.append([res])
            self._train_and_save(model, "ConvNet3D", _norm(np.stack(X)),
                                 np.asarray(y, np.float32), "mse")
        vol = np.squeeze(Image(self.getParam("-i")).data).astype(np.float32)
        Z, Y, X_ = vol.shape
        step = p_sz // 2
        out = np.zeros_like(vol)
        wsum = np.zeros_like(vol)
        patches, spots = [], []
        for z in range(0, Z - p_sz + 1, step):
            for yy in range(0, Y - p_sz + 1, step):
                for xx in range(0, X_ - p_sz + 1, step):
                    patches.append(vol[z:z + p_sz, yy:yy + p_sz,
                                       xx:xx + p_sz])
                    spots.append((z, yy, xx))
        vals = self._predict(model, _norm(np.stack(patches)))[:, 0]
        for (z, yy, xx), v in zip(spots, vals):
            out[z:z + p_sz, yy:yy + p_sz, xx:xx + p_sz] += v
            wsum[z:z + p_sz, yy:yy + p_sz, xx:xx + p_sz] += 1
        out /= np.maximum(wsum, 1)
        save_image(self.getParam("-o") if self.checkParam("-o")
                   else "deepres.mrc", out.astype(np.float32))
        self.resmap = out
        if self.verbose:
            print(f"local resolution {out.mean():.2f} "
                  f"({out.min():.2f}..{out.max():.2f})")


def _dir_to_s2(rot_deg, tilt_deg):
    r = np.deg2rad(np.asarray(rot_deg, np.float64))
    t = np.deg2rad(np.asarray(tilt_deg, np.float64))
    return np.stack([np.sin(t) * np.cos(r), np.sin(t) * np.sin(r),
                     np.cos(t)], axis=-1).astype(np.float32)


class ProgDeepGlobalAssignment(_DeepBase):
    name = "xmipp_deep_global_assignment"

    def defineParams(self):
        self.addUsageLine("Train a CNN that regresses the projection "
                          "direction of a particle image "
                          "(deep_global_assignment role).")
        self.addParamsLine("   -i <md>         : Training particles with angleRot/angleTilt")
        self.addParamsLine("  [--model <path=model.pkl>] : Output model")
        self.addParamsLine("  [--epochs <e=30>] : Training epochs")
        self.addParamsLine("  [--lr <l=0.001>]  : Learning rate")

    def run(self):
        from xmipp3_tpu_torch.models.deep import ConvNet2D
        rows = list(MetaData(self.getParam("-i")).iterRows())
        X = _norm(load_image_rows(rows))
        y = _dir_to_s2([float(r.get("angleRot", 0)) for r in rows],
                       [float(r.get("angleTilt", 0)) for r in rows])
        args = self._train_args()
        if not self.checkParam("--epochs"):
            args["n_epochs"] = 30
        from xmipp3_tpu_torch.models.deep import save_params, train_model
        with timed_phase("train"):
            model, hist = train_model(ConvNet2D(n_out=3), X, y, "mse",
                                      **args)
        save_params(self._model_path(), "ConvNet2D", model)
        self.loss_history = hist
        if self.verbose:
            print(f"trained: loss {hist[0]:.4f} -> {hist[-1]:.4f}")


class ProgDeepGlobalAssignmentPredict(_DeepBase):
    name = "xmipp_deep_global_assignment_predict"

    def defineParams(self):
        self.addUsageLine("Predict projection directions with a trained "
                          "deep_global_assignment model.")
        self.addParamsLine("   -i <md>          : Particles")
        self.addParamsLine("   -o <md>          : Output with predicted angles")
        self.addParamsLine("  [--model <path=model.pkl>] : Trained model")

    def run(self):
        from xmipp3_tpu_torch.models.deep import ConvNet2D
        rows = list(MetaData(self.getParam("-i")).iterRows())
        v = self._predict(ConvNet2D(n_out=3),
                          _norm(load_image_rows(rows)))
        v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-8)
        tilt = np.rad2deg(np.arccos(np.clip(v[:, 2], -1, 1)))
        rot = np.rad2deg(np.arctan2(v[:, 1], v[:, 0]))
        out = []
        for i, r in enumerate(rows):
            d = dict(r)
            d["angleRot"] = float(rot[i])
            d["angleTilt"] = float(tilt[i])
            out.append(d)
        MetaData.fromRows(out).write(self.getParam("-o"))
        self.directions = v
        if self.verbose:
            print(f"predicted {len(v)} directions")


class ProgDeepMisalignmentDetection(_DeepBase):
    name = "xmipp_deep_misalignment_detection"

    def defineParams(self):
        self.addUsageLine("Classify subtomograms as aligned/misaligned "
                          "(deep_misalignment_detection role).")
        self.addParamsLine("   -i <md>          : Subtomograms to score")
        self.addParamsLine("  [-o <md=scored.xmd>] : Output")
        self.addParamsLine("  [--goodTrain <md=\"\">] : Aligned training subtomos")
        self.addParamsLine("  [--badTrain <md=\"\">]  : Misaligned training subtomos")
        self._common_params()

    def run(self):
        from xmipp3_tpu_torch.models.deep import ConvNet3D
        model = ConvNet3D(n_out=2)

        def load_vols(fn):
            return _norm(np.stack([np.squeeze(Image(r["image"]).data)
                                   for r in MetaData(fn).iterRows()]))

        if self.checkParam("--train"):
            self._train_and_save(
                model, "ConvNet3D",
                *_labelled(load_vols(self.getParam("--goodTrain")),
                           load_vols(self.getParam("--badTrain"))), "xent")
        rows = list(MetaData(self.getParam("-i")).iterRows())
        p = _prob_of_class1(self._predict(model,
                                          load_vols(self.getParam("-i"))))
        out = []
        for i, r in enumerate(rows):
            d = dict(r)
            d["cost"] = float(p[i])
            d["enabled"] = 1 if p[i] > 0.5 else -1
            out.append(d)
        MetaData.fromRows(out).write(self.getParam("-o")
                                     if self.checkParam("-o")
                                     else "scored.xmd")
        self.scores = p
        if self.verbose:
            print(f"{int((p > .5).sum())}/{len(p)} classified as aligned")


class ProgDeepVolumePostprocessing(_DeepBase):
    name = "xmipp_deep_volume_postprocessing"

    def defineParams(self):
        self.addUsageLine("Volume-to-volume postprocessing (denoise/"
                          "sharpen) with a residual U-net "
                          "(deep_volume_postprocessing role).")
        self.addParamsLine("   -i <vol>        : Input volume")
        self.addParamsLine("  [-o <vol=post.mrc>] : Output volume")
        self.addParamsLine("  [--trainPairs <md=\"\">] : Metadata with image (input) + imageRef (target) volume pairs")
        self._common_params()

    def run(self):
        from xmipp3_tpu_torch.models.deep import (UNet3DLite, adam,
                                                  init_params, load_params,
                                                  repeatable, save_params)
        model = UNet3DLite()
        dev = self.device
        if self.checkParam("--train"):
            pairs = [(np.squeeze(Image(r["image"]).data),
                      np.squeeze(Image(r["imageRef"]).data))
                     for r in MetaData(self.getParam("--trainPairs")
                                       ).iterRows()]
            X = torch.from_numpy(_norm(np.stack([p[0] for p in pairs]))
                                 ).to(dev).unsqueeze(1)
            Y = torch.from_numpy(_norm(np.stack([p[1] for p in pairs]))
                                 ).to(dev).unsqueeze(1)
            args = self._train_args()
            init_params(model, 0).to(dev).train()
            opt = adam(model, args["lr"])
            hist = []
            with fp32_products(), repeatable(), timed_phase("train"):
                for _ in range(args["n_epochs"]):    # full-batch steps
                    loss = ((model(X) - Y) ** 2).mean()
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
                    opt.step()
                    hist.append(loss.detach())
            hist = [float(h) for h in hist]
            save_params(self._model_path(), "UNet3DLite", model)
            self.loss_history = hist
            if self.verbose:
                print(f"trained: loss {hist[0]:.4f} -> {hist[-1]:.4f}")
        vol = _norm(np.squeeze(Image(self.getParam("-i")).data)[None])
        load_params(self._model_path(), model)
        model.to(dev).eval()
        with torch.no_grad(), fp32_products(), timed_phase("predict"):
            out = model(torch.from_numpy(vol).to(dev).unsqueeze(1))
            out = out[0, 0].cpu().numpy()
        save_image(self.getParam("-o") if self.checkParam("-o")
                   else "post.mrc", out.astype(np.float32))
        self.output = out
        if self.verbose:
            print("postprocessed volume written")
