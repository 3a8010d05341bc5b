"""Support-vector classifiers of the picker: a linear SVM (hinge loss and
L2, minimised by Adam on the card), a kernel SVM through random Fourier
features, and Gaussian naive Bayes.

Counterpart of the reference package's models/svm.py (the reference's
automatic picker trains a C-SVM over rotation-invariant particle features
as its second stage, micrograph_automatic_picking2, and a naive Bayes as
its fast-rejection stage). The training loss runs on the card; the
standardisation, the random-Fourier features (float64) and the decisions
stay in host numpy, as in the reference. `save`/`load` write and read the
reference's .npz keys, so a model trained by either package loads in the
other and gives the same decisions.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor


class LinearSVM:
    def __init__(self, C: float = 1.0, n_steps: int = 300, lr: float = 0.05,
                 device=None):
        self.C = C
        self.n_steps = n_steps
        self.lr = lr
        self.device = device
        self.w = None
        self.b = 0.0
        self._mu = None
        self._sd = None

    def fit(self, X, y):
        """X (N, D); y in {0, 1} (mapped to +-1). The hinge is written
        with torch.maximum, which, like the reference's jnp.maximum, splits
        the gradient evenly at a tie (clamp and relu give it to one
        side)."""
        from xmipp3_tpu_torch.ops.optim import adam_scan
        X = np.asarray(X, np.float32)
        self._mu = X.mean(axis=0)
        self._sd = np.maximum(X.std(axis=0), 1e-8)
        Xn = as_tensor((X - self._mu) / self._sd, self.device)
        yy = as_tensor(np.where(np.asarray(y) > 0, 1.0, -1.0), Xn.device)
        zero = torch.zeros((), device=Xn.device)
        n = len(yy)

        def loss(p):
            w, b = p[:-1], p[-1]
            margins = yy * (Xn @ w + b)
            hinge = torch.maximum(zero, 1.0 - margins).mean()
            return 0.5 * (w @ w) / self.C / n + hinge

        p, _ = adam_scan(loss, torch.zeros(X.shape[1] + 1,
                                           device=Xn.device),
                         self.n_steps, self.lr)
        p = p.cpu().numpy()
        self.w = p[:-1]
        self.b = float(p[-1])
        return self

    def decision(self, X):
        Xn = (np.asarray(X, np.float32) - self._mu) / self._sd
        return Xn @ self.w + self.b

    def predict(self, X):
        return (self.decision(X) > 0).astype(int)

    def save(self, path):
        np.savez(path, w=self.w, b=self.b, mu=self._mu, sd=self._sd,
                 C=self.C)

    @classmethod
    def load(cls, path, device=None):
        d = np.load(path if str(path).endswith(".npz") else path + ".npz")
        svm = cls(C=float(d["C"]), device=device)
        svm.w = d["w"]
        svm.b = float(d["b"])
        svm._mu = d["mu"]
        svm._sd = d["sd"]
        return svm


def particle_features(boxes, radius_min: int = 2, device=None):
    """Rotation-invariant features of particle boxes: the ring FFT's
    magnitude spectrum and the intensity moments (the picker's feature
    vector). The polar resampling runs on `device` (the card by
    default), the spectra on the host, as in the reference."""
    from xmipp3_tpu_torch.ops.polar import cartesian_to_polar
    boxes = np.asarray(boxes, np.float32)
    B = len(boxes)
    mu = boxes.mean(axis=(1, 2), keepdims=True)
    sd = np.maximum(boxes.std(axis=(1, 2), keepdims=True), 1e-8)
    norm = (boxes - mu) / sd
    pol = cartesian_to_polar(norm, radius_min, device=device).cpu().numpy()
    spec = np.abs(np.fft.rfft(pol, axis=-1))[..., :8]
    feats = [spec.reshape(B, -1),
             pol.mean(axis=-1),                     # radial profile
             boxes.mean(axis=(1, 2))[:, None],
             boxes.std(axis=(1, 2))[:, None]]
    return np.concatenate(feats, axis=1)


def median_sq_distance(X, rows: int = 512) -> float:
    """The median of the positive float64 pairwise squared distances of
    X's rows (1.0 when there is none), computed in chunks of `rows` rows:
    each entry is the reference's ((x_i - x_j) ** 2).sum(), without its
    (N, N, D) array."""
    X = np.asarray(X, np.float64)
    pos = []
    for s in range(0, len(X), rows):
        d2 = ((X[s:s + rows, None, :] - X[None, :, :]) ** 2).sum(-1)
        pos.append(d2[d2 > 0])
    pos = np.concatenate(pos) if pos else np.zeros(0)
    return float(np.median(pos)) if len(pos) else 1.0


class RBFSVM:
    """Kernel SVM via random Fourier features and the linear hinge solver
    (the stand-in for libsvm's RBF C-SVC of the reference picker,
    classification/svm_classifier.h): the features make the kernel map an
    explicit product, so training runs as the linear SVM's loss on the
    card."""

    def __init__(self, C: float = 1.0, gamma: float | None = None,
                 n_features: int = 256, n_steps: int = 400,
                 lr: float = 0.05, seed: int = 0, device=None):
        self.C = C
        self.gamma = gamma
        self.n_features = n_features
        self.n_steps = n_steps
        self.lr = lr
        self.seed = seed
        self.device = device
        self.W = None
        self.b = None
        self.inner = None

    def _features(self, X):
        Z = np.asarray(X, np.float64) @ self.W.T + self.b
        return np.sqrt(2.0 / self.n_features) * np.cos(Z)

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        if self.gamma is None:
            self.gamma = 1.0 / max(median_sq_distance(X), 1e-12)
        rng = np.random.default_rng(self.seed)
        D = X.shape[1]
        self.W = rng.normal(0.0, np.sqrt(2 * self.gamma),
                            (self.n_features, D))
        self.b = rng.uniform(0, 2 * np.pi, self.n_features)
        self.inner = LinearSVM(self.C, self.n_steps, self.lr, self.device)
        self.inner.fit(self._features(X), y)
        return self

    def decision(self, X):
        return self.inner.decision(self._features(X))

    def predict(self, X):
        return np.sign(self.decision(X))

    def save(self, path):
        np.savez(path, kind="rbf", W=self.W, b=self.b,
                 gamma=self.gamma, w=self.inner.w, bias=self.inner.b,
                 mu=self.inner._mu, sd=self.inner._sd)

    @classmethod
    def load(cls, path, device=None):
        z = np.load(path if str(path).endswith(".npz") else str(path)
                    + ".npz", allow_pickle=True)
        m = cls(gamma=float(z["gamma"]), n_features=z["W"].shape[0],
                device=device)
        m.W = z["W"]
        m.b = z["b"]
        m.inner = LinearSVM(device=device)
        m.inner.w = z["w"]
        m.inner.b = float(z["bias"])
        m.inner._mu = z["mu"]
        m.inner._sd = z["sd"]
        return m


class GaussianNB:
    """Gaussian naive Bayes (reference classification/naive_bayes.{h,cpp},
    the picker's fast-rejection stage), in host numpy."""

    def __init__(self, var_floor: float = 1e-6):
        self.var_floor = var_floor
        self.means = None
        self.vars = None
        self.log_priors = None
        self.classes = None

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y)
        self.classes = np.unique(y)
        self.means = np.stack([X[y == c].mean(axis=0)
                               for c in self.classes])
        self.vars = np.stack([X[y == c].var(axis=0) + self.var_floor
                              for c in self.classes])
        self.log_priors = np.log(np.array(
            [(y == c).mean() for c in self.classes]))
        return self

    def log_proba(self, X):
        X = np.asarray(X, np.float64)
        ll = -0.5 * (((X[:, None, :] - self.means[None]) ** 2
                      / self.vars[None])
                     + np.log(2 * np.pi * self.vars[None])).sum(-1)
        return ll + self.log_priors[None]

    def predict(self, X):
        return self.classes[np.argmax(self.log_proba(X), axis=1)]

    def save(self, path):
        np.savez(path, kind="nb", means=self.means, vars=self.vars,
                 log_priors=self.log_priors, classes=self.classes)

    @classmethod
    def load(cls, path):
        z = np.load(path, allow_pickle=True)
        m = cls()
        m.means = z["means"]
        m.vars = z["vars"]
        m.log_priors = z["log_priors"]
        m.classes = z["classes"]
        return m
