"""Classification quality assessment (reference
py_xmipp/classifyPcaFuntion/assessment.py role)."""
from __future__ import annotations

import numpy as np


def class_populations(labels, n_classes=None):
    labels = np.asarray(labels, int)
    n = int(labels.max()) + 1 if n_classes is None else int(n_classes)
    return np.bincount(labels, minlength=n)


def intra_class_correlation(images, labels):
    """Mean correlation of each image with its class average."""
    images = np.asarray(images, np.float32)
    labels = np.asarray(labels, int)
    out = np.zeros(len(images))
    for k in np.unique(labels):
        sel = labels == k
        avg = images[sel].mean(axis=0).ravel()
        avg = (avg - avg.mean()) / max(avg.std(), 1e-12)
        for i in np.where(sel)[0]:
            x = images[i].ravel()
            x = (x - x.mean()) / max(x.std(), 1e-12)
            out[i] = float((x * avg).mean())
    return out
