"""PCA + 2-means classification of ALIGNED particles (reference
swiftalign/classification/aligned_2d_classficiation.py: eigendecomposition
of the aligned stack, then split on the principal component). The PCA
runs on the card unless `device="cpu"` is given; the k-means on its few
coordinates stays on the host."""
from __future__ import annotations

import numpy as np


def aligned_2d_classification(images, mask=None, n_classes: int = 2,
                              n_pca: int = 4, seed: int = 0, device=None):
    """Returns (labels (B,), averages (n_classes, H, W), projections)."""
    from xmipp3_tpu_torch.models.dimred import empca
    images = np.asarray(images, np.float32)
    B = len(images)
    X = images[..., np.asarray(mask) > 0] if mask is not None \
        else images.reshape(B, -1)
    Y = empca(X.astype(np.float64), d=min(n_pca, B - 1), n_iters=8,
              seed=seed, device=device)
    # k-means in the PCA space
    rng = np.random.default_rng(seed)
    centers = Y[rng.choice(B, n_classes, replace=False)]
    labels = np.zeros(B, int)
    for _ in range(25):
        d = ((Y[:, None, :] - centers[None]) ** 2).sum(-1)
        new = d.argmin(1)
        if (new == labels).all() and _ > 0:
            break
        labels = new
        for k in range(n_classes):
            if (labels == k).any():
                centers[k] = Y[labels == k].mean(0)
    avgs = np.stack([images[labels == k].mean(0) if (labels == k).any()
                     else np.zeros_like(images[0])
                     for k in range(n_classes)])
    return labels, avgs, Y
