from __future__ import annotations

import numpy as np


def read(path) -> np.ndarray:
    """Read an image/stack slice referenced by 'NNNNNN@file' or a plain
    filename, as a numpy array."""
    from xmipp3_tpu_torch.core.image import Image
    return np.asarray(Image(str(path)).data)


def read_data(paths) -> np.ndarray:
    """Read a sequence of image references into one (B, H, W) array."""
    return np.stack([np.squeeze(read(p)) for p in paths])
