"""Apply stored in-plane alignment (psi/shift/flip) to particles
(reference swiftalign/alignment/InPlaneTransformCorrector.py: iterates
(image, transform) pairs and warps them to the registered frame), on the
card unless `device="cpu"` is given."""
from __future__ import annotations

import numpy as np


class InPlaneTransformCorrector:
    def __init__(self, interpolation: str = "bilinear", device=None):
        self.order = 1 if interpolation == "bilinear" else 3
        self.device = device

    def __call__(self, images, psi, shift_x, shift_y, flip=None):
        from xmipp3_tpu_torch.ops.geo import apply_md_geometry
        images = np.asarray(images, np.float32)
        return apply_md_geometry(
            images, np.asarray(psi, np.float32),
            np.asarray(shift_x, np.float32),
            np.asarray(shift_y, np.float32),
            None if flip is None else np.asarray(flip),
            order=self.order, device=self.device).cpu().numpy()
