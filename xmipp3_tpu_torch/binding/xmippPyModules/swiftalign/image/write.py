from __future__ import annotations

import numpy as np


def write(data, path) -> None:
    from xmipp3_tpu_torch.core.image import save_image
    save_image(str(path), np.asarray(data, np.float32))
