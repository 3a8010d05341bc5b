"""Device selection for the port.

The port is written for the card: every entry point takes `device=` and
defaults to CUDA. Without a card it raises rather than falling back to
the CPU, so a run that was meant for the card can never pass on the host
unnoticed. The CPU is used only when the caller asks for it, as the tests
do with `device="cpu"` (or `--device cpu` on the command line).
"""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """None / "default" -> cuda; anything else -> torch.device(device).

    Raises RuntimeError for a CUDA device when no card is visible."""
    if device is None or device == "default":
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "xmipp3_tpu_torch runs on a CUDA card by default, and "
            "torch.cuda.is_available() is False here; pass device=\"cpu\" "
            "(or --device cpu) to run on the CPU")
    return device


def as_tensor(x, device=None, dtype=torch.float32) -> torch.Tensor:
    """x as a tensor of `dtype` (None keeps its type). A tensor stays on its
    own device unless `device` is given; anything else (numpy, lists,
    scalars) goes to resolve_device(device): the card by default."""
    if isinstance(x, torch.Tensor):
        if device is not None:
            x = x.to(resolve_device(device))
        return x if dtype is None else x.to(dtype)
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()          # torch shares memory only with writable arrays
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))


@contextmanager
def fp32_products():
    """Library matrix products and cuDNN convolutions inside the block run
    in full float32 (no TF32): lower precision in the correlations and
    distances flips argmax winners, and moves the deep programs' scores
    off the CPU's. The previous settings come back on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
