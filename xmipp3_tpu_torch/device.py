"""Device selection for the port.

The port is written for the card: every entry point takes `device=` and
defaults to CUDA. Without a card it raises rather than falling back to
the CPU, so a run that was meant for the card can never pass on the host
unnoticed. The CPU is used only when the caller asks for it, as the tests
do with `device="cpu"` (or `--device cpu` on the command line).
"""
from __future__ import annotations

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
