"""xmipp3_tpu_torch — the PyTorch/CUDA port of xmipp3_tpu for NVIDIA Hopper.

A second package beside `xmipp3_tpu` (the JAX reference, which it never
imports). Modules keep the reference's paths and names
(`xmipp3_tpu_torch/ops/reconstruct.py` <-> `xmipp3_tpu/ops/reconstruct.py`);
the reference's Pallas kernels become CUDA C++ kernels in `csrc/`, built
with nvcc at first use and bound with ctypes (`ops/_cuda_build.py`).

Every entry point runs on the card unless the caller passes
`device="cpu"` (or `--device cpu` on the command line); see `device.py`.

Layer map:
  core/      — metadata (STAR), image I/O, filenames, program framework,
               geometry, symmetry (host numpy)
  ops/       — torch tensor ops and the kernel wrappers
  csrc/      — CUDA C++ sources of the hand-written kernels
  programs/  — CLI endpoints: python -m xmipp3_tpu_torch.programs <name>
"""

__version__ = "0.1.0"

from xmipp3_tpu_torch.core.metadata import MetaData, Row
from xmipp3_tpu_torch.core.image import Image
from xmipp3_tpu_torch.core.filename import FileName

__all__ = ["MetaData", "Row", "Image", "FileName", "__version__"]
