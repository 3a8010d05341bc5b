"""Build and bind the port's CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc for sm_90a into its own shared library
with a plain C interface, under `xmipp3_tpu_torch/_build/` (git-ignored),
and loaded with ctypes. A library's file name carries a hash of its source,
of every header in csrc/ (*.cuh, found by `-I csrc`) and of the compiler
flags, so an edited source or header is rebuilt and a fresh checkout builds
everything at first use. `build()` starts one nvcc per missing
source, all together, and waits for them; a failed build raises with the
compiler's output. Nothing here runs at import time: the CPU tests import
every module on machines without nvcc or a card.

The helpers at the end are shared by the kernel wrappers: operand checks
and the current stream as a ctypes pointer.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from functools import lru_cache
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME"
                       " or /usr/local/cuda): the port's CUDA kernels are "
                       "built from csrc/ with the CUDA toolkit")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.name.encode() + header.read_bytes())
    return src, BUILD_DIR / f"lib{name}_{key.hexdigest()[:16]}.so"


def nvcc_command(src: Path, out: Path) -> list[str]:
    """The nvcc call that compiles `src` into the shared library `out`,
    with csrc/ on the include path and ptxas's report switched on."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-Xptxas=-v", "-o",
            str(out), str(src)]


def build() -> dict[str, str]:
    """Compile every source in csrc/ whose library is missing, one nvcc
    process per source, started together. Returns each compiled source's
    ptxas report (registers, spills); raises if any build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = {}
    for name in sorted(p.stem for p in CSRC.glob("*.cu")):
        src, lib = _target(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        jobs[name] = (subprocess.Popen(nvcc_command(src, tmp),
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib)
    reports, errors = {}, []
    for name, (proc, tmp, lib) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"nvcc failed on csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
            reports[name] = out
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if missing."""
    with _LOCK:
        if name not in _LIBS:
            _, lib = _target(name)
            if not lib.exists():
                build()
            _LIBS[name] = ctypes.CDLL(str(lib))
        return _LIBS[name]


@lru_cache(maxsize=None)
def bind(name: str, symbol: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """A C function of csrc/<name>.cu with its argument types set (every
    pointer and the stream as c_void_p, so none is cut to 32 bits), set up
    once and cached."""
    fn = getattr(library(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{rc}")


def check_operands(what: str, dtype: torch.dtype, numel: int,
                   **tensors: torch.Tensor) -> torch.device:
    """All tensors on one device, of `dtype`, contiguous and of `numel`
    elements; returns their device. Raises on anything else."""
    device = None
    for key, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: {key} must be a torch.Tensor")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {key} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {key} must be contiguous")
        if t.numel() != numel:
            raise ValueError(f"{what}: {key} has {t.numel()} elements, "
                             f"expected {numel}")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{what}: {key} is on {t.device}, the other "
                             f"operands on {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {device}")
    return device
