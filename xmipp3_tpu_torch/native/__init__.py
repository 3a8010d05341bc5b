"""ctypes bindings for the port's native IO runtime (libxmipp3_native.so).

Built on first use if the toolchain is present (`make -C` this directory,
into its git-ignored build/); every entry point returns None when the
library is missing, so callers fall back to Python. `xmipp_compile` links
user C++ programs against this library (LIB_DIR, INCLUDE_DIR).
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
INCLUDE_DIR = _DIR
LIB_DIR = os.path.join(_DIR, "build")
_LIB_PATH = os.path.join(LIB_DIR, "libxmipp3_native.so")
_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _DIR, "-s"], check=True,
                       capture_output=True, timeout=120)
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def build() -> bool:
    """Build the library if it is missing; True when it exists."""
    return os.path.exists(_LIB_PATH) or _build()


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.mrc_read_slices.restype = ctypes.c_int
    lib.mrc_read_slices.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.spider_read_slices.restype = ctypes.c_int
    lib.spider_read_slices.argtypes = lib.mrc_read_slices.argtypes
    lib.star_parse_numeric.restype = ctypes.c_int
    lib.star_parse_numeric.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64)]
    _lib = lib
    return _lib


def read_stack_slices(path: str, indices, shape_yx, fmt: str,
                      n_threads: int = 4) -> np.ndarray | None:
    """Threaded read of stack slices (0-based). None => caller falls back."""
    lib = get_lib()
    if lib is None:
        return None
    idx = np.ascontiguousarray(np.asarray(indices, np.int64))
    out = np.empty((len(idx),) + tuple(shape_yx), np.float32)
    fn = lib.mrc_read_slices if fmt == "mrc" else lib.spider_read_slices
    rc = fn(path.encode(), idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            int(n_threads))
    if rc != 0:
        return None
    return out


def parse_star_numeric(path: str, block: str | None = None,
                       max_rows: int = 4_000_000, max_cols: int = 64):
    """Fast parse of an all-numeric loop block.

    Returns (labels, values (R,C) float64) or None to fall back."""
    lib = get_lib()
    if lib is None:
        return None
    # probe size cheaply: cap rows by file line count
    try:
        fsize = os.path.getsize(path)
    except OSError:
        return None
    cap_rows = min(max_rows, max(fsize // 8, 16))
    values = np.empty((cap_rows, max_cols), np.float64)
    labels_buf = ctypes.create_string_buffer(8192)
    n_rows = ctypes.c_int64(cap_rows)
    n_cols = ctypes.c_int64(max_cols)
    rc = lib.star_parse_numeric(
        path.encode(), (block or "").encode(), labels_buf, 8192,
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(n_rows), ctypes.byref(n_cols))
    if rc != 0:
        return None
    labels = labels_buf.value.decode().split("\n")
    return labels, values[: n_rows.value, : n_cols.value].copy()
