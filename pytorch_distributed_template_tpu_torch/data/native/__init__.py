"""ctypes binding of the native batch assembler (``batcher.cpp``): the
port's copy of the JAX package's ``data/native/__init__.py``.

The C++ is built with the system ``g++`` at first use into the port's
ignored ``build/native/`` directory and loaded with ctypes. ``gather`` is
a multithreaded row gather (``src[idx]``) and ``gather_normalize_u8`` the
fused ``(src[idx] / 255 - mean) / std`` of uint8 images;
``ArrayDataLoader`` gathers every batch through them. Each call that runs
the native code adds one to :data:`CALLS` (``CALLS.calls``). Arrays the
native code cannot take (not C-contiguous, object dtypes, empty or
non-integer indices) and a machine where the build fails (logged once) go
through numpy, as in the JAX package.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).parent / "batcher.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
_LIB_PATH = BUILD_DIR / "libbatcher.so"

_lock = threading.Lock()
_lib = None
_tried = False
_threads = min(8, os.cpu_count() or 1)


class _Calls:
    """The native gathers run (``calls``); ``reset`` sets it to 0."""

    def __init__(self):
        self.calls = 0

    def reset(self) -> None:
        self.calls = 0


CALLS = _Calls()


def _load() -> Optional[ctypes.CDLL]:
    """Build (when missing or older than the source) and load the
    library; None when that fails."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if (not _LIB_PATH.exists()
                    or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime):
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                # one temporary per process, then a rename: concurrent
                # builders never interleave writes into one file
                tmp = _LIB_PATH.with_suffix(f".so.tmp{os.getpid()}")
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-pthread",
                     str(_SRC), "-o", str(tmp)],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, _LIB_PATH)
            lib = ctypes.CDLL(str(_LIB_PATH))
            lib.gather_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32]
            lib.gather_rows.restype = None
            lib.gather_rows_norm_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
            lib.gather_rows_norm_u8.restype = None
            _lib = lib
        except Exception as exc:  # noqa: BLE001 — no g++, a sandboxed exec
            logger.warning("native batcher unavailable (%s); gathering "
                           "with numpy", exc)
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def _rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``idx`` as int64 row numbers of ``src`` (numpy's negative-index
    meaning), range-checked."""
    idx64 = np.ascontiguousarray(idx, dtype=np.int64)
    if int(idx64.min()) < 0:
        idx64 = idx64.copy()
        idx64[idx64 < 0] += len(src)
    if int(idx64.min()) < 0 or int(idx64.max()) >= len(src):
        raise IndexError("gather index out of range")
    return idx64


def gather(src: np.ndarray, idx) -> np.ndarray:
    """``src[idx]`` through the native multithreaded gather; numpy for
    what it cannot take (see the module docstring)."""
    lib = _load()
    idx = np.asarray(idx)
    if (lib is None or not src.flags.c_contiguous or src.ndim < 1
            or src.itemsize == 0 or src.dtype.hasobject
            or idx.ndim != 1 or len(idx) == 0
            or idx.dtype.kind not in "iu"):
        # object arrays (a memcpy of PyObject* would corrupt refcounts),
        # boolean masks and float indices (an int64 cast would pick the
        # wrong rows) stay with numpy
        return src[idx]
    row_bytes = int(np.prod(src.shape[1:], dtype=np.int64)) * src.itemsize
    if row_bytes == 0:
        return src[idx]
    idx64 = _rows(src, idx)
    out = np.empty((len(idx64),) + src.shape[1:], dtype=src.dtype)
    lib.gather_rows(src.ctypes.data, idx64.ctypes.data, len(idx64),
                    row_bytes, out.ctypes.data, _threads)
    CALLS.calls += 1
    return out


def gather_normalize_u8(src: np.ndarray, idx, mean, std) -> np.ndarray:
    """Fused ``(src[idx] / 255 - mean) / std`` (float32) for a uint8 array
    with a trailing channel dim, in one pass over the gathered bytes;
    numpy's expression for what the native code cannot take."""
    idx = np.asarray(idx)
    mean = np.ascontiguousarray(mean, dtype=np.float32).ravel()
    std = np.ascontiguousarray(std, dtype=np.float32).ravel()
    n_chan = len(mean)
    lib = _load()

    def fallback():
        x = src[idx].astype(np.float32) / 255.0
        return (x - mean) / std

    if (lib is None or src.dtype != np.uint8 or not src.flags.c_contiguous
            or src.ndim < 2 or src.shape[-1] != n_chan or len(std) != n_chan
            or idx.ndim != 1 or len(idx) == 0 or idx.dtype.kind not in "iu"):
        return fallback()
    row_elems = int(np.prod(src.shape[1:], dtype=np.int64))
    if row_elems == 0 or row_elems % n_chan != 0:
        return fallback()
    idx64 = _rows(src, idx)
    out = np.empty((len(idx64),) + src.shape[1:], dtype=np.float32)
    lib.gather_rows_norm_u8(
        src.ctypes.data, idx64.ctypes.data, len(idx64), row_elems, n_chan,
        mean.ctypes.data, std.ctypes.data, out.ctypes.data, _threads)
    CALLS.calls += 1
    return out
