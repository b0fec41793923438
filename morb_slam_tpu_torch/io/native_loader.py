"""ctypes bridge to the port's prefetching image loader
(`morb_slam_tpu_torch/native/loader.cc`; counterpart of
`morb_slam_tpu/io/native_loader.py`).

A worker pool in a small C++ library decodes PNG / PGM frames ahead of the
consumer, so the feed loop overlaps disk and decoding with the card's work.
On a machine without OpenCV it is the only image reader.

The library is built with `g++` (zlib for PNG) at first use into
`morb_slam_tpu_torch/_build/` (listed in `.gitignore`), keyed by a hash of the
source and the flags. A failed build keeps the compiler's messages
(`build_error()`); callers with no other decoder raise them.
MORB_NATIVE_LOADER=0 switches the library off.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "native", "loader.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None
_error: Optional[str] = None


def _build() -> str:
    """Compile the library if no up-to-date build exists; returns its
    path. Raises RuntimeError with the compiler's messages on failure."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    out = os.path.join(BUILD_DIR, f"libmorbloader-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *FLAGS, SRC, "-o", tmp, "-lz", "-lpthread"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native image loader build failed: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(f"native image loader build failed:\n"
                           f"{' '.join(cmd)}\n{r.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on demand; None when it is switched off or
    could not be built (then `build_error()` says why)."""
    global _lib, _error
    if os.environ.get("MORB_NATIVE_LOADER", "1") in ("0", "off"):
        _error = "switched off by MORB_NATIVE_LOADER"
        return None
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(_build())
        except (RuntimeError, OSError) as e:
            _error = str(e)
            return None
        P, I = ctypes.c_void_p, ctypes.c_int
        IP = ctypes.POINTER(I)
        FP = ctypes.POINTER(ctypes.c_float)
        lib.loader_create.restype = P
        lib.loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), I, I,
                                      I, IP, IP]
        lib.loader_next.restype = I
        lib.loader_next.argtypes = [P, FP, I]
        lib.loader_destroy.argtypes = [P]
        lib.decode_image.restype = I
        lib.decode_image.argtypes = [ctypes.c_char_p, FP, I, IP, IP]
        _lib = lib
        return _lib


def build_error() -> Optional[str]:
    """Why the library is unavailable (None while it loads)."""
    return _error


def decode_gray(path: str) -> Optional[np.ndarray]:
    """float32 (H, W) grey image of a PNG / PGM / PPM file; None if the
    library is unavailable or cannot decode the file."""
    lib = get_lib()
    if lib is None:
        return None
    cap = 16 * 1024 * 1024
    buf = np.empty(cap, np.float32)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.decode_image(path.encode(),
                          buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          cap, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return buf[:w.value * h.value].reshape(h.value, w.value).copy()


class PrefetchLoader:
    """In-order prefetching frame stream over image paths: iterating yields
    (index, float32 (H, W) image), decoded by `n_workers` C++ threads up to
    `prefetch` frames ahead."""

    def __init__(self, paths: List[str], n_workers: int = 2,
                 prefetch: int = 8):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_error}")
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        w, h = ctypes.c_int(), ctypes.c_int()
        self._h = lib.loader_create(arr, len(self._paths), n_workers,
                                    prefetch, ctypes.byref(w),
                                    ctypes.byref(h))
        self.width, self.height = w.value, h.value
        self._n = len(paths)
        self._buf = np.empty(max(self.width * self.height, 1), np.float32)

    def __iter__(self):
        for _ in range(self._n):
            rc = self._lib.loader_next(
                self._h,
                self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self._buf.size)
            if rc == -1:
                return
            if rc < 0:
                raise IOError(f"native decode failed (rc={rc})")
            yield rc, self._buf.reshape(self.height, self.width).copy()

    def close(self):
        if self._h is not None:
            self._lib.loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
