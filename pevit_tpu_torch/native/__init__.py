"""Native (C++) host data plane: the PIL-compatible bicubic resampler.

Counterpart of ``pevit_tpu/native/__init__.py``.  ``image_ops.cpp`` is the
reference's source, byte for byte.  It is compiled with g++ at its first
use, with the reference's flags, into ``build/`` beside it (a directory git
ignores), under a name keyed by a hash of the source and the flags, and
bound with ctypes.

The reference falls back to PIL when the build fails.  The card's host has
no PIL, so here a failed build raises ``NativeBuildError`` with g++'s
stderr; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "image_ops.cpp"
BUILD_DIR = SOURCE.parent / "build"
CXX_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC"]
_LOCK = threading.Lock()
_LIB = None


class NativeBuildError(RuntimeError):
    """g++ failed to build ``image_ops.cpp``."""


def library_path(source: Path = SOURCE) -> Path:
    """Where the build of ``source`` goes: keyed by its bytes and the flags."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"_image_ops_{digest}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` unless its build exists; returns the library's
    path, or raises ``NativeBuildError`` with the compiler's stderr."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name and rename, so a concurrent loader never
    # opens a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise NativeBuildError(f"g++ could not build {source}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise NativeBuildError(f"g++ failed to build {source} (exit {proc.returncode}):\n"
                               f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib():
    """The loaded ctypes library, built at the first call."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i = ctypes.c_int
            lib.resize_center_crop_u8.argtypes = [u8p, i, i, i, u8p, i]
            lib.resize_center_crop_batch_u8.argtypes = [u8p, i, i, i, i, u8p, i]
            lib.resize_bicubic_u8.argtypes = [u8p, i, i, i, u8p, i, i]
            for fn in (lib.resize_center_crop_u8, lib.resize_center_crop_batch_u8,
                       lib.resize_bicubic_u8):
                fn.restype = None
            _LIB = lib
    return _LIB


def native_resize_center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 HWC -> (size, size, C) uint8: torchvision Resize(size) +
    CenterCrop(size) with PIL's bicubic filter."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty((size, size, c), np.uint8)
    get_lib().resize_center_crop_u8(img, h, w, c, out, size)
    return out


def native_resize_center_crop_batch(imgs: np.ndarray, size: int) -> np.ndarray:
    """(N, H, W, C) uint8 of one size -> (N, size, size, C) uint8."""
    imgs = np.ascontiguousarray(imgs, np.uint8)
    n, h, w, c = imgs.shape
    out = np.empty((n, size, size, c), np.uint8)
    get_lib().resize_center_crop_batch_u8(imgs, n, h, w, c, out, size)
    return out
