"""ctypes bridge to the native JPEG encoder (``native/jpeg_codec.cpp``).

The port's counterpart of ``melogan_tpu/imaging/native.py``. The Python
encoder in ``imaging/jpeg.py`` is the reference implementation; the native
twin runs the DCT and the entropy coder in C++, which is what keeps the MJPEG
stream real-time. Output equality between the two is enforced in tests.

The library is built at first use with ``g++`` into
``build/melogan_torch/libmelojpeg.so`` of the checkout, never into
``native/`` (the JAX package's loader owns ``native/libmelojpeg.so`` and
rebuilds it in place). Each build writes a per-process temporary file and
renames it into place, so processes that build at once never load a
half-written library. When the build or the load fails, or ``MELOGAN_NATIVE_JPEG=0``,
``encode_jpeg`` serves the Python encoder, as in the JAX package. This is
host code: the device plays no part in it.
"""
from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from melogan_torch.utils import gxx

ROOT = Path(__file__).resolve().parents[2]
SRC_PATH = ROOT / "native" / "jpeg_codec.cpp"
LIB_PATH = ROOT / "build" / "melogan_torch" / "libmelojpeg.so"

_LOCK = threading.Lock()
_loaded = {"tried": False, "lib": None, "error": None}


def is_stale() -> bool:
    return gxx.is_stale(SRC_PATH, LIB_PATH)


def build() -> Path:
    """Compile ``native/jpeg_codec.cpp`` into ``LIB_PATH`` when it is missing or
    older than its source; returns the path. Raises RuntimeError with the
    compiler's output when ``g++`` is missing or fails."""
    return gxx.build(SRC_PATH, LIB_PATH)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded encoder library, built first if stale; None when
    ``MELOGAN_NATIVE_JPEG=0`` or when the build or load failed (the reason
    is in :func:`load_error`). The first failure is kept: no rebuild is
    tried on every frame."""
    if os.environ.get("MELOGAN_NATIVE_JPEG", "1") == "0":
        return None
    with _LOCK:
        if not _loaded["tried"]:
            _loaded["tried"] = True
            try:
                lib = ctypes.CDLL(str(build()))
                lib.melo_jpeg_encode.restype = ctypes.c_long
                lib.melo_jpeg_encode.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
                ]
                _loaded["lib"] = lib
            except (RuntimeError, OSError, AttributeError) as e:
                _loaded["error"] = f"{type(e).__name__}: {e}"
        return _loaded["lib"]


def load_error() -> Optional[str]:
    """Why :func:`get_lib` returned None after a build or load, if it did."""
    return _loaded["error"]


def encode_jpeg_native(img: np.ndarray, quality: int = 80) -> Optional[bytes]:
    """(H, W, 3) uint8 RGB → JFIF bytes via the C++ encoder, or None when the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg_native wants (H, W, 3) uint8, got {img.shape}")
    h, w = img.shape[:2]
    cap = h * w * 3 + 65536
    out = (ctypes.c_uint8 * cap)()
    n = lib.melo_jpeg_encode(img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                             h, w, int(quality), out, cap)
    if n <= 0:
        return None
    return bytes(bytearray(out[:n]))
