"""ctypes bindings for the native C++ image loader (``native/image_loader.cc``);
the port's own copy of ``seed_story_tpu/data/native_loader.py``, loading the
same source into the same library.

This is a host JPEG decoder, not a device kernel. It compiles on first use
(``g++ -O3 -shared``, cached next to the source) and falls back to the
pure-Python transforms when the toolchain or libjpeg is unavailable. Only
JPEG goes through the native path; other formats take PIL per image.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_MODES = {"clip": 0, "clipa": 1, "sd": 2}
_LOCK = threading.Lock()
_LIB = None
_LIB_FAILED = False


def _native_dir() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
    )


def _build_library() -> Optional[str]:
    src = os.path.join(_native_dir(), "image_loader.cc")
    out = os.path.join(_native_dir(), "libss_image_loader.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           src, "-ljpeg", "-lpthread", "-o", out]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        return out
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        msg = getattr(e, "stderr", b"")
        print(f"native image loader build failed ({e}); {msg[:500]}")
        return None


def get_library():
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        path = _build_library()
        if path is None:
            _LIB_FAILED = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:  # a library built where libjpeg was, loaded where it is not
            print(f"native image loader unavailable ({e})")
            _LIB_FAILED = True
            return None
        lib.ss_load_image.restype = ctypes.c_int
        lib.ss_load_image.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.ss_load_batch.restype = None
        lib.ss_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return get_library() is not None


def load_image(path: str, image_size: int, type: str = "clip",
               keep_ratio: bool = True) -> Optional[np.ndarray]:
    """Single image -> CHW float32, or None on failure."""
    lib = get_library()
    if lib is None:
        return None
    out = np.empty((3, image_size, image_size), np.float32)
    ok = lib.ss_load_image(
        path.encode(), image_size, _MODES[type], int(keep_ratio),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), None, None,
    )
    return out if ok == 0 else None


def load_batch(paths: List[str], image_size: int, type: str = "clip",
               keep_ratio: bool = True, nthreads: int = 0
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parallel batch load. Returns (images (N,3,S,S), ok mask (N,),
    orig sizes (N,2) as (w,h))."""
    lib = get_library()
    assert lib is not None, "native loader unavailable"
    n = len(paths)
    out = np.empty((n, 3, image_size, image_size), np.float32)
    status = np.empty((n,), np.int32)
    ow = np.empty((n,), np.int32)
    oh = np.empty((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.ss_load_batch(
        arr, n, image_size, _MODES[type], int(keep_ratio),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        ow.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        oh.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        nthreads,
    )
    return out, status == 0, np.stack([ow, oh], axis=1)


class NativeImageTransform:
    """Drop-in for data.transforms.ImageTransform that short-circuits to
    the C++ path for JPEG files (uses PIL's lazy ``filename``); any other
    input falls back to the Python transform."""

    def __init__(self, type: str = "clip", keep_ratio: bool = True,
                 image_size: int = 224):
        from .transforms import ImageTransform

        self.type = type
        self.keep_ratio = keep_ratio
        self.image_size = image_size
        self._fallback = ImageTransform(type=type, keep_ratio=keep_ratio,
                                        image_size=image_size)

    def __call__(self, img) -> np.ndarray:
        path = img if isinstance(img, str) else getattr(img, "filename", None)
        if path and path.lower().endswith((".jpg", ".jpeg")) and native_available():
            out = load_image(path, self.image_size, self.type, self.keep_ratio)
            if out is not None:
                return out
        if isinstance(img, str):
            from PIL import Image

            img = Image.open(img)
        return self._fallback(img)


def get_native_transform(type: str = "clip", keep_ratio: bool = True,
                         image_size: int = 224) -> NativeImageTransform:
    """Config-surface factory (native sibling of transforms.get_transform)."""
    return NativeImageTransform(type=type, keep_ratio=keep_ratio,
                                image_size=image_size)
