"""ctypes bindings to the native IO library (native/dataloader.cpp).

The reference's data pump (rosbag decode + cv::imdecode + CLAHE) was native
C++; so is ours — the PNG decode and CLAHE run in C++, with a pure-Python
fallback when the library isn't built (no pybind11 in the image; plain C ABI
via ctypes).

The port's own copy of `plslam/io/native.py`; it loads (or builds) the
same repo-root `native/` library, which is no part of either package."""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = os.path.join(_NATIVE_DIR, "libplslam_io.so")
    if not os.path.exists(so):
        try:
            subprocess.run(["sh", os.path.join(_NATIVE_DIR, "build.sh")],
                           capture_output=True, timeout=120, check=True)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.plslam_load_png_gray.restype = ctypes.c_int
    lib.plslam_load_png_gray.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int,
    ]
    lib.plslam_clahe.restype = None
    lib.plslam_clahe.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def load_png_gray(path: str, max_w=4096, max_h=4096) -> np.ndarray | None:
    """Native PNG → float32 [H,W] in [0,1]; None if the lib is unavailable
    or the file unsupported (caller falls back to the Python decoder)."""
    lib = _load()
    if lib is None:
        return None
    buf = np.empty(max_w * max_h, np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.plslam_load_png_gray(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(w), ctypes.byref(h), max_w, max_h,
    )
    if rc != 0:
        return None
    return buf[: h.value * w.value].reshape(h.value, w.value).copy()


def clahe(img: np.ndarray, clip=3.0, tiles=8) -> np.ndarray | None:
    """Native CLAHE (cv::createCLAHE(3.0, 8x8) equivalent)."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.float32)
    out = np.empty_like(img)
    lib.plslam_clahe(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        img.shape[0], img.shape[1], clip, tiles,
    )
    return out
