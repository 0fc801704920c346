"""ctypes binding of the port's native host pipeline (``csrc/host_pipeline.cpp``).

The counterpart of the JAX package's ``data/native.py``, with its signatures:
``available()``, ``decode_png_gray8`` and ``augment_pair``. The library is
built on first use by ``ops/build.py:build_host`` (g++ and zlib) into
``build/torch_host/``. ``MISST_DISABLE_NATIVE`` (any non-empty value) turns
the native path off, as in the JAX package; then every caller uses numpy and
PIL.

Deviation: where the build or the load fails, the JAX package falls back to
numpy silently; here one ``[data] WARNING`` names the compiler's error first.

``CALLS`` counts the native calls of each entry point (``reset_call_counts``
sets them to 0), as ``ops/mi_joint.py:LAUNCHES`` counts kernel launches: a
run can show that the native path served its samples.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
CALLS: Dict[str, int] = {"decode_png_gray8": 0, "augment_pair": 0}


def reset_call_counts() -> None:
    with _lock:
        for name in CALLS:
            CALLS[name] = 0


def add_calls(counts: Dict[str, int]) -> None:
    """Add native calls made in another process (a loader's own)."""
    with _lock:
        for name, n in counts.items():
            CALLS[name] += n


def _count(name: str) -> None:
    with _lock:  # loader threads call at once
        CALLS[name] += 1


def reset() -> None:
    """Forget the loaded library, so the next call loads (or builds) it again
    under the environment of that moment (``MISST_DISABLE_NATIVE``, ``CXX``)."""
    global _lib, _tried
    with _lock:
        _lib, _tried = None, False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("MISST_DISABLE_NATIVE"):
            return None
        from ..ops import build

        try:
            _lib = _bind(ctypes.CDLL(str(build.build_host("host_pipeline"))))
        except (RuntimeError, OSError) as error:
            print(f"[data] WARNING: the native host library is unavailable, decoding and "
                  f"augmenting in numpy: {error}", flush=True)
        return _lib


def library_path() -> Optional[str]:
    """The loaded library's file (loaded, or built, first), None where the
    native path is off or unavailable."""
    lib = _load()
    return None if lib is None else lib._name


def use_library(path: Optional[str]) -> None:
    """Take the library at ``path`` (another process's ``library_path()``),
    or none, without building: a loader's own process uses its caller's."""
    global _lib, _tried
    with _lock:
        _lib, _tried = None if path is None else _bind(ctypes.CDLL(path)), True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The library with its entry points' signatures."""
    lib.misst_decode_png_gray8.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]
    lib.misst_decode_png_gray8.restype = ctypes.c_int
    lib.misst_augment_pair.argtypes = [
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_void_p,  # gt or NULL
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_float, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_float, ctypes.c_float,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_void_p,  # out_gt or NULL
    ]
    lib.misst_augment_pair.restype = ctypes.c_int
    return lib


def available() -> bool:
    return _load() is not None


MAX_SIDE = 2048


def decode_png_gray8(data: bytes) -> Optional[np.ndarray]:
    """Decode an 8-bit grayscale PNG; None if unsupported/unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(MAX_SIDE * MAX_SIDE, np.uint8)
    h = ctypes.c_int32()
    w = ctypes.c_int32()
    _count("decode_png_gray8")
    rc = lib.misst_decode_png_gray8(data, len(data), out, ctypes.byref(h),
                                    ctypes.byref(w), out.size)
    if rc != 0:
        return None
    return out[: h.value * w.value].reshape(h.value, w.value).copy()


def augment_pair(
    img: np.ndarray,
    gt: Optional[np.ndarray],
    angle: float,
    vflip: bool,
    hflip: bool,
    crop_y: int,
    crop_x: int,
    crop: int,
    brightness: float = -1.0,
    contrast: float = 1.0,
) -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Fused rotate+flip+crop+jitter; brightness < 0 disables jitter.
    Returns None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.float32)
    h, w = img.shape
    out_img = np.empty((crop, crop), np.float32)
    out_gt = None
    gt_ptr = None
    out_gt_ptr = None
    if gt is not None:
        gt = np.ascontiguousarray(gt, np.int32)
        if gt.shape != img.shape:
            raise ValueError(f"augment_pair: label shape {gt.shape} != image shape {img.shape}")
        out_gt = np.empty((crop, crop), np.int32)
        gt_ptr = gt.ctypes.data_as(ctypes.c_void_p)
        out_gt_ptr = out_gt.ctypes.data_as(ctypes.c_void_p)
    _count("augment_pair")
    rc = lib.misst_augment_pair(
        img, gt_ptr, h, w, float(angle), int(vflip), int(hflip),
        int(crop_y), int(crop_x), int(crop), float(brightness), float(contrast),
        out_img, out_gt_ptr,
    )
    if rc != 0:
        return None
    return out_img, out_gt
