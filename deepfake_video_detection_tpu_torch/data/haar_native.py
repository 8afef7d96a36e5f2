"""ctypes bindings for the C++ Haar pyramid scan (``native/haar.cc``).

Counterpart of ``deepfake_video_detection_tpu/data/haar_native.py``. The
library is ``native/build/libhaar.so``, loaded read-only, or where that is
missing ``build/native/libhaar.so``, built once from ``native/haar.cc``
(``data/_native.py``). It needs only the C++ runtime. The scan releases
the GIL for its whole duration, so per-frame detection in request threads
overlaps the device's forward.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from deepfake_video_detection_tpu_torch.data import _native

_LIB = "libhaar.so"


def _bind(lib: ctypes.CDLL) -> None:
    i32p, f64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double)
    f32p, c_int = ctypes.POINTER(ctypes.c_float), ctypes.c_int
    lib.haar_scan.argtypes = [
        f32p, c_int, c_int, i32p, f64p, i32p, f64p, f64p, i32p, f64p,
        c_int, c_int, c_int, ctypes.c_double, c_int, c_int, f32p, c_int]
    lib.haar_scan.restype = c_int
    lib.haar_prepare.argtypes = [ctypes.POINTER(ctypes.c_uint8), c_int, c_int, f32p,
                                 c_int, c_int]
    lib.haar_prepare.restype = None


def _get_lib() -> ctypes.CDLL:
    return _native.load(_LIB, ("haar.cc",), (), _bind)


def engine() -> str:
    """``"native"`` when the C++ scan loads, else ``"numpy"`` (the engine
    ``data/haar.py`` then falls back to)."""
    try:
        _get_lib()
        return "native"
    except OSError:
        return "numpy"


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def prepare_gray(rgb: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Fused BT.601 gray and bilinear downscale in C (GIL-free)."""
    lib = _get_lib()
    rgb = np.ascontiguousarray(rgb, np.uint8)
    out = np.empty((out_h, out_w), np.float32)
    lib.haar_prepare(_ptr(rgb, ctypes.c_uint8), rgb.shape[0], rgb.shape[1],
                     _ptr(out, ctypes.c_float), out_h, out_w)
    return out


def detect_raw(cascade, gray: np.ndarray, scale_factor: float,
               min_size: int, max_size: Optional[int],
               max_out: int = 4096) -> np.ndarray:
    """Run the C++ pyramid scan; returns the raw (n, 4) xywh float64
    windows before grouping, as ``HaarCascade._detect_raw_numpy`` does."""
    if cascade.win_w != cascade.win_h:
        raise RuntimeError("native haar scan assumes a square window")
    lib = _get_lib()
    gray = np.ascontiguousarray(gray, np.float32)
    H, W = gray.shape
    rects = np.ascontiguousarray(cascade.rects, np.int32)
    weights = np.ascontiguousarray(cascade.weights, np.float64)
    feat_idx = np.ascontiguousarray(cascade.feat_idx, np.int32)
    node_thr = np.ascontiguousarray(cascade.node_thr, np.float64)
    leaves = np.ascontiguousarray(cascade.leaves, np.float64)
    stage_ends = np.ascontiguousarray(cascade.stage_ends, np.int32)
    stage_thr = np.ascontiguousarray(cascade.stage_thr, np.float64)
    while True:
        out = np.empty((max_out, 3), np.float32)
        n = lib.haar_scan(
            _ptr(gray, ctypes.c_float), H, W,
            _ptr(rects, ctypes.c_int32), _ptr(weights, ctypes.c_double),
            _ptr(feat_idx, ctypes.c_int32), _ptr(node_thr, ctypes.c_double),
            _ptr(leaves, ctypes.c_double), _ptr(stage_ends, ctypes.c_int32),
            _ptr(stage_thr, ctypes.c_double), cascade.n_stages,
            cascade.win_w, cascade.win_h, float(scale_factor), int(min_size),
            int(max_size or 0), _ptr(out, ctypes.c_float), max_out)
        if n < 0:
            raise RuntimeError("haar_scan failed")
        if n <= max_out:
            break
        # the scan returns the true count when the buffer is too small:
        # retry with room for every window, so none is dropped
        max_out = n
    xys = out[:n].astype(np.float64)
    return np.stack([xys[:, 0], xys[:, 1], xys[:, 2], xys[:, 2]],
                    1) if n else np.zeros((0, 4))
