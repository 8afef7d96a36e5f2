"""Video decode: ctypes bindings for the native C++ decoder.

Counterpart of ``deepfake_video_detection_tpu/data/video.py``, with the
port's own bindings (the same signatures) to the same library,
``native/videodec.cc`` on libavformat/libavcodec/libswscale: decode every
Nth frame up to ``max_frames`` and scale to the target size and RGB24 into
a caller-owned numpy buffer, or crop faces inside the decoder. ctypes calls
release the GIL, so decode threads run in parallel.

The library is ``native/build/libvideodec.so``, loaded read-only; where it
is missing it is built once into ``build/native/`` (``data/_native.py``).
A host without the libav shared libraries cannot load it: every call into
it then raises :class:`VideoDecodeError` naming the missing library.
``VIDEO_BACKEND=cv2`` (or ``imageio``) decodes :func:`sample_video_frames`
through that package instead, as in the JAX package; the in-decoder crop
paths need the native library.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from deepfake_video_detection_tpu_torch.data import _native

_LIB = "libvideodec.so"
_SOURCES = ("videodec.cc", "haar.cc")      # haar.cc: the in-decoder face scan
_LINK = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")


class VideoDecodeError(RuntimeError):
    pass


def _bind(lib: ctypes.CDLL) -> None:
    c_int, c_double, c_char_p = ctypes.c_int, ctypes.c_double, ctypes.c_char_p
    u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.vd_probe.argtypes = [
        c_char_p, ctypes.POINTER(c_int), ctypes.POINTER(c_int), f64p,
        ctypes.POINTER(ctypes.c_int64), c_char_p, c_int]
    lib.vd_sample.argtypes = [c_char_p, c_int, c_int, c_int, c_int, c_int, u8p,
                              c_char_p, c_int]
    lib.vd_sample_crop.argtypes = [c_char_p] + [c_int] * 9 + [u8p, c_char_p, c_int]
    lib.vd_sample_seek_crop.argtypes = [c_char_p] + [c_int] * 7 + [u8p, c_char_p, c_int]
    lib.vd_sample_seek_crop_yuv.argtypes = lib.vd_sample_seek_crop.argtypes
    lib.vd_sample_seek_center.argtypes = [c_char_p] + [c_int] * 4 + [u8p, c_char_p,
                                                                    c_int]
    lib.vd_sample_seek_center_yuv.argtypes = lib.vd_sample_seek_center.argtypes
    lib.vd_sample_seek_faces_yuv.argtypes = [
        c_char_p, c_int,
        # cascade arrays (HaarCascade, data/haar.py)
        i32p, f64p, i32p, f64p, f64p, i32p, f64p, c_int, c_int, c_int,
        # max_side, min_neighbors, track, track_expand, acquire
        c_int, c_int, c_int, c_double, c_int,
        # face_size, margin_ppm
        c_int, c_int,
        u8p, ctypes.POINTER(ctypes.c_float), u8p, c_char_p, c_int]
    lib.vd_encode.argtypes = [c_char_p, u8p, c_int, c_int, c_int, c_int, c_char_p, c_int]
    for fn in ("vd_probe", "vd_sample", "vd_sample_crop", "vd_sample_seek_crop",
               "vd_sample_seek_crop_yuv", "vd_sample_seek_center",
               "vd_sample_seek_center_yuv", "vd_sample_seek_faces_yuv", "vd_encode"):
        getattr(lib, fn).restype = c_int


def _get_lib() -> ctypes.CDLL:
    try:
        return _native.load(_LIB, _SOURCES, _LINK, _bind)
    except OSError as e:
        raise VideoDecodeError(str(e)) from e


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _check(n: int, path: str, err) -> int:
    if n < 0:
        raise VideoDecodeError(f"{path}: {err.value.decode(errors='replace')}")
    return n


def probe_video(path: str) -> Tuple[int, int, float, int]:
    """(width, height, fps, container nframes — 0 when unrecorded)."""
    lib = _get_lib()
    w, h, fps, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_double(), ctypes.c_int64()
    err = ctypes.create_string_buffer(256)
    rc = lib.vd_probe(path.encode(), ctypes.byref(w), ctypes.byref(h),
                      ctypes.byref(fps), ctypes.byref(n), err, 256)
    if rc != 0:
        raise VideoDecodeError(f"{path}: {err.value.decode(errors='replace')}")
    return w.value, h.value, fps.value, int(n.value)


def sample_video_frames(
    path: str,
    sample_rate: Optional[int] = None,
    max_frames: int = 32,
    size: Optional[Tuple[int, int]] = None,
    keyframes_only: Optional[bool] = None,
) -> np.ndarray:
    """Decode every ``sample_rate``-th frame up to ``max_frames``.

    Returns (N, H, W, 3) uint8 RGB. ``size=(w, h)`` rescales during decode;
    the default keeps the native resolution. ``sample_rate=None`` reads
    ``VIDEO_SAMPLE_RATE`` (default 5); ``keyframes_only=None`` reads
    ``VIDEO_KEYFRAMES_ONLY`` (decode intra frames only; ``sample_rate`` then
    counts keyframes). ``VIDEO_BACKEND=cv2|imageio`` decodes through that
    package when it is importable (every ``sample_rate``-th frame at native
    resolution; ``size`` and ``keyframes_only`` do not apply), else through
    the native decoder.
    """
    if sample_rate is None:
        try:
            sample_rate = max(1, int(os.environ.get("VIDEO_SAMPLE_RATE", "5")))
        except ValueError:
            sample_rate = 5
    if keyframes_only is None:
        keyframes_only = os.environ.get("VIDEO_KEYFRAMES_ONLY", "").strip(
        ).lower() in ("1", "true", "yes")
    backend = os.environ.get("VIDEO_BACKEND", "native").strip().lower()
    if backend in ("imageio", "cv2"):
        frames = _optional_backend(backend, path, sample_rate, max_frames)
        if frames is not None:
            return frames
    lib = _get_lib()
    if size is None:
        w, h, _, _ = probe_video(path)
    else:
        w, h = size
    out = np.empty((max_frames, h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    n = lib.vd_sample(path.encode(), int(sample_rate), int(max_frames), int(w), int(h),
                      1 if keyframes_only else 0, _u8(out), err, 256)
    return out[:_check(n, path, err)]


def _margin_ppm(margin: float) -> int:
    """Margin as parts-per-million of min(W, H), the in-decoder crop's
    integer representation; round(), so that 0.07 is 70000 exactly."""
    return int(round(margin * 1_000_000))


def center_crop_box(width: int, height: int, margin: float = 0.1):
    """Centred-square crop box by the in-decoder center crop's integer math
    (``native/videodec.cc:seek_sample_impl``), so the probe-then-crop route
    and the one-open center route crop the same pixels at every margin.
    Returns ``(x0, y0, side)``; a negative margin enlarges the square."""
    side = max(2, min(width, height) * (1_000_000 - _margin_ppm(margin)) // 1_000_000)
    return (width - side) // 2, (height - side) // 2, side


def sample_video_faces_center(
    path: str,
    face_size: int = 224,
    sample_rate: int = 5,
    max_frames: int = 8,
    margin: float = 0.1,
    keyframes_only: bool = False,
) -> np.ndarray:
    """Decode, centre-square-crop and resize inside the C++ decoder (the
    ``center`` face prior with no per-frame Python work). Returns
    (N, face_size, face_size, 3) uint8."""
    lib = _get_lib()
    w, h, _, _ = probe_video(path)
    x0, y0, side = center_crop_box(w, h, margin)
    out = np.empty((max_frames, face_size, face_size, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    n = lib.vd_sample_crop(path.encode(), int(sample_rate), int(max_frames), x0, y0,
                           side, side, face_size, face_size, 1 if keyframes_only else 0,
                           _u8(out), err, 256)
    return out[:_check(n, path, err)]


def sample_video_faces_spread(
    path: str,
    face_size: int = 224,
    n_frames: int = 8,
    margin: float = 0.1,
) -> np.ndarray:
    """Decode exactly ``n_frames`` keyframes spread evenly over the clip
    (one seek and one intra-frame decode each), centre-square-cropped and
    resized inside the decoder, which derives the crop from the stream's
    size. Returns (N, face_size, face_size, 3) uint8."""
    lib = _get_lib()
    out = np.empty((n_frames, face_size, face_size, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    n = lib.vd_sample_seek_center(path.encode(), int(n_frames), _margin_ppm(margin),
                                  face_size, face_size, _u8(out), err, 256)
    return out[:_check(n, path, err)]


def _out_slot(out: Optional[np.ndarray], n_frames: int, frame_bytes: int) -> np.ndarray:
    if out is None:
        return np.empty((n_frames, frame_bytes), np.uint8)
    if (out.dtype != np.uint8 or out.shape != (n_frames, frame_bytes)
            or not out.flags.c_contiguous):
        # a hard error, not an assert: the decoder writes n_frames *
        # frame_bytes raw bytes through this pointer
        raise ValueError("out buffer must be C-contiguous uint8 of shape "
                         f"{(n_frames, frame_bytes)}; got {out.dtype} {out.shape}")
    return out


def sample_video_faces_spread_yuv(
    path: str,
    face_size: int = 224,
    n_frames: int = 8,
    margin: float = 0.1,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """:func:`sample_video_faces_spread` as packed planar YUV420:
    (N, face_size²·3/2) uint8, Y then U then V per frame, half the bytes
    of RGB (``ops/preprocess.py::fused_normalize_yuv`` converts and
    normalises on the device). ``out``: a preallocated C-contiguous
    (n_frames, face_size²·3/2) uint8 buffer to decode into, such as one
    slot of a batch array."""
    assert face_size % 2 == 0, "yuv420 needs an even face size"
    lib = _get_lib()
    out = _out_slot(out, n_frames, face_size * face_size * 3 // 2)
    err = ctypes.create_string_buffer(256)
    n = lib.vd_sample_seek_center_yuv(path.encode(), int(n_frames), _margin_ppm(margin),
                                      face_size, face_size, _u8(out), err, 256)
    return out[:_check(n, path, err)]


def _cascade_ctypes_views(cascade):
    """Contiguous, correctly typed views of a parsed ``HaarCascade``'s
    arrays, cached on the cascade (built once, reused per clip)."""
    views = getattr(cascade, "_native_views", None)
    if views is None:
        views = (
            np.ascontiguousarray(cascade.rects, np.int32),
            np.ascontiguousarray(cascade.weights, np.float64),
            np.ascontiguousarray(cascade.feat_idx, np.int32),
            np.ascontiguousarray(cascade.node_thr, np.float64),
            np.ascontiguousarray(cascade.leaves, np.float64),
            np.ascontiguousarray(cascade.stage_ends, np.int32),
            np.ascontiguousarray(cascade.stage_thr, np.float64),
        )
        cascade._native_views = views
    return views


def sample_video_faces_haar_yuv(
    path: str,
    cascade,
    face_size: int = 224,
    n_frames: int = 8,
    margin: float = 0.1,
    max_side: int = 320,
    min_neighbors: int = 4,
    track: bool = True,
    track_expand: float = 2.0,
    acquire: bool = True,
    out: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seek-sample ``n_frames`` keyframes with Viola-Jones face detection
    inside the C++ decoder (``vd_sample_seek_faces_yuv``): the largest face
    on the luma plane at detection resolution, temporal ROI tracking, and
    the crop taken from the native YUV planes, in one GIL-free call.
    ``acquire`` scans non-tracked frames coarse to fine (half resolution,
    then a full-resolution ROI refinement, with a full scan when the coarse
    pass finds nothing).

    Returns ``(packed, boxes, found)``: (k, face_size²·3/2) uint8 packed
    YUV420 crops, (k, 4) float32 xyxy crop boxes, and a (k,) bool mask,
    True where a face was detected (other frames carry the centred-square
    prior crop).
    """
    assert face_size % 2 == 0, "yuv420 needs an even face size"
    if cascade.win_w != cascade.win_h:
        raise ValueError("native face pipeline assumes a square haar window")
    lib = _get_lib()
    out = _out_slot(out, n_frames, face_size * face_size * 3 // 2)
    (rects, weights, feat_idx, node_thr, leaves, stage_ends,
     stage_thr) = _cascade_ctypes_views(cascade)
    boxes = np.empty((n_frames, 4), np.float32)
    found = np.zeros((n_frames,), np.uint8)
    err = ctypes.create_string_buffer(256)

    def p(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    n = lib.vd_sample_seek_faces_yuv(
        path.encode(), int(n_frames),
        p(rects, ctypes.c_int32), p(weights, ctypes.c_double),
        p(feat_idx, ctypes.c_int32), p(node_thr, ctypes.c_double),
        p(leaves, ctypes.c_double), p(stage_ends, ctypes.c_int32),
        p(stage_thr, ctypes.c_double), int(cascade.n_stages),
        int(cascade.win_w), int(cascade.win_h),
        int(max_side), int(min_neighbors), 1 if track else 0,
        float(track_expand), 1 if acquire else 0,
        int(face_size), _margin_ppm(margin),
        p(out, ctypes.c_uint8), p(boxes, ctypes.c_float),
        p(found, ctypes.c_uint8), err, 256)
    n = _check(n, path, err)
    # found codes: 0 none, 1 tracked ROI, 2 coarse-acquired, 3 full scan
    return out[:n], boxes[:n], found[:n] > 0


def encode_video(path: str, frames: np.ndarray, fps: int = 25) -> None:
    """Write (N, H, W, 3) uint8 RGB frames as an mpeg4 video."""
    frames = np.ascontiguousarray(frames, np.uint8)
    n, h, w, c = frames.shape
    assert c == 3
    lib = _get_lib()
    err = ctypes.create_string_buffer(256)
    if lib.vd_encode(path.encode(), _u8(frames), n, w, h, fps, err, 256) != 0:
        raise VideoDecodeError(f"{path}: {err.value.decode(errors='replace')}")


def backend_frame_count(backend: str, path: str) -> int:
    """The container's frame count through cv2 (``CAP_PROP_FRAME_COUNT``)
    or imageio, for ``VIDEO_BACKEND=cv2|imageio``; 0 when it is unknown or
    the package is missing."""
    try:
        if backend == "cv2":
            import cv2

            cap = cv2.VideoCapture(path)
            try:
                return max(0, int(cap.get(cv2.CAP_PROP_FRAME_COUNT)))
            finally:
                cap.release()
        if backend == "imageio":
            import imageio.v2 as iio

            reader = iio.get_reader(path)
            try:
                return max(0, int(reader.count_frames()))
            finally:
                reader.close()
    except Exception:
        return 0
    return 0


def _optional_backend(backend: str, path: str, sample_rate: int,
                      max_frames: int) -> Optional[np.ndarray]:
    """Decode through imageio or cv2; None when the package is missing (the
    caller then falls through to the native decoder)."""
    try:
        if backend == "imageio":
            import imageio.v2 as iio

            reader = iio.get_reader(path)
            frames = []
            for i, fr in enumerate(reader):
                if i % sample_rate == 0:
                    frames.append(np.asarray(fr)[..., :3])
                    if len(frames) >= max_frames:
                        break
            reader.close()
            return np.stack(frames) if frames else np.zeros((0, 0, 0, 3), np.uint8)
        if backend == "cv2":
            import cv2

            cap = cv2.VideoCapture(path)
            frames = []
            i = 0
            while cap.isOpened() and len(frames) < max_frames:
                ok, fr = cap.read()
                if not ok:
                    break
                if i % sample_rate == 0:
                    frames.append(cv2.cvtColor(fr, cv2.COLOR_BGR2RGB))
                i += 1
            cap.release()
            return np.stack(frames) if frames else np.zeros((0, 0, 0, 3), np.uint8)
    except ImportError:
        return None
    return None
