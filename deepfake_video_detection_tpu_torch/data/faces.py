"""Face extraction: video → per-frame face crops.

Counterpart of ``deepfake_video_detection_tpu/data/faces.py``: sample
frames, detect faces (the largest box unless ``KEEP_ALL_FACES``), expand
each box by the margin and resize the crops to ``FACE_SIZE`` (default 224).
Env knobs: ``VIDEO_SAMPLE_RATE``, ``FACE_DETECTOR``, ``MAX_FRAMES``,
``FACE_SIZE``, ``KEEP_ALL_FACES``, ``HAAR_TRACK``, ``HAAR_TRACK_EXPAND``,
``HAAR_MIN_NEIGHBORS``, ``HAAR_MAX_SIDE``, ``HAAR_ACQUIRE``.

Detectors:
* ``haar``   — the first-party Viola-Jones detector (``data/haar.py`` and
  ``native/haar.cc``) over the Haar cascade XMLs installed with OpenCV,
  on the host;
* ``center`` — the weight-free prior: a centred square with margin, cropped
  inside the native decoder on the fast paths;
* ``none``   — the frames are already face crops;
* ``auto``   (default) — mtcnn if ``MTCNN_WEIGHTS`` names a file, else haar
  if a cascade XML is found, else center;
* ``mtcnn``  — the fixed-buffer cascade (``models/mtcnn.py``) on the
  extractor's device, weights in facenet-pytorch's layout from
  ``MTCNN_WEIGHTS`` (random from a generator seeded 0 without a file); a
  clip in which it finds nothing goes through haar before the center prior.

The crops of a clip are resized together on the extractor's device by
:func:`crop_and_resize_batch`, two batched f32 products with
``jax.image.scale_and_translate``'s weight matrices.

With ``VIDEO_BACKEND=cv2`` or ``imageio`` the center detector decodes
through that package and crops with the center prior
(:meth:`FaceExtractor.extract_from_video`): its in-decoder crop needs the
native decoder, and on a host without libav the JAX
package's center branch fails on every clip.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Optional

import numpy as np
import torch

from deepfake_video_detection_tpu_torch.checkpoint.store import load_any
from deepfake_video_detection_tpu_torch.data.augment import resample_weights
from deepfake_video_detection_tpu_torch.data.haar import detect_faces, get_default_cascade
from deepfake_video_detection_tpu_torch.data.video import (
    backend_frame_count, center_crop_box, probe_video, sample_video_faces_center,
    sample_video_faces_haar_yuv, sample_video_faces_spread, sample_video_faces_spread_yuv,
    sample_video_frames)
from deepfake_video_detection_tpu_torch.models.mtcnn import MTCNN, import_facenet_weights
from deepfake_video_detection_tpu_torch.utils.config import env_int
from deepfake_video_detection_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def _env_flag(name: str, default: str = "") -> bool:
    return os.environ.get(name, default).strip().lower() in ("1", "true", "yes")


def _haar_track(keep_all: bool):
    """(track, expand) from ``HAAR_TRACK`` (default on; single-face mode
    only) and ``HAAR_TRACK_EXPAND`` (default 2.0, at least 1.2)."""
    track = (not keep_all and os.environ.get("HAAR_TRACK", "1").strip().lower()
             not in ("0", "false", "no"))
    try:
        expand = float(os.environ.get("HAAR_TRACK_EXPAND", "") or 2.0)
    except ValueError:
        expand = 2.0
    return track, max(1.2, expand)


def center_square_boxes(n: int, height: int, width: int,
                        margin: float = 0.1) -> np.ndarray:
    """Centred square with ``margin`` shaved off each side, (n, 4) xyxy, by
    the in-decoder center crop's integer math (``center_crop_box``), so the
    frames path and the decode path crop the same box."""
    x0, y0, side = center_crop_box(width, height, margin)
    return np.tile(np.array([x0, y0, x0 + side, y0 + side], np.float32), (n, 1))


def crop_and_resize_batch(frames: np.ndarray, boxes: np.ndarray, size: int,
                          device: Any = "cuda") -> np.ndarray:
    """Crop box i from frame i and resize it to (size, size), all boxes at
    once on ``device``. ``frames`` (N, H, W, 3) uint8, ``boxes`` (N, 4) xyxy
    float; returns (N, size, size, 3) uint8.

    The function of the JAX package's jitted, vmapped
    ``jax.image.scale_and_translate(frame, (size, size, 3), (0, 1),
    [size/h, size/w], [-y1·size/h, -x1·size/w], "linear")`` (antialiased):
    per box, the (H, size) row and (W, size) column weight matrices of
    ``data/augment.py::resample_weights``, two batched f32 products, then
    clip to [0, 255] and truncate to uint8 as ``astype(jnp.uint8)`` does.
    The two packages sum in different orders, so a byte may differ by 1."""
    dev = torch.device(device)
    n, H, W, C = frames.shape
    if n == 0:
        return np.zeros((0, size, size, C), np.uint8)
    b = torch.from_numpy(np.ascontiguousarray(boxes, np.float32)).to(dev)
    x = torch.from_numpy(np.ascontiguousarray(frames, np.uint8)).to(dev)
    x1, y1 = b[:, 0], b[:, 1]
    scale_y = size / torch.clamp(b[:, 3] - y1, min=1.0)
    scale_x = size / torch.clamp(b[:, 2] - x1, min=1.0)
    wy = resample_weights(H, size, scale_y, -y1 * scale_y, True)       # (N, H, size)
    wx = resample_weights(W, size, scale_x, -x1 * scale_x, True)       # (N, W, size)
    # columns first: the cheaper order for landscape frames (W > H)
    cols = x.to(torch.float32).transpose(2, 3).reshape(n, H * C, W)
    cols = torch.matmul(cols, wx)                                          # (N, H·C, size)
    out = torch.matmul(wy.transpose(1, 2), cols.reshape(n, H, C * size))   # (N, size, C·size)
    out = out.reshape(n, size, C, size).transpose(2, 3)                    # (N, size, size, C)
    return torch.clamp(out, 0, 255).to(torch.uint8).contiguous().cpu().numpy()


class FaceExtractor:
    """Frames or a video file → face crops, on ``device`` for the resize
    (``utils/device.py::resolve_device``: CUDA unless the caller names
    another device; raises without a card) and the mtcnn cascade. Requests
    and loader threads share one extractor: it holds no state between calls
    except the ``last_*`` attributes of :meth:`extract_from_video_yuv` and
    one cascade per frame size, built once under a lock."""

    def __init__(self, detector: Optional[str] = None,
                 face_size: Optional[int] = None,
                 keep_all: Optional[bool] = None,
                 margin: float = 0.1,
                 mtcnn_weights: Optional[str] = None,
                 device: Any = "cuda"):
        self.device = resolve_device(device)
        self._mtcnn_weights = mtcnn_weights or os.environ.get("MTCNN_WEIGHTS")
        requested = (detector or os.environ.get("FACE_DETECTOR", "auto")).strip().lower()
        self.face_size = face_size or env_int("FACE_SIZE", 224)
        self.keep_all = _env_flag("KEEP_ALL_FACES") if keep_all is None else keep_all
        self.margin = margin
        self._mtcnn_cache = {}
        self._mtcnn_params = None
        self._mtcnn_lock = threading.Lock()
        self.detector = self._resolve_detector(requested)

    def _resolve_detector(self, requested: str) -> str:
        """Fallback chain mtcnn → haar → center, with a warning at each step
        down, so detection never silently becomes the center prior."""
        have_weights = bool(self._mtcnn_weights and os.path.exists(self._mtcnn_weights))

        def have_haar() -> bool:
            return get_default_cascade() is not None

        if requested == "auto":
            if have_weights:
                return "mtcnn"
            return "haar" if have_haar() else "center"
        if requested == "mtcnn" and not have_weights:
            nxt = "haar" if have_haar() else "center"
            logger.warning(
                "FACE_DETECTOR=mtcnn requested but MTCNN_WEIGHTS is unset — "
                "falling back to the '%s' detector. Export weights with "
                "tools/export_facenet_mtcnn.py and set MTCNN_WEIGHTS.", nxt)
            return nxt
        if requested == "haar":
            if have_haar():
                return "haar"
            logger.warning(
                "FACE_DETECTOR=haar requested but no Haar cascade XML was "
                "found (set HAAR_CASCADE or install the OpenCV haarcascades "
                "data) — falling back to the 'center' face prior.")
            return "center"
        return requested

    # -- detection ------------------------------------------------------------

    def _mtcnn(self, height: int, width: int) -> MTCNN:
        """The cascade for (height, width) frames, built on first use: weights
        from ``mtcnn_weights`` / ``MTCNN_WEIGHTS`` (a facenet-layout ``.pt`` or
        ``.npz``), else random from a generator seeded 0 (the JAX package
        draws from ``PRNGKey(0)``: other numbers)."""
        with self._mtcnn_lock:
            det = self._mtcnn_cache.get((height, width))
            if det is None:
                det = MTCNN((height, width), device=self.device)
                if self._mtcnn_weights:
                    if self._mtcnn_params is None:
                        sd, _ = load_any(self._mtcnn_weights)
                        self._mtcnn_params = import_facenet_weights(sd)
                    det.load_state_dict(self._mtcnn_params, strict=True)
                det.eval()
                self._mtcnn_cache[(height, width)] = det
        return det

    def _detect_mtcnn(self, frames: np.ndarray):
        """Per-frame mtcnn boxes (xyxy), one cascade over all the frames: the
        largest valid box unless ``keep_all``; None for a frame without one."""
        det = self._mtcnn(frames.shape[1], frames.shape[2])
        boxes, _, valid = det.detect(frames)
        all_boxes, all_valid = boxes.cpu().numpy(), valid.cpu().numpy()
        out = []
        for b, v in zip(all_boxes, all_valid):
            if not v.any():
                out.append(None)
            elif self.keep_all:
                out.append(b[v])
            else:   # the largest valid box, as the reference keeps
                areas = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
                areas[~v] = -1
                out.append(b[int(areas.argmax())][None])
        return out

    def _detect_haar(self, frames: np.ndarray):
        """Per-frame Viola-Jones boxes (xyxy): the largest unless
        ``keep_all``; None for a frame without a detection.

        Tracking (``HAAR_TRACK``, default on, single-face mode): after a
        full detection, the next frame scans only an ``HAAR_TRACK_EXPAND``×
        window around the previous box, its pyramid pruned to 0.6-1.6× the
        tracked size, and falls back to a full-frame scan when the track
        yields nothing. While a track holds, a larger face entering
        elsewhere is not switched to; ``HAAR_TRACK=0`` scans every frame."""
        min_neighbors = env_int("HAAR_MIN_NEIGHBORS", 4)
        track, expand = _haar_track(self.keep_all)
        out = []
        prev = None  # the last kept (largest) box, xyxy
        for frame in frames:
            xyxy = None
            if track and prev is not None:
                side = max(prev[2] - prev[0], prev[3] - prev[1])
                cx = 0.5 * (prev[0] + prev[2])
                cy = 0.5 * (prev[1] + prev[3])
                half = 0.5 * side * expand
                xyxy, _ = detect_faces(
                    frame, min_neighbors=min_neighbors,
                    roi=(cx - half, cy - half, cx + half, cy + half),
                    min_size_px=0.6 * side, max_size_px=1.6 * side)
                if len(xyxy) == 0:
                    xyxy = None  # track lost: full-frame rescan below
            if xyxy is None:
                xyxy, _ = detect_faces(frame, min_neighbors=min_neighbors)
            if len(xyxy) == 0:
                out.append(None)
                prev = None
            elif self.keep_all:
                out.append(xyxy)
            else:
                areas = (xyxy[:, 2] - xyxy[:, 0]) * (xyxy[:, 3] - xyxy[:, 1])
                best = xyxy[int(np.argmax(areas))][None]
                out.append(best)
                prev = best[0]
        return out

    # -- public API -----------------------------------------------------------

    def extract_from_frames_batch(self, clips) -> list:
        """:meth:`extract_from_frames` over each of ``clips``, a sequence of
        (T_i, H, W, 3) uint8 arrays, the same crops. For the mtcnn detector
        one cascade runs over all the clips' frames (clips of one frame
        size; otherwise, and for the other detectors, clip by clip). Nothing
        is compiled per shape, so a ragged batch (clips of other lengths)
        costs no more than an even one."""
        clips = [np.asarray(c) for c in clips]
        shapes = {c.shape[1:3] for c in clips if c.size}
        if self.detector != "mtcnn" or len(shapes) != 1:
            return [self.extract_from_frames(c) for c in clips]
        per_frame = self._detect_mtcnn(np.concatenate([c for c in clips if c.size]))
        out, i = [], 0
        for c in clips:
            n = c.shape[0] if c.size else 0
            out.append(self.extract_from_frames(c, _boxes=per_frame[i:i + n]))
            i += n
        return out

    def extract_from_frames(self, frames: np.ndarray, _boxes=None) -> np.ndarray:
        """(N, H, W, 3) uint8 frames → (M, face_size, face_size, 3) uint8.
        A clip in which mtcnn finds nothing goes through haar (where a
        cascade XML is found); one in which the detector finds nothing is
        cropped with the center prior on every frame. ``_boxes``: per-frame
        detections already made (:meth:`extract_from_frames_batch`)."""
        if frames.size == 0:
            return np.zeros((0, self.face_size, self.face_size, 3), np.uint8)
        n, H, W = frames.shape[0], frames.shape[1], frames.shape[2]
        if self.detector == "none":
            boxes = np.tile(np.array([0, 0, W, H], np.float32), (n, 1))
            return crop_and_resize_batch(frames, boxes, self.face_size, self.device)
        if self.detector in ("mtcnn", "haar"):
            per_frame = (_boxes if _boxes is not None
                         else self._detect_mtcnn(frames) if self.detector == "mtcnn"
                         else self._detect_haar(frames))
            sel_frames, sel_boxes = [], []
            for frame, boxes in zip(frames, per_frame):
                if boxes is None:
                    continue
                for b in boxes:
                    # margin expansion, as the reference's crop margin
                    w, h = b[2] - b[0], b[3] - b[1]
                    m = self.margin
                    sel_boxes.append([b[0] - w * m, b[1] - h * m,
                                      b[2] + w * m, b[3] + h * m])
                    sel_frames.append(frame)
            if sel_boxes:
                return crop_and_resize_batch(np.stack(sel_frames),
                                             np.asarray(sel_boxes, np.float32),
                                             self.face_size, self.device)
            if self.detector == "mtcnn" and get_default_cascade() is not None:
                # the reference runs the Haar pass when MTCNN finds nothing
                chain = FaceExtractor(detector="haar", face_size=self.face_size,
                                      keep_all=self.keep_all, margin=self.margin,
                                      device=self.device)
                if chain.detector != "mtcnn":   # never recurse into this fallback
                    return chain.extract_from_frames(frames)
        # the center prior, and the detector's whole-clip fallback
        boxes = center_square_boxes(n, H, W, self.margin)
        return crop_and_resize_batch(frames, boxes, self.face_size, self.device)

    def extract_from_video(self, path: str,
                           sample_rate: Optional[int] = None,
                           max_frames: Optional[int] = None,
                           keyframes_only: Optional[bool] = None,
                           spread: bool = False) -> np.ndarray:
        """Face crops of a video file, (M, face_size, face_size, 3) uint8.

        ``spread=True`` spreads the samples over the whole clip (long-video
        scanning, ``SERVE_WINDOWS``): seek sampling for the center detector,
        a stride from the container's frame count otherwise; the default
        scan reads the first ``sample_rate * max_frames`` frames. Where the
        native probe fails (no libav), the JAX package keeps the default
        stride and so reads only the clip's head; under
        ``VIDEO_BACKEND=cv2|imageio`` the port takes the frame count from
        that backend instead.
        With ``VIDEO_BACKEND=cv2|imageio`` the center detector takes the
        generic route (decode, then the center prior's crops), since its
        in-decoder crop needs the native decoder.
        """
        if max_frames is None:
            max_frames = max(1, min(env_int("MAX_FRAMES", 8), 64))
        backend = os.environ.get("VIDEO_BACKEND", "native").strip().lower()
        python_decoder = backend in ("cv2", "imageio")
        if self.detector == "center" and not python_decoder:
            # crop and resize inside the C++ decode, GIL-free
            if keyframes_only is None:
                keyframes_only = _env_flag("VIDEO_KEYFRAMES_ONLY")
            if spread or (keyframes_only and _env_flag("VIDEO_SEEK_SAMPLING", "1")):
                # exactly max_frames keyframe decodes, evenly spread
                return sample_video_faces_spread(path, face_size=self.face_size,
                                                 n_frames=max_frames, margin=self.margin)
            if sample_rate is None:
                sample_rate = max(1, env_int("VIDEO_SAMPLE_RATE", 5))
            return sample_video_faces_center(
                path, face_size=self.face_size, sample_rate=sample_rate,
                max_frames=max_frames, margin=self.margin, keyframes_only=keyframes_only)
        if spread and sample_rate is None:
            # stride the clip so that max_frames samples span it end to end
            n_total = 0
            try:
                _, _, _, n_total = probe_video(path)
            except Exception:
                if python_decoder:
                    n_total = backend_frame_count(backend, path)
            if n_total > 0:
                sample_rate = max(1, n_total // max(1, max_frames))
        frames = sample_video_frames(path, sample_rate=sample_rate, max_frames=max_frames,
                                     keyframes_only=keyframes_only)
        return self.extract_from_frames(frames)

    def extract_from_video_yuv(self, path: str,
                               max_frames: Optional[int] = None,
                               out: Optional[np.ndarray] = None) -> np.ndarray:
        """The transfer-optimal path (``center`` and ``haar``): seek-sampled
        face crops as packed planar YUV420, (N, face_size²·3/2) uint8, half
        the host→device bytes of RGB (``ops/preprocess.py::
        fused_normalize_yuv`` converts on the device). For ``haar`` the
        seek-decode, the luma-plane detection with tracking and the crop
        from the YUV planes run in one GIL-free C++ call; frames without a
        detection are dropped, and a clip with none anywhere keeps the
        center-prior crops of every frame.

        After a ``haar`` call:
        * ``last_boxes`` — (M, 4) crop boxes, row i pairing with returned
          row i;
        * ``last_found`` — (n_sampled,) detected-or-not by sampled frame;
        * ``last_frame_index`` — (M,) the sampled frame of each returned row.

        ``out``: a preallocated (max_frames, face_size²·3/2) uint8 slot to
        decode into."""
        if self.detector not in ("center", "haar"):
            raise ValueError("YUV fast path requires detector 'center' or "
                             f"'haar' (got {self.detector!r})")
        if self.detector == "haar" and self.keep_all:
            # the in-decoder pipeline keeps the largest face only
            raise ValueError("YUV fast path with haar is largest-face only; "
                             "KEEP_ALL_FACES requires the RGB path")
        if max_frames is None:
            max_frames = max(1, min(env_int("MAX_FRAMES", 8), 64))
        if self.detector == "center":
            return sample_video_faces_spread_yuv(path, face_size=self.face_size,
                                                 n_frames=max_frames, margin=self.margin,
                                                 out=out)
        track, expand = _haar_track(self.keep_all)
        packed, boxes, found = sample_video_faces_haar_yuv(
            path, get_default_cascade(), face_size=self.face_size,
            n_frames=max_frames, margin=self.margin,
            max_side=env_int("HAAR_MAX_SIDE", 320),
            min_neighbors=env_int("HAAR_MIN_NEIGHBORS", 4),
            track=track, track_expand=expand,
            acquire=env_int("HAAR_ACQUIRE", 1) != 0, out=out)
        self.last_found = found
        if found.any() and not found.all():
            # drop the undetected frames, compacting in place so that a
            # caller's batch slot stays dense
            k = int(found.sum())
            packed[:k] = packed[found]
            self.last_boxes = boxes[found]
            self.last_frame_index = np.flatnonzero(found)
            return packed[:k]
        self.last_boxes = boxes
        self.last_frame_index = np.arange(boxes.shape[0])
        return packed
