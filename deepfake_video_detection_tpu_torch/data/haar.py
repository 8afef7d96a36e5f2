"""First-party Viola-Jones face detector over OpenCV Haar cascade XMLs.

Counterpart of ``deepfake_video_detection_tpu/data/haar.py`` (numpy only;
the port keeps its own copy). ``HaarCascade`` parses the stump-based
cascade format into flat arrays; detection follows OpenCV's
``detectMultiScale``: an image pyramid at ``scale_factor`` with the fixed
window (stride 2), integral and squared-integral images, per-window
variance normalisation, staged sums of stumps with early rejection, then
``groupRectangles``-style clustering with a ``min_neighbors`` vote. The
pyramid scan runs in the C++ engine (``data/haar_native.py``) when its
library loads, else in the vectorised numpy engine; the two agree window
for window.

It runs on the host, between decode and the device's crop, normalise and
forward: a dynamically shaped, early-exit cascade does not suit the card.
"""

from __future__ import annotations

import math
import os
import threading
import xml.etree.ElementTree as ET
from typing import Optional, Tuple

import numpy as np

# well-known install locations for the cascade XMLs (cv2 wheel data dir,
# distro package); HAAR_CASCADE overrides with an explicit path
_CASCADE_SEARCH_DIRS = (
    "/usr/share/opencv4/haarcascades",
    "/usr/local/share/opencv4/haarcascades",
    "/usr/share/opencv/haarcascades",
)


def find_cascade_file(name: str = "haarcascade_frontalface_default.xml"
                      ) -> Optional[str]:
    env = os.environ.get("HAAR_CASCADE", "").strip()
    if env:
        return env if os.path.exists(env) else None
    try:  # cv2 wheels normally bundle the XMLs next to cv2.data
        import cv2.data as _cvd  # type: ignore

        p = os.path.join(_cvd.haarcascades, name)
        if os.path.exists(p):
            return p
    except Exception:
        pass
    for d in _CASCADE_SEARCH_DIRS:
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    return None


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """BT.601 luma, the same weights cv2.COLOR_RGB2GRAY uses."""
    return (rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587
            + rgb[..., 2] * 0.114).astype(np.float32)


def _resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w = img.shape
    if (h, w) == (out_h, out_w):
        return img
    ys = (np.arange(out_h, dtype=np.float32) + 0.5) * (h / out_h) - 0.5
    xs = (np.arange(out_w, dtype=np.float32) + 0.5) * (w / out_w) - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = np.clip(ys - y0, 0, 1).astype(np.float32)[:, None]
    fx = np.clip(xs - x0, 0, 1).astype(np.float32)[None, :]
    img = img.astype(np.float32)
    top = img[np.ix_(y0, x0)] * (1 - fx) + img[np.ix_(y0, x1)] * fx
    bot = img[np.ix_(y1, x0)] * (1 - fx) + img[np.ix_(y1, x1)] * fx
    return top * (1 - fy) + bot * fy


def group_rectangles(boxes: np.ndarray, min_neighbors: int = 4,
                     eps: float = 0.2) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV ``groupRectangles``-style clustering: union similar boxes
    (all four edge deltas within ``eps``·mean-side), average each cluster,
    keep clusters with >= ``min_neighbors`` members. ``boxes`` (n,4) xywh;
    returns (k,4) xywh float64 + (k,) member counts."""
    n = len(boxes)
    if n == 0:
        return np.zeros((0, 4)), np.zeros((0,), np.int64)
    boxes = np.asarray(boxes, np.float64)
    parent = np.arange(n)

    def find(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    x1, y1 = boxes[:, 0], boxes[:, 1]
    x2, y2 = x1 + boxes[:, 2], y1 + boxes[:, 3]
    for i in range(n):
        d = eps * 0.5 * (np.minimum(boxes[i, 2], boxes[:, 2])
                         + np.minimum(boxes[i, 3], boxes[:, 3]))
        sim = np.flatnonzero((np.abs(x1[i] - x1) <= d)
                             & (np.abs(y1[i] - y1) <= d)
                             & (np.abs(x2[i] - x2) <= d)
                             & (np.abs(y2[i] - y2) <= d))
        ri = find(i)
        for j in sim:
            rj = find(int(j))
            if ri != rj:
                parent[rj] = ri
    roots = np.array([find(i) for i in range(n)])
    out, counts = [], []
    for root in np.unique(roots):
        members = boxes[roots == root]
        if len(members) >= min_neighbors:
            out.append(members.mean(0))
            counts.append(len(members))
    if not out:
        return np.zeros((0, 4)), np.zeros((0,), np.int64)
    order = np.argsort(counts)[::-1]
    return np.stack(out)[order], np.asarray(counts, np.int64)[order]


class HaarCascade:
    """Parsed stump cascade + multi-scale detector."""

    def __init__(self, path: Optional[str] = None):
        path = path or find_cascade_file()
        if path is None:
            raise FileNotFoundError(
                "no Haar cascade XML found — set HAAR_CASCADE or install "
                "the OpenCV haarcascades data files")
        self.path = path
        root = ET.parse(path).getroot()
        c = root.find("cascade")
        if c is None or (c.findtext("featureType") or "").strip() != "HAAR":
            raise ValueError(f"not a HAAR stump cascade: {path}")
        self.win_h = int(c.findtext("height"))
        self.win_w = int(c.findtext("width"))

        feats = c.find("features")
        F = len(feats)
        self.rects = np.zeros((F, 3, 4), np.int32)
        self.weights = np.zeros((F, 3), np.float64)
        for i, f in enumerate(feats):
            if (f.findtext("tilted") or "0").strip() == "1":
                raise ValueError(
                    f"tilted HAAR features not supported ({path})")
            for j, r in enumerate(f.find("rects")):
                vals = r.text.split()
                self.rects[i, j] = [int(v) for v in vals[:4]]
                self.weights[i, j] = float(vals[4].rstrip("."))

        stage_thr, stage_ends = [], []
        feat_idx, node_thr, leaves = [], [], []
        for s in c.find("stages"):
            for w in s.find("weakClassifiers"):
                nodes = (w.findtext("internalNodes") or "").split()
                if len(nodes) != 4 or nodes[0] != "0" or nodes[1] != "-1":
                    raise ValueError(
                        f"only stump (depth-1) cascades supported: {path}")
                lv = (w.findtext("leafValues") or "").split()
                feat_idx.append(int(nodes[2]))
                node_thr.append(float(nodes[3]))
                leaves.append([float(lv[0]), float(lv[1])])
            stage_thr.append(float(s.findtext("stageThreshold")))
            stage_ends.append(len(feat_idx))
        self.stage_thr = np.asarray(stage_thr)
        self.stage_ends = np.asarray(stage_ends, np.int32)
        self.feat_idx = np.asarray(feat_idx, np.int64)
        self.node_thr = np.asarray(node_thr)
        self.leaves = np.asarray(leaves)
        self.n_stages = len(self.stage_thr)

    # -- engines --------------------------------------------------------------

    def _scan_level_numpy(self, gray: np.ndarray) -> np.ndarray:
        """All surviving window origins (n,2) [x,y] at ONE pyramid level —
        vectorized over windows, stage-by-stage early rejection."""
        wh, ww = self.win_h, self.win_w
        H, W = gray.shape
        if H < wh or W < ww:
            return np.zeros((0, 2), np.int64)
        g = gray.astype(np.float64)
        ii = np.zeros((H + 1, W + 1))
        ii[1:, 1:] = g.cumsum(0).cumsum(1)
        ii2 = np.zeros((H + 1, W + 1))
        ii2[1:, 1:] = (g * g).cumsum(0).cumsum(1)
        iif = ii.ravel()
        W1 = W + 1

        ys0 = np.arange(0, H - wh + 1, 2)
        xs0 = np.arange(0, W - ww + 1, 2)
        ys, xs = np.meshgrid(ys0, xs0, indexing="ij")
        ys, xs = ys.ravel(), xs.ravel()

        nx1, ny1, nx2, ny2 = xs + 1, ys + 1, xs + ww - 1, ys + wh - 1
        area = float((ww - 2) * (wh - 2))
        s1 = ii[ny2, nx2] - ii[ny1, nx2] - ii[ny2, nx1] + ii[ny1, nx1]
        s2 = ii2[ny2, nx2] - ii2[ny1, nx2] - ii2[ny2, nx1] + ii2[ny1, nx1]
        nf2 = area * s2 - s1 * s1
        inv_nf = np.where(nf2 > 0,
                          1.0 / np.sqrt(np.where(nf2 > 0, nf2, 1.0)), 1.0)

        origins = ys * W1 + xs
        start = 0
        for si in range(self.n_stages):
            if origins.size == 0:
                break
            end = int(self.stage_ends[si])
            fi = self.feat_idx[start:end]
            r = self.rects[fi]
            w = self.weights[fi]
            vals = np.zeros((origins.size, fi.size))
            for j in range(3):
                act = w[:, j] != 0
                if not act.any():
                    continue
                x, y = r[:, j, 0].astype(np.int64), r[:, j, 1].astype(np.int64)
                rw, rh = r[:, j, 2].astype(np.int64), r[:, j, 3].astype(np.int64)
                tl = y * W1 + x
                tr = y * W1 + x + rw
                bl = (y + rh) * W1 + x
                br = (y + rh) * W1 + x + rw
                o = origins[:, None]
                s = iif[o + br] - iif[o + tr] - iif[o + bl] + iif[o + tl]
                vals += np.where(act[None, :], s * w[None, :, j], 0.0)
            picked = np.where(
                vals * inv_nf[:, None] < self.node_thr[start:end][None, :],
                self.leaves[start:end, 0][None, :],
                self.leaves[start:end, 1][None, :])
            keep = picked.sum(1) >= self.stage_thr[si]
            origins, ys, xs, inv_nf = (origins[keep], ys[keep], xs[keep],
                                       inv_nf[keep])
            start = end
        if origins.size == 0:
            return np.zeros((0, 2), np.int64)
        return np.stack([xs, ys], 1)

    def _detect_raw_numpy(self, gray: np.ndarray, scale_factor: float,
                          min_size: int, max_size: Optional[int]
                          ) -> np.ndarray:
        H, W = gray.shape
        raw = []
        factor = max(1.0, min_size / self.win_w)
        while True:
            # half-away-from-zero to match std::lround in native/haar.cc
            # (Python round() is half-even: round(120.5) == 120 != lround)
            lh = int(math.floor(H / factor + 0.5))
            lw = int(math.floor(W / factor + 0.5))
            if lh < self.win_h or lw < self.win_w:
                break
            if max_size is not None and self.win_w * factor > max_size:
                break
            # round the level to integer pixel values — OpenCV scans uint8
            # pyramids, and it keeps this engine bit-identical to the C++
            # one (which builds exact uint64 integer integrals)
            level = np.rint(_resize_bilinear(gray.astype(np.float32), lh, lw))
            for x, y in self._scan_level_numpy(level):
                raw.append([x * factor, y * factor,
                            self.win_w * factor, self.win_h * factor])
            factor *= scale_factor
        return np.asarray(raw, np.float64).reshape(-1, 4)

    def _detect_raw_native(self, gray: np.ndarray, scale_factor: float,
                           min_size: int, max_size: Optional[int]
                           ) -> Optional[np.ndarray]:
        """C++ pyramid scan (native/haar.cc); None if the lib is missing."""
        try:
            from deepfake_video_detection_tpu_torch.data import haar_native
            return haar_native.detect_raw(self, gray, scale_factor,
                                          min_size, max_size)
        except Exception:
            return None

    # -- public API -----------------------------------------------------------

    def detect(self, gray: np.ndarray, scale_factor: float = 1.1,
               min_neighbors: int = 4, min_size: int = 24,
               max_size: Optional[int] = None,
               engine: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        """``detectMultiScale`` equivalent. ``gray`` (H,W); returns
        ((k,4) xywh float boxes sorted by vote count desc, (k,) counts)."""
        gray = np.ascontiguousarray(gray, np.float32)
        raw = None
        if engine in ("auto", "native"):
            raw = self._detect_raw_native(gray, scale_factor, min_size,
                                          max_size)
            if raw is None and engine == "native":
                raise RuntimeError("native haar engine unavailable")
        if raw is None:
            raw = self._detect_raw_numpy(gray, scale_factor, min_size,
                                         max_size)
        return group_rectangles(raw, min_neighbors=min_neighbors)


_DEFAULT: dict = {}
_DEFAULT_LOCK = threading.Lock()


def get_default_cascade() -> Optional[HaarCascade]:
    """Process-wide lazily parsed frontal-face cascade (None if no XML is
    installed). Parsing costs ~100 ms; detection reuses the arrays."""
    with _DEFAULT_LOCK:
        if "c" not in _DEFAULT:
            try:
                _DEFAULT["c"] = HaarCascade()
            except Exception:
                _DEFAULT["c"] = None
        return _DEFAULT["c"]


def detect_faces(frame_rgb: np.ndarray, cascade: Optional[HaarCascade] = None,
                 min_neighbors: int = 4, max_side: int = 320,
                 roi: Optional[Tuple[float, float, float, float]] = None,
                 min_size_px: Optional[float] = None,
                 max_size_px: Optional[float] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Detect faces on ONE RGB frame at full resolution.

    Detection runs on a <=``max_side`` downscaled luma copy (HAAR_MAX_SIDE
    env overrides; gray+downscale fused in C, ``haar_prepare``) — ~31 ms
    per 1080p frame all-in vs ~1 s detecting at native res, and DFDC-style
    faces are far above the implied ~7 %-of-frame minimum size. Returns
    ((k,4) xyxy boxes in ORIGINAL frame coordinates, (k,) neighbor
    counts), largest-vote first.

    ``roi`` (xyxy, original coords) restricts the scan to a sub-window at
    the SAME detection scale the full-frame pass would use, and
    ``min_size_px``/``max_size_px`` (original pixel units) prune pyramid
    levels — together the temporal-tracking fast path for video, where the
    largest pyramid levels (smallest faces) dominate cost. Box coordinates
    are always returned in original full-frame coords.
    """
    cascade = cascade or get_default_cascade()
    if cascade is None:
        return np.zeros((0, 4)), np.zeros((0,), np.int64)
    max_side = int(os.environ.get("HAAR_MAX_SIDE", "") or max_side)
    H, W = frame_rgb.shape[0], frame_rgb.shape[1]
    # detection scale ALWAYS derives from the full frame so an roi pass
    # sees the identical pyramid granularity as a full-frame pass
    scale = max(1.0, max(H, W) / float(max_side))
    rx0 = ry0 = 0
    if roi is not None:
        rx0 = max(0, min(W - 1, int(math.floor(roi[0]))))
        ry0 = max(0, min(H - 1, int(math.floor(roi[1]))))
        rx1 = max(rx0 + 1, min(W, int(math.ceil(roi[2]))))
        ry1 = max(ry0 + 1, min(H, int(math.ceil(roi[3]))))
        frame_rgb = frame_rgb[ry0:ry1, rx0:rx1]
    h, w = frame_rgb.shape[0], frame_rgb.shape[1]
    oh, ow = max(1, int(round(h / scale))), max(1, int(round(w / scale)))
    gray = None
    if scale > 1.0:
        try:  # fused gray+downscale in C (GIL-free, ~3x the numpy path)
            from deepfake_video_detection_tpu_torch.data import haar_native
            gray = haar_native.prepare_gray(
                np.ascontiguousarray(frame_rgb[..., :3]), oh, ow)
        except Exception:
            gray = None
    if gray is None:
        gray = rgb_to_gray(frame_rgb)
        if scale > 1.0:
            gray = _resize_bilinear(gray, oh, ow)
    min_size = 24 if min_size_px is None else max(24, int(min_size_px / scale))
    max_size = None if max_size_px is None else max(
        float(cascade.win_w), max_size_px / scale)
    boxes, counts = cascade.detect(gray, min_neighbors=min_neighbors,
                                   min_size=min_size, max_size=max_size)
    if len(boxes) == 0:
        return np.zeros((0, 4)), counts
    xyxy = np.stack([boxes[:, 0], boxes[:, 1],
                     boxes[:, 0] + boxes[:, 2],
                     boxes[:, 1] + boxes[:, 3]], 1) * scale
    xyxy += np.array([rx0, ry0, rx0, ry0], np.float64)
    return xyxy, counts
