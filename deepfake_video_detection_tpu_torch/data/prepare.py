"""Dataset preparation CLI: videos or frames → one ``.npz`` face stack each.

Counterpart of ``deepfake_video_detection_tpu/data/prepare.py`` (the
reference's ``src/data_prepare.py``): scans a directory or an archive (zip
or tar) and writes ``<stem>_<fake|real>.npz`` holding ``faces`` (N, size,
size, 3) uint8 and ``label``, for three layouts:

1. raw videos, decoded and face-extracted clip by clip on a thread pool;
   with ``--detector mtcnn`` a batch of ``--batch-clips`` clips is decoded
   on the pool and one cascade runs over all their frames on ``--device``;
2. DFDC-style flat frames ``<vid>_<frame>_<idx>.png``, grouped by video id;
3. one folder of frames per sample.

Labels come from ``--labels_csv`` or from path tokens. A clip that fails
to decode is skipped with a ``[prepare] skipping`` line; the run goes on.

    python -m deepfake_video_detection_tpu_torch.data.prepare --data_dir clips/ \\
        --out_dir faces/ --detector mtcnn

The haar detector's default (seek) path crops inside the native decoder, so
it needs libav; where only cv2 decodes (``VIDEO_BACKEND=cv2``), pass
``--no-seek-sampling``. Crops are resized on ``--device`` (the card by
default); the packed-YUV crops of the seek path convert to RGB on the host.
"""

from __future__ import annotations

import argparse
import concurrent.futures as _fut
import csv
import os
import re
import tarfile
import zipfile
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from deepfake_video_detection_tpu_torch.data.dataset import infer_label
from deepfake_video_detection_tpu_torch.data.faces import FaceExtractor, crop_and_resize_batch
from deepfake_video_detection_tpu_torch.data.video import sample_video_frames

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v")
IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp")

_FLAT_RE = re.compile(r"^(?P<vid>.+?)_(?P<frame>\d+)_(?P<idx>\d+)\.(png|jpg|jpeg)$",
                      re.IGNORECASE)


def load_labels_csv(path: str) -> Dict[str, int]:
    """A CSV of (filename, label) rows, the label fake/real, 1/0, df/original;
    keyed by the file's stem. A header row is skipped."""
    labels: Dict[str, int] = {}
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, None)
        rows = [header] if header and not _looks_like_header(header) else []
        rows += list(reader)
    for row in rows:
        if not row or len(row) < 2:
            continue
        name = os.path.splitext(os.path.basename(row[0].strip()))[0]
        tok = row[1].strip().lower()
        if tok in ("fake", "1", "df"):
            labels[name] = 1
        elif tok in ("real", "0", "original"):
            labels[name] = 0
    return labels


def _looks_like_header(row: List[str]) -> bool:
    joined = ",".join(row).lower()
    return "label" in joined or "filename" in joined or "video" in joined


def resolve_label(path: str, labels: Optional[Dict[str, int]]) -> Optional[int]:
    """The CSV's label for the stem (or its part before the first ``_``),
    else the path's tokens."""
    stem = os.path.splitext(os.path.basename(path))[0]
    if labels:
        if stem in labels:
            return labels[stem]
        base = stem.split("_")[0]
        if base in labels:
            return labels[base]
    return infer_label(path)


def parse_flat_frames_key(name: str) -> Optional[Tuple[str, int, int]]:
    """``<vid>_<frame>_<idx>.png`` → (vid, frame, idx)."""
    m = _FLAT_RE.match(name)
    if not m:
        return None
    return m.group("vid"), int(m.group("frame")), int(m.group("idx"))


def is_flat_frames_layout(files: List[str], threshold: float = 0.8) -> bool:
    """Whether at least ``threshold`` of the images are named as flat frames."""
    imgs = [f for f in files if f.lower().endswith(IMAGE_EXTS)]
    if not imgs:
        return False
    hits = sum(1 for f in imgs if parse_flat_frames_key(os.path.basename(f)))
    return hits / len(imgs) >= threshold


def extract_archive(path: str, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            z.extractall(out_dir)
    elif tarfile.is_tarfile(path):
        with tarfile.open(path) as t:
            t.extractall(out_dir)
    else:
        raise ValueError(f"unsupported archive: {path}")
    return out_dir


def _load_image(path: str) -> Optional[np.ndarray]:
    try:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), np.uint8)
    except Exception:
        return None


def _save_npz(out_dir: str, name: str, faces: np.ndarray, label: int) -> str:
    out = os.path.join(out_dir, f"{name}.npz")
    np.savez_compressed(out, faces=faces.astype(np.uint8), label=np.int64(label))
    return out


def _packed_yuv_to_rgb_u8(packed: np.ndarray, size: int) -> np.ndarray:
    """(N, size²·3/2) packed YUV420 → (N, size, size, 3) uint8 RGB on the
    host, by the BT.601 limited-range matrix of ``ops/yuv.py``: prep writes
    uint8 files, so the pixels need not cross to the card."""
    hw, qw = size * size, (size // 2) * (size // 2)
    y = packed[:, :hw].reshape(-1, size, size).astype(np.float32)
    u = packed[:, hw:hw + qw].reshape(-1, size // 2, size // 2)
    v = packed[:, hw + qw:].reshape(-1, size // 2, size // 2)
    u = np.repeat(np.repeat(u, 2, axis=1), 2, axis=2).astype(np.float32) - 128.0
    v = np.repeat(np.repeat(v, 2, axis=1), 2, axis=2).astype(np.float32) - 128.0
    c = 1.164383 * (y - 16.0)
    rgb = np.stack([c + 1.596027 * v,
                    c - 0.391762 * u - 0.812968 * v,
                    c + 2.017232 * u], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def _sample_name(stem: str, label: int) -> str:
    return f"{stem}_{'fake' if label else 'real'}"


def prepare_video(path: str, out_dir: str, extractor: FaceExtractor,
                  labels: Optional[Dict[str, int]], sample_rate: int,
                  max_frames: int, seek_sampling: bool = True) -> Optional[str]:
    """One clip → its ``.npz``, or None when it has no label or no face.
    The haar detector (single face, ``seek_sampling``) takes the native
    decoder's seek path: ``max_frames`` samples spread over the whole clip,
    detected and cropped in one call; otherwise every ``sample_rate``-th
    frame of the head of the clip is decoded and extracted."""
    label = resolve_label(path, labels)
    if label is None:
        return None
    if extractor.detector == "haar" and seek_sampling and not extractor.keep_all:
        packed = extractor.extract_from_video_yuv(path, max_frames=max_frames)
        if packed.shape[0] == 0:
            return None
        faces = _packed_yuv_to_rgb_u8(packed, extractor.face_size)
    else:
        frames = sample_video_frames(path, sample_rate=sample_rate, max_frames=max_frames)
        faces = extractor.extract_from_frames(frames)
    if faces.shape[0] == 0:
        return None
    stem = os.path.splitext(os.path.basename(path))[0]
    return _save_npz(out_dir, _sample_name(stem, label), faces, label)


def prepare_frames_group(name: str, image_paths: List[str], out_dir: str,
                         extractor: Optional[FaceExtractor],
                         labels: Optional[Dict[str, int]], max_frames: int,
                         label_hint_path: str, device: Any = "cuda") -> Optional[str]:
    """The first ``max_frames`` images of one sample (sorted, those of the
    first image's size) → its ``.npz``; without an extractor
    (``--frames-are-faces``) each image is resized whole to 224 px."""
    label = resolve_label(label_hint_path, labels)
    if label is None:
        label = resolve_label(name, labels)
    if label is None:
        return None
    imgs = []
    for p in sorted(image_paths)[:max_frames]:
        arr = _load_image(p)
        if arr is not None:
            imgs.append(arr)
    if not imgs:
        return None
    shape0 = imgs[0].shape
    frames = np.stack([im for im in imgs if im.shape == shape0])
    if extractor is not None:
        faces = extractor.extract_from_frames(frames)
    else:
        n, H, W = frames.shape[0], frames.shape[1], frames.shape[2]
        boxes = np.tile(np.array([0, 0, W, H], np.float32), (n, 1))
        faces = crop_and_resize_batch(frames, boxes, 224, device)
    if faces.shape[0] == 0:
        return None
    return _save_npz(out_dir, _sample_name(name, label), faces, label)


def _prepare_mtcnn_batches(videos: List[str], args, ext: FaceExtractor,
                           labels: Optional[Dict[str, int]]) -> List[str]:
    """Layout 1 with mtcnn: each batch of ``--batch-clips`` labelled clips is
    decoded on the thread pool, one cascade runs over all their frames
    (``extract_from_frames_batch``), then each clip is saved."""
    written: List[str] = []
    bs = max(1, args.batch_clips)
    with _fut.ThreadPoolExecutor(args.workers) as pool:
        for start in range(0, len(videos), bs):
            futs = [(v, pool.submit(sample_video_frames, v, args.sample_rate,
                                    args.max_frames))
                    for v in videos[start:start + bs] if resolve_label(v, labels) is not None]
            decoded = []
            for v, f in futs:
                try:
                    decoded.append((v, f.result()))
                except Exception as e:
                    print(f"[prepare] skipping {v}: {e}")
            if not decoded:
                continue
            faces_list = ext.extract_from_frames_batch([fr for _, fr in decoded])
            for (v, _), faces in zip(decoded, faces_list):
                if faces.shape[0] == 0:
                    continue
                label = resolve_label(v, labels)
                stem = os.path.splitext(os.path.basename(v))[0]
                written.append(_save_npz(args.out_dir, _sample_name(stem, label), faces,
                                         label))
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Prepare .npz face stacks from videos/frames")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--archive", help="zip/tar of videos or frames")
    src.add_argument("--data_dir", help="directory of videos or frames")
    ap.add_argument("--out_dir", default="data/faces")
    ap.add_argument("--sample_rate", type=int, default=5)
    ap.add_argument("--max_frames", type=int, default=32)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--max_videos", type=int, default=None)
    ap.add_argument("--max_files", type=int, default=None)
    ap.add_argument("--frames-are-faces", dest="frames_are_faces", action="store_true")
    ap.add_argument("--labels_csv", default=None)
    ap.add_argument("--detector", default=None,
                    help="auto|mtcnn|haar|center|none (default: auto — "
                         "mtcnn if MTCNN_WEIGHTS else haar else center)")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 4)
    ap.add_argument("--batch-clips", dest="batch_clips", type=int, default=16,
                    help="clips a cascade for --detector mtcnn (one cascade "
                         "over all their frames)")
    ap.add_argument("--no-seek-sampling", dest="seek_sampling", action="store_false",
                    help="haar raw-video prep: scan every sample_rate-th frame "
                         "instead of the native decoder's seek path")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the crops and the cascade (the card by default)")
    args = ap.parse_args(argv)

    root = args.data_dir
    if args.archive:
        root = extract_archive(args.archive, os.path.join(args.out_dir, "_extracted"))
    os.makedirs(args.out_dir, exist_ok=True)
    labels = load_labels_csv(args.labels_csv) if args.labels_csv else None
    extractor = None if args.frames_are_faces else FaceExtractor(
        detector=args.detector, face_size=args.size, device=args.device)

    all_files: List[str] = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            all_files.append(os.path.join(dirpath, f))
    if args.max_files:
        all_files = all_files[: args.max_files]

    videos = [f for f in all_files if f.lower().endswith(VIDEO_EXTS)]
    images = [f for f in all_files if f.lower().endswith(IMAGE_EXTS)]
    written: List[str] = []

    if videos:  # layout 1: raw videos
        if args.max_videos:
            videos = videos[: args.max_videos]
        ext = extractor or FaceExtractor(detector="none", face_size=args.size,
                                         device=args.device)
        if ext.detector == "mtcnn":
            written = _prepare_mtcnn_batches(videos, args, ext, labels)
        else:
            with _fut.ThreadPoolExecutor(args.workers) as pool:
                futs = [(v, pool.submit(prepare_video, v, args.out_dir, ext, labels,
                                        args.sample_rate, args.max_frames,
                                        args.seek_sampling))
                        for v in videos]
                for v, f in futs:
                    # a corrupt clip does not end the run
                    try:
                        out = f.result()
                    except Exception as e:
                        print(f"[prepare] skipping {v}: {e}")
                        continue
                    if out:
                        written.append(out)
    elif is_flat_frames_layout([os.path.basename(f) for f in images]):
        # layout 2: DFDC flat frames, grouped by video id
        groups: Dict[str, List[str]] = defaultdict(list)
        for p in images:
            parsed = parse_flat_frames_key(os.path.basename(p))
            if parsed:
                groups[parsed[0]].append(p)
        items = sorted(groups.items())
        if args.max_videos:
            items = items[: args.max_videos]
        for name, paths in items:
            out = prepare_frames_group(name, paths, args.out_dir, extractor, labels,
                                       args.max_frames, paths[0], args.device)
            if out:
                written.append(out)
    else:
        # layout 3: one folder of frames per sample
        folders: Dict[str, List[str]] = defaultdict(list)
        for p in images:
            folders[os.path.dirname(p)].append(p)
        items = sorted(folders.items())
        if args.max_videos:
            items = items[: args.max_videos]
        for folder, paths in items:
            name = os.path.basename(folder.rstrip(os.sep)) or "sample"
            out = prepare_frames_group(name, paths, args.out_dir, extractor, labels,
                                       args.max_frames, folder, args.device)
            if out:
                written.append(out)

    print(f"wrote {len(written)} samples to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
