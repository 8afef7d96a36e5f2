"""Train and evaluate directly from raw videos, with no ``.npz`` prep stage.

Counterpart of ``deepfake_video_detection_tpu/data/video_dataset.py``:
``VideoClipsDataset`` presents ``VideoFacesDataset``'s interface
(``(faces (T, H, W, 3) uint8, label, path)`` items, ``label``,
``labels()``, ``files``, ``split``) over a directory of video files, so the
trainers, the evaluator, the splitter and the weighted sampler take it
unchanged. Decoding and face extraction run in the ``Loader``'s worker
threads, the crops resized (and the mtcnn cascade run) on ``device``.
Labels resolve without decoding: a labels CSV or path tokens, the prep
CLI's rules (``data/prepare.py``).

A clip that fails to decode becomes a zero-filled clip and prints one
warning for the whole dataset (later failures are silent), as in the JAX
package: one bad clip does not end an epoch. ``cache_clips`` keeps each
clip's faces in host memory across epochs and never keeps a failure.
"""

from __future__ import annotations

import glob as _glob
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from deepfake_video_detection_tpu_torch.data.dataset import pad_or_sample_frames, random_split
from deepfake_video_detection_tpu_torch.data.faces import FaceExtractor
from deepfake_video_detection_tpu_torch.data.prepare import load_labels_csv, resolve_label

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".mpg", ".mpeg", ".m4v", ".wmv")


class VideoClipsDataset:
    """``VideoFacesDataset``-compatible view over a directory of raw videos."""

    def __init__(self, data_dir: str, num_frames: int = 16, face_size: int = 224,
                 detector: str = "center", labels_csv: Optional[str] = None,
                 recursive: bool = False, max_samples: Optional[int] = None,
                 cache_clips: bool = False, device: Any = "cuda"):
        pattern = (os.path.join(data_dir, "**", "*") if recursive
                   else os.path.join(data_dir, "*"))
        labels = load_labels_csv(labels_csv) if labels_csv else None
        self.files: List[str] = []
        self._labels: Dict[int, int] = {}
        for path in sorted(_glob.glob(pattern, recursive=recursive)):
            if not path.lower().endswith(VIDEO_EXTS):
                continue
            label = resolve_label(path, labels)
            if label is None:   # unlabelled clips are skipped, as the prep CLI does
                continue
            self._labels[len(self.files)] = int(label)
            self.files.append(path)
        if max_samples is not None:
            self.files = self.files[:max_samples]
            self._labels = {i: self._labels[i] for i in range(len(self.files))}
        if not self.files:
            raise FileNotFoundError(f"no labeled video files under {data_dir}")
        self.num_frames = num_frames
        self.extractor = FaceExtractor(detector=detector, face_size=face_size, device=device)
        self._warned = False
        # decode each clip once and reuse it across epochs
        # (~T·face_size²·3 bytes a clip; the caller sizes the corpus)
        self._cache: Optional[Dict[int, np.ndarray]] = {} if cache_clips else None

    def __len__(self) -> int:
        return len(self.files)

    def label(self, i: int) -> int:
        return self._labels[i]

    def labels(self) -> np.ndarray:
        return np.asarray([self._labels[i] for i in range(len(self.files))], np.int64)

    def split(self, val_fraction: float = 0.2, seed: int = 42):
        """Deterministic random split, as ``VideoFacesDataset.split``."""
        return random_split(self, val_fraction, seed)

    def __getitem__(self, i: int):
        path = self.files[i]
        if self._cache is not None and i in self._cache:
            return self._cache[i], self._labels[i], path
        size = self.extractor.face_size
        failed = False
        try:
            faces = self.extractor.extract_from_video(path, max_frames=self.num_frames)
        except Exception as e:
            # zero frames give one sample a near-constant gradient, and the
            # first failure is printed
            if not self._warned:
                print(f"[video_dataset] decode failed for {path}: {e} "
                      f"(zero-filling; further failures suppressed)", file=sys.stderr)
                self._warned = True
            faces = np.zeros((0, size, size, 3), np.uint8)
            failed = True
        if faces.shape[0] == 0:
            faces = np.zeros((1, size, size, 3), np.uint8)
        faces = pad_or_sample_frames(faces.astype(np.uint8), self.num_frames)
        if self._cache is not None and not failed:
            # a failure's zero-fill is not cached: the clip is retried next epoch
            self._cache[i] = faces
        return faces, self._labels[i], path
