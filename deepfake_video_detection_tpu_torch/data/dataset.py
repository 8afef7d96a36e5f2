"""Dataset over per-video ``.npz`` face stacks.

Copy (numpy only) of ``deepfake_video_detection_tpu/data/dataset.py``: globs
``*.npz`` (optionally recursive), each file holding ``faces: (N, H, W, 3)
uint8`` and ``label: int64``; the label falls back to filename tokens
(``fake``/``real``). Items are raw uint8 stacks padded or sampled to a fixed
T; augmentation runs batched on the device (``data/augment.py``).
"""

from __future__ import annotations

import os
import glob as _glob
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def infer_label(path: str) -> Optional[int]:
    """Label from path tokens: 'fake'→1, 'real'→0 (≙ ``src/dataset.py:43``)."""
    name = os.path.basename(path).lower()
    parts = set(name.replace("-", "_").replace(".", "_").split("_"))
    if "fake" in parts or "df" in parts:
        return 1
    if "real" in parts or "original" in parts:
        return 0
    low = path.lower()
    if "fake" in low:
        return 1
    if "real" in low or "original" in low:
        return 0
    return None


def pad_or_sample_frames(faces: np.ndarray, num_frames: int) -> np.ndarray:
    """(N, H, W, 3) → (num_frames, H, W, 3): repeat-last pad or uniform
    subsample (≙ collate logic, ``src/train.py:43-58``)."""
    n = faces.shape[0]
    if n == num_frames:
        return faces
    if n > num_frames:
        idx = np.linspace(0, n - 1, num_frames).round().astype(np.int64)
        return faces[idx]
    pad = np.repeat(faces[-1:], num_frames - n, axis=0)
    return np.concatenate([faces, pad], axis=0)


class VideoFacesDataset:
    """Indexable dataset of ``(faces uint8 (T,H,W,3), label int, path)``."""

    def __init__(
        self,
        data_dir: str,
        num_frames: int = 16,
        recursive: bool = False,
        max_samples: Optional[int] = None,
    ):
        pattern = os.path.join(data_dir, "**", "*.npz") if recursive \
            else os.path.join(data_dir, "*.npz")
        candidates = sorted(_glob.glob(pattern, recursive=recursive))
        # keep only real face stacks — checkpoints and other .npz artifacts
        # may share the directory (zip-directory read only; no decompression)
        self.files: List[str] = []
        for path in candidates:
            try:
                with np.load(path, allow_pickle=False) as z:
                    if "faces" in z.files:
                        self.files.append(path)
            except Exception:  # torn/garbage npz raise BadZipFile/EOFError/…
                continue
        if max_samples is not None:
            self.files = self.files[:max_samples]
        if not self.files:
            raise FileNotFoundError(f"no face-stack .npz files under {data_dir}")
        self.num_frames = num_frames
        self._labels: Dict[int, int] = {}

    def __len__(self) -> int:
        return len(self.files)

    def label(self, i: int) -> int:
        """Label without decoding the face stack (the ``label`` member is a
        scalar — np.load only decompresses that one zip entry). Precedence is
        stored-label-first, identical to ``__getitem__``, so class weights and
        the weighted sampler always agree with the training targets."""
        if i not in self._labels:
            with np.load(self.files[i]) as z:
                lab = int(z["label"]) if "label" in z.files else None
            if lab is None:
                lab = infer_label(self.files[i]) or 0
            self._labels[i] = int(lab)
        return self._labels[i]

    def labels(self) -> np.ndarray:
        return np.asarray([self.label(i) for i in range(len(self))], np.int64)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int, str]:
        path = self.files[i]
        with np.load(path) as z:
            faces = z["faces"]
            lab = int(z["label"]) if "label" in z.files else None
        if lab is None:
            lab = infer_label(path) or 0
        self._labels[i] = lab
        if faces.ndim == 3:  # single frame stored unbatched
            faces = faces[None]
        faces = pad_or_sample_frames(np.asarray(faces, np.uint8), self.num_frames)
        return faces, lab, path

    def split(self, val_fraction: float = 0.2, seed: int = 42
              ) -> Tuple["SubsetDataset", "SubsetDataset"]:
        """Deterministic random 80/20 split (≙ ``src/train.py:287``)."""
        return random_split(self, val_fraction, seed)


def random_split(ds, val_fraction: float = 0.2, seed: int = 42):
    """Deterministic (train, val) ``SubsetDataset`` pair over any dataset
    with the ``(faces, label, path)`` item interface — shared by the npz
    and direct-from-video datasets."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds))
    n_val = max(1, int(len(ds) * val_fraction)) if len(ds) > 1 else 0
    return (SubsetDataset(ds, idx[n_val:].tolist()),
            SubsetDataset(ds, idx[:n_val].tolist()))


class SubsetDataset:
    def __init__(self, base: VideoFacesDataset, indices: Sequence[int]):
        self.base = base
        self.indices = list(indices)
        self.num_frames = base.num_frames

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.base[self.indices[i]]

    def label(self, i: int) -> int:
        return self.base.label(self.indices[i])

    def labels(self) -> np.ndarray:
        return np.asarray([self.label(i) for i in range(len(self))], np.int64)

    @property
    def files(self):
        return [self.base.files[i] for i in self.indices]
