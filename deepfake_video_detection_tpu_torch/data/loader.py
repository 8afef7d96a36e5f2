"""Batching loader with weighted sampling, and device prefetch.

Counterpart of ``deepfake_video_detection_tpu/data/loader.py``.
:class:`Loader` is a copy (numpy only): fixed batch size, the last partial
batch padded by repeating its first sample and masked in ``valid``,
per-epoch shuffling or inverse-frequency sampling from
``rng(seed + epoch)``, and item IO fanned out over a thread pool.
:func:`prefetch_to_device` keeps ``size`` batches in flight to the card:
each batch is copied into pinned host memory and sent with a
``non_blocking`` copy, so the transfer overlaps the previous step.
"""

from __future__ import annotations

import collections
import concurrent.futures as _fut
from typing import Any, Dict, Iterator

import numpy as np


class Loader:
    def __init__(
        self,
        dataset: Any,
        batch_size: int = 8,
        shuffle: bool = False,
        weighted: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        num_workers: int = 4,
        pad_to_multiple: int = 1,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.weighted = weighted
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.pad_to_multiple = max(1, pad_to_multiple)
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.ds)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.ds)
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.weighted:
            labels = self.ds.labels()
            counts = np.bincount(labels, minlength=2).astype(np.float64)
            counts = np.maximum(counts, 1.0)
            w = 1.0 / counts[labels]
            return rng.choice(n, size=n, replace=True, p=w / w.sum())
        if self.shuffle:
            return rng.permutation(n)
        return np.arange(n)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._epoch_indices()
        self.epoch += 1
        bs = self.batch_size
        with _fut.ThreadPoolExecutor(self.num_workers) as pool:
            # submit a sliding window of item futures so IO overlaps compute
            window = max(2 * bs, 16)
            futures = collections.deque()
            pos = 0

            def fill():
                nonlocal pos
                while pos < len(idx) and len(futures) < window:
                    futures.append(pool.submit(self.ds.__getitem__, int(idx[pos])))
                    pos += 1

            fill()
            batch_faces, batch_labels, batch_paths = [], [], []
            while futures:
                faces, lab, path = futures.popleft().result()
                fill()
                batch_faces.append(faces)
                batch_labels.append(lab)
                batch_paths.append(path)
                if len(batch_faces) == bs:
                    yield self._make_batch(batch_faces, batch_labels, batch_paths)
                    batch_faces, batch_labels, batch_paths = [], [], []
            if batch_faces and not self.drop_last:
                yield self._make_batch(batch_faces, batch_labels, batch_paths)

    def _make_batch(self, faces, labels, paths) -> Dict[str, np.ndarray]:
        n = len(faces)
        target = -(-n // self.pad_to_multiple) * self.pad_to_multiple
        valid = np.zeros((target,), bool)
        valid[:n] = True
        while len(faces) < target:  # pad by repeating the first sample
            faces.append(faces[0])
            labels.append(labels[0])
            paths.append(paths[0])
        return {
            "frames": np.stack(faces),                       # (B,T,H,W,3) uint8
            "labels": np.asarray(labels, np.int64),
            "valid": valid,
            "paths": paths,
        }


def prefetch_to_device(iterator, device: Any = "cuda", size: int = 2,
                       transform=None):
    """Wrap a host batch iterator with a ``size``-deep device prefetch queue.

    Each batch's numpy arrays become tensors on ``device`` (through pinned
    memory and ``non_blocking`` copies when it is a CUDA device);
    ``paths`` stays a host list and other entries are dropped.
    ``transform(batch)`` runs right after the transfer is queued, on the
    consumer thread."""
    import torch

    device = torch.device(device)
    queue: collections.deque = collections.deque()

    def put(batch):
        paths = batch.pop("paths", None)
        dev = {}
        for k, v in batch.items():
            if not isinstance(v, np.ndarray):
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.to(device)
            dev[k] = t
        if transform is not None:
            dev = transform(dev)
        if paths is not None:
            dev = dict(dev, paths=paths)
        queue.append(dev)

    it = iter(iterator)
    try:
        for _ in range(size):
            put(next(it))
    except StopIteration:
        pass
    while queue:
        out = queue.popleft()
        try:
            put(next(it))
        except StopIteration:
            pass
        yield out
