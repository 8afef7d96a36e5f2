"""Batching loader with weighted sampling, and device prefetch.

Counterpart of ``deepfake_video_detection_tpu/data/loader.py``.
:class:`Loader` is a copy (numpy only): fixed batch size, the last partial
batch padded by repeating its first sample and masked in ``valid``,
per-epoch shuffling or inverse-frequency sampling from
``rng(seed + epoch)``, and item IO fanned out over a thread pool. Under a
mesh every rank draws the same order and ``shard=(index, count)`` makes
it load and yield only its rows of each batch (padded to
``pad_to_multiple``, which ``count`` divides), as JAX's ``shard_batch``
hands each device its rows of the global batch.
:func:`prefetch_to_device` keeps ``size`` batches in flight to the card:
each batch is copied into pinned host memory and sent with a
``non_blocking`` copy (:func:`batch_to_device`), so the transfer overlaps
the previous step.

Spans and counters (``utils/profiling.py``), while something records:
``loader.wait``, the consumer blocked on a batch's item loads (``ready``:
whether every load was done when it asked), with the counters
``loader.asked`` and ``loader.ready``; ``loader.stack``, the batch's
``np.stack``; ``loader.pin``, :func:`batch_to_device`'s pin and copy
enqueue.
"""

from __future__ import annotations

import collections
import concurrent.futures as _fut
from typing import Any, Dict, Iterator

import numpy as np

from deepfake_video_detection_tpu_torch.utils import profiling


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
        shard: tuple = (0, 1),
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.weighted = weighted
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.pad_to_multiple = max(1, pad_to_multiple)
        self.shard = tuple(shard)
        if self.pad_to_multiple % self.shard[1]:
            raise ValueError(f"{self.shard[1]} shards do not divide the batch "
                             f"multiple {self.pad_to_multiple}")
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
        """This shard's rows of every batch (all of them at ``shard=(0, 1)``),
        padded to ``pad_to_multiple``: rows past the batch's items repeat its
        first item with ``valid`` False. Items of the next two batches load
        while a batch is consumed."""
        idx = self._epoch_indices()
        self.epoch += 1
        bs, (me, count) = self.batch_size, self.shard
        n_batches = len(idx) // bs if self.drop_last else -(-len(idx) // bs)
        plans = []
        for b in range(n_batches):
            chunk = idx[b * bs:(b + 1) * bs]
            target = -(-len(chunk) // self.pad_to_multiple) * self.pad_to_multiple
            rows = range(me * target // count, (me + 1) * target // count)
            plans.append([(int(chunk[r] if r < len(chunk) else chunk[0]), r < len(chunk))
                          for r in rows])

        def submit(pool, plan):
            # the padding rows, all the batch's first item, share one load
            # (shard 0's own first row)
            futures, pad = [], None
            for i, real in plan:
                if real:
                    futures.append(pool.submit(self.ds.__getitem__, i))
                else:
                    pad = pad or (futures[0] if me == 0 else
                                  pool.submit(self.ds.__getitem__, i))
                    futures.append(pad)
            return futures

        with _fut.ThreadPoolExecutor(self.num_workers) as pool:
            pending = collections.deque(submit(pool, p) for p in plans[:2])
            for b, p in enumerate(plans):
                if b + 2 < len(plans):
                    pending.append(submit(pool, plans[b + 2]))
                futures = pending.popleft()
                with profiling.annotate("loader.wait") as span:
                    if span:
                        ready = all(f.done() for f in futures)
                        span.set(ready=ready)
                        profiling.count("loader.asked")
                        profiling.count("loader.ready", int(ready))
                    items = [f.result() for f in futures]
                with profiling.annotate("loader.stack"):
                    frames = np.stack([it[0] for it in items])        # (B,T,H,W,3) uint8
                yield {
                    "frames": frames,
                    "labels": np.asarray([it[1] for it in items], np.int64),
                    "valid": np.asarray([v for _, v in p], bool),
                    "paths": [it[2] for it in items],
                }


def batch_to_device(batch: Dict[str, Any], device: Any) -> Dict[str, Any]:
    """A host batch's numpy arrays as tensors on ``device``, through pinned
    memory and ``non_blocking`` copies when it is a CUDA device; other
    entries are dropped."""
    import torch

    device = torch.device(device)
    dev = {}
    with profiling.annotate("loader.pin"):
        for k, v in batch.items():
            if not isinstance(v, np.ndarray):
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.to(device)
            dev[k] = t
    return dev


def prefetch_to_device(iterator, device: Any = "cuda", size: int = 2,
                       transform=None):
    """Wrap a host batch iterator with a ``size``-deep device prefetch queue.

    Each batch goes to ``device`` by :func:`batch_to_device`; ``paths``
    stays a host list. ``transform(batch)`` runs right after the transfer
    is queued, on the consumer thread."""
    queue: collections.deque = collections.deque()

    def put(batch):
        paths = batch.pop("paths", None)
        dev = batch_to_device(batch, device)
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
