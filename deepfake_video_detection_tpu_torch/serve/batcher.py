"""Dynamic request micro-batching for serving.

Counterpart of ``deepfake_video_detection_tpu/serve/batcher.py``.
``MicroBatcher`` coalesces concurrent single-item calls into one batched
call:

* callers block in :meth:`call` until their slice of the batched output is
  ready;
* items are grouped by ``(fn, shape, dtype)`` so only same-function,
  same-shape work coalesces;
* a batch launches when ``max_batch`` items are waiting or the oldest item
  has waited ``max_wait_s``;
* batches are padded up to a power-of-two bucket by repeating the last item,
  so the device sees a handful of batch shapes (each warmed at start-up);
  with ``bucket_multiple`` > 1 (serving data parallelism) every bucket is a
  multiple of it, so a batch splits evenly over the replicas.

Items are host arrays, stacked once on the host so one batch is one
host→device copy. ``fn`` may return tensors on any device: each output is
brought to the host once per batch (bf16 as f32) and sliced there.

Spans (``utils/profiling.py``), while something records: ``batch.collect``,
the batcher thread's wait for a ready group; ``batch.step``, a group's run
(``n`` items, bucket ``b``, the items still ``pending`` after the take, the
``requests`` served: each caller's innermost span, its ``serve.request``),
over ``batch.stack`` and ``batch.to_host``; and ``batch.queue_wait``, an
item's wait from its enqueue to the take of its group, written on the
batcher thread with the caller's span as its parent.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepfake_video_detection_tpu_torch.utils import profiling


def _bucket(n: int, max_batch: int, multiple: int = 1) -> int:
    """Smallest ``multiple * 2^k`` ≥ n, capped at ``max_batch``."""
    b = max(1, multiple)
    while b < n:
        b *= 2
    return min(b, max_batch)


def to_host(x: Any) -> Optional[np.ndarray]:
    """One output → a host numpy array (None passes through)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.cpu().numpy()
    return np.asarray(x)


class _Entry:
    __slots__ = ("item", "event", "result", "error", "request", "enqueued")

    def __init__(self, item: np.ndarray):
        self.item = item
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        # the caller's span and the enqueue time, kept while tracing
        self.request: Optional[int] = None
        self.enqueued: Optional[int] = None


class MicroBatcher:
    """Coalesce concurrent single-item calls into batched device steps.

    ``call(fn, item, out_axes)`` stacks ``item`` with other pending items of
    the same ``fn``/shape/dtype along a new leading axis, invokes
    ``fn(stacked)`` once, and returns this item's slice of each output as a
    host array. ``out_axes`` has one element per output of ``fn``: the batch
    axis of that output, or ``None`` if the output may be ``None`` / is
    passed through unsliced.
    """

    def __init__(self, max_batch: int = 16, max_wait_s: float = 0.004,
                 bucket_multiple: int = 1):
        self.bucket_multiple = max(1, int(bucket_multiple))
        # the cap stays a multiple of bucket_multiple, so a full batch still
        # splits evenly
        max_batch = max(1, int(max_batch))
        if self.bucket_multiple > 1:
            max_batch = max(self.bucket_multiple,
                            (max_batch // self.bucket_multiple) * self.bucket_multiple)
        self.max_batch = max_batch
        self.max_wait_s = float(max_wait_s)
        self._cond = threading.Condition()
        # key -> [fn, out_axes, first_arrival_ts, [entries]]
        self._pending: Dict[Tuple, List] = {}
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        # visible for tests / metrics
        self.batches_run = 0
        self.items_run = 0

    # ------------------------------------------------------------------

    def call(self, fn: Callable[[Any], Tuple], item: Any,
             out_axes: Sequence[Optional[int]]) -> Tuple:
        entry = _Entry(item)
        if profiling.enabled():
            entry.request, entry.enqueued = profiling.current(), time.perf_counter_ns()
        key = (id(fn), tuple(np.shape(item)), str(np.asarray(item).dtype),
               tuple(out_axes))
        with self._cond:
            closed = self._closed
            if not closed:
                if key not in self._pending:
                    self._pending[key] = [fn, tuple(out_axes),
                                          time.monotonic(), [entry]]
                else:
                    self._pending[key][3].append(entry)
                if self._worker is None or not self._worker.is_alive():
                    self._worker = threading.Thread(target=self._run,
                                                    name="microbatcher",
                                                    daemon=True)
                    self._worker.start()
                self._cond.notify_all()
        if closed:
            # a shutting-down batcher still serves in-flight callers: run
            # the item as its own batch
            return self._call_direct(fn, item, tuple(out_axes))
        entry.event.wait()
        if entry.error is not None:
            raise entry.error
        return entry.result

    def _call_direct(self, fn, item, out_axes):
        outputs = fn(np.stack([np.asarray(item)] * self.bucket_multiple))
        if not isinstance(outputs, tuple):
            outputs = (outputs,)
        outputs = tuple(to_host(o) for o in outputs)
        return tuple(
            None if out is None else (out if ax is None else _slice(out, ax, 0))
            for out, ax in zip(outputs, out_axes))

    def bucket_sizes(self) -> List[int]:
        """Every distinct padded batch size ``_execute`` can produce — the
        single source of truth for warmup."""
        return sorted({_bucket(n, self.max_batch, self.bucket_multiple)
                       for n in range(1, self.max_batch + 1)})

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # ------------------------------------------------------------------

    def _run(self) -> None:
        while True:
            entries: List[_Entry] = []
            try:
                with profiling.annotate("batch.collect"), self._cond:
                    batch = self._take_ready_locked()
                    while batch is None:
                        if self._closed and not self._pending:
                            return
                        self._cond.wait(timeout=self._next_deadline_locked())
                        batch = self._take_ready_locked()
                    fn, out_axes, entries = batch
                    pending = (sum(len(v[3]) for v in self._pending.values())
                               if profiling.enabled() else None)
                self._execute(fn, out_axes, entries, pending)
            except BaseException as exc:  # hand the failure to every waiter
                if not entries:
                    raise
                for e in entries:
                    if not e.event.is_set():
                        # a fresh instance per waiter: request threads re-raising
                        # one shared exception would mutate its traceback at once
                        try:
                            err: BaseException = type(exc)(*exc.args)
                        except Exception:
                            err = RuntimeError(f"batched forward failed: {exc!r}")
                        err.__cause__ = exc
                        e.error = err
                        e.event.set()

    def _next_deadline_locked(self) -> Optional[float]:
        if not self._pending:
            return None
        now = time.monotonic()
        soonest = min(v[2] for v in self._pending.values())
        return max(0.0, soonest + self.max_wait_s - now)

    def _take_ready_locked(self):
        """Pop the pending group that is full or past its window, if any."""
        now = time.monotonic()
        best_key = None
        for key, (fn, axes, ts, entries) in self._pending.items():
            if len(entries) >= self.max_batch or \
                    now >= ts + self.max_wait_s or self._closed:
                if best_key is None or \
                        len(entries) > len(self._pending[best_key][3]):
                    best_key = key
        if best_key is None:
            return None
        fn, axes, ts, entries = self._pending.pop(best_key)
        take, rest = entries[:self.max_batch], entries[self.max_batch:]
        if rest:
            # keep the group's original window: overflow entries arrived
            # during it, so their queueing latency stays bounded
            self._pending[best_key] = [fn, axes, ts, rest]
        return fn, axes, take

    def _execute(self, fn, out_axes, entries: List[_Entry],
                 pending: Optional[int]) -> None:
        n = len(entries)
        b = _bucket(n, self.max_batch, self.bucket_multiple)
        with profiling.annotate("batch.step") as span:
            if span:
                taken = time.perf_counter_ns()
                for e in entries:
                    if e.enqueued is not None:
                        profiling.record("batch.queue_wait", e.enqueued, taken,
                                         parent=e.request)
                span.set(n=n, b=b, pending=pending, requests=[e.request for e in entries])
            with profiling.annotate("batch.stack"):
                items = [e.item for e in entries]
                items += [items[-1]] * (b - n)  # repeat-pad to the bucket
                stacked = np.stack([np.asarray(x) for x in items])
            outputs = fn(stacked)
            if not isinstance(outputs, tuple):
                outputs = (outputs,)
            # one device→host copy per output per batch, sliced on the host
            with profiling.annotate("batch.to_host"):
                outputs = tuple(to_host(o) for o in outputs)
            self.batches_run += 1
            self.items_run += n
            for i, e in enumerate(entries):
                e.result = tuple(
                    None if out is None
                    else (out if ax is None else _slice(out, ax, i))
                    for out, ax in zip(outputs, out_axes))
                e.event.set()


def _slice(x: Any, axis: int, i: int) -> Any:
    """Item ``i``'s length-1 slice along ``axis`` (keeps the dim, so the
    caller's ``[0]`` indexing matches the unbatched path)."""
    idx = [slice(None)] * np.ndim(x)
    idx[axis] = slice(i, i + 1)
    return x[tuple(idx)]
