"""Tracing / profiling utilities (SURVEY.md §5.1 — absent in the reference;
first-class here).

Counterpart of ``deepfake_video_detection_tpu/utils/profiling.py``:

* ``StageTimer`` — lightweight per-stage wall-clock accounting for the
  serving pipeline (decode / detect / forward), with rolling means; a copy;
* ``trace`` — context manager around ``torch.profiler`` (host and, where
  there is a card, CUDA activity) writing a TensorBoard trace into
  ``log_dir`` or ``DFDT_PROFILE_DIR``; a no-op when neither is set;
* ``annotate`` — named region on the profiler's timeline
  (``torch.profiler.record_function``).
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict, Iterator, Optional


class StageTimer:
    def __init__(self, window: int = 100):
        self._samples: Dict[str, collections.deque] = {}
        self.window = window

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dq = self._samples.setdefault(
                name, collections.deque(maxlen=self.window))
            dq.append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, dq in self._samples.items():
            if not dq:
                continue
            vals = sorted(dq)
            out[name] = {
                "mean_ms": sum(vals) / len(vals) * 1e3,
                "p50_ms": vals[len(vals) // 2] * 1e3,
                "max_ms": vals[-1] * 1e3,
                "count": len(vals),
            }
        return out

    def report(self) -> str:
        return " | ".join(
            f"{name}: {s['mean_ms']:.1f}ms (p50 {s['p50_ms']:.1f}, "
            f"max {s['max_ms']:.1f}, n={s['count']})"
            for name, s in self.summary().items())


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """``with trace('/tmp/tb'):`` → TensorBoard trace of everything inside."""
    import torch

    log_dir = log_dir or os.environ.get("DFDT_PROFILE_DIR")
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region on the profiler's timeline."""
    import torch

    with torch.profiler.record_function(name):
        yield
