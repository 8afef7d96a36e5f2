"""The program's own spans and counters, for the per-layer readers
(``metrics/*.py``) of a ``--trace 1`` run.

The port (``utils/profiling.py``) keeps its spans and counters in memory
while a profiler session records, so in a traced run they cover the traced
window. Each function here returns None where there is nothing to read: a
run without a trace, a program without that span API or without the names
asked for, or a ring that dropped records.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional


def _profiling(run):
    if getattr(run, "trace", None) is None:
        return None
    try:
        from deepfake_video_detection_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, f) for f in ("spans", "counters", "dropped")):
        return None
    return None if profiling.dropped() else profiling


def durations_ms(run, *names: str) -> Optional[List[float]]:
    """The durations of every span named ``names``, in ms."""
    profiling = _profiling(run)
    if profiling is None:
        return None
    out = [(s.end_ns - s.start_ns) / 1e6 for s in profiling.spans() if s.name in names]
    return out or None


def median_ms(run, *names: str) -> Optional[float]:
    d = durations_ms(run, *names)
    return None if d is None else statistics.median(d)


def total_ms(run, name: str) -> float:
    return sum(durations_ms(run, name) or [])


def paired_ms(run, first: str, then: str) -> Optional[List[float]]:
    """A step's two spans that follow each other on one thread (the
    loader's stack and pin, the trainer's prep and step), summed: each
    ``then`` with the ``first`` that came last before it."""
    profiling = _profiling(run)
    if profiling is None:
        return None
    out, last = [], {}
    for s in sorted((s for s in profiling.spans() if s.name in (first, then)),
                    key=lambda s: s.start_ns):
        if s.name == first:
            last[s.thread] = s
        elif s.thread in last:
            a = last.pop(s.thread)
            out.append((a.end_ns - a.start_ns + s.end_ns - s.start_ns) / 1e6)
    return out or None


def counters(run) -> Optional[Dict[str, int]]:
    profiling = _profiling(run)
    return None if profiling is None else profiling.counters()
