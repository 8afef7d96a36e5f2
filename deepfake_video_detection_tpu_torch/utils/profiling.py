"""Tracing / profiling of the port's host path (SURVEY.md §5.1 — absent in
the reference; first-class here).

Counterpart of ``deepfake_video_detection_tpu/utils/profiling.py``, with a
span API in place of its ``StageTimer``:

* ``annotate(name, **attrs)`` — a span: a context manager around a piece of
  host work at a layer boundary. Off (no ``recording()`` open and no
  ``torch.profiler`` session recording) it returns one shared no-op object
  after a flag check. On, it appends a :class:`Span` to an in-memory ring of
  ``RING`` records when it closes: its name, its id, the id of the innermost
  span open on the same thread when it opened (its parent), the thread, its
  start and end on ``time.perf_counter_ns()``, and ``attrs``. Where a
  ``torch.profiler`` session records this thread, the span is also a
  profiler range named ``"dfdt::" + name``, so it lands in every profiler
  trace (an operator's ``trace()`` and any other session's);
* ``record(name, start_ns, end_ns, parent, **attrs)`` — a span written after
  the fact (to memory only); ``current()`` — the id of the innermost open
  span of this thread;
* ``count(name, n)`` — counters, kept only while on;
* ``recording()`` — turns the spans and counters on with no profiler;
* ``spans()``, ``counters()``, ``dropped()``, ``clear()`` — snapshots, the
  records lost to the ring's bound, and a reset; ``summary()`` — count,
  p50, p95 and max ms by name;
* ``trace_us(t_ns, base_time_ns)`` — a record's time on a chrome trace's
  clock (µs from the trace's ``baseTimeNanoseconds``), from one anchor pair
  ``(time.time_ns(), time.perf_counter_ns())`` taken as the ring starts
  filling;
* ``trace`` — context manager around ``torch.profiler`` (host and, where
  there is a card, CUDA activity) writing a TensorBoard trace into
  ``log_dir`` or ``DFDT_PROFILE_DIR``; a no-op when neither is set.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import math
import os
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

RING = 1 << 20          # records kept; older ones are dropped and counted
# a span's profiler range: torch's C-level one, not record_function, whose
# operator calls cost ten times as much and release the interpreter lock at
# each span's edges (a thread then waits for it outside every span)
_RANGE = torch._C._profiler._RecordFunctionFast


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    thread: int             # the OS thread id, as a profiler trace's ``tid``
    start_ns: int           # time.perf_counter_ns()
    end_ns: int
    attrs: Dict[str, Any]


_ring: collections.deque = collections.deque(maxlen=RING)
_dropped = 0
_counters: Dict[str, int] = {}
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_recording = 0
_anchor = (time.time_ns(), time.perf_counter_ns())


def enabled() -> bool:
    """Whether spans and counters are kept: a ``recording()`` is open or a
    ``torch.profiler`` session records."""
    return bool(_recording or _autograd_profiler._is_profiler_enabled)


class _Off:
    """The span while nothing records: one shared object that does nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


OFF = _Off()


def _thread() -> tuple:
    """This thread's (stack of open spans, OS thread id)."""
    try:
        return _local.thread
    except AttributeError:
        _local.thread = ([], threading.get_native_id())
        return _local.thread


def _append(record: tuple) -> None:
    """Keep one record, a :class:`Span`'s fields as a plain tuple."""
    global _anchor, _dropped
    if not _ring:
        _anchor = (time.time_ns(), time.perf_counter_ns())
    elif len(_ring) == RING:
        _dropped += 1
    _ring.append(record)


class _Span:
    __slots__ = ("name", "id", "parent", "attrs", "start", "_range")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs, self.id = name, attrs, next(_ids)

    def __enter__(self) -> "_Span":
        stack = _thread()[0]
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self._range = None
        if torch.autograd._profiler_enabled():      # this thread is profiled
            self._range = _RANGE("dfdt::" + self.name)
            self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        stack, tid = _thread()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        _append((self.name, self.id, self.parent, tid, self.start, end, self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Attributes known only inside the span."""
        self.attrs.update(attrs)


def annotate(name: str, **attrs):
    """``with annotate("batch.step", n=16) as span:`` — a span of the host
    work inside (see the module's docstring). ``span`` is false when off,
    so attributes that cost something to compute can wait for
    ``if span: span.set(...)``."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return OFF
    return _Span(name, attrs)


def record(name: str, start_ns: int, end_ns: int, parent: Optional[int] = None,
           **attrs) -> None:
    """A span measured elsewhere (``perf_counter_ns`` times), written to
    memory only, on this thread."""
    if _recording or _autograd_profiler._is_profiler_enabled:
        _append((name, next(_ids), parent, _thread()[1], start_ns, end_ns, attrs))


def current() -> Optional[int]:
    """The id of the innermost span open on this thread, or None."""
    stack = _thread()[0]
    return stack[-1].id if stack else None


def count(name: str, n: int = 1) -> None:
    if _recording or _autograd_profiler._is_profiler_enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Keep spans and counters inside, with no profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def spans() -> List[Span]:
    return [Span._make(r) for r in list(_ring)]


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def dropped() -> int:
    """Records lost to the ring's bound since the last ``clear()``."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _ring.clear()
        _counters.clear()
        _dropped = 0


def trace_us(t_ns: int, base_time_ns: int) -> float:
    """``t_ns`` (``perf_counter_ns``) on a chrome trace's clock: µs from the
    trace's ``baseTimeNanoseconds``."""
    wall, perf = _anchor
    return (wall + (t_ns - perf) - base_time_ns) / 1e3


def summary() -> Dict[str, Dict[str, float]]:
    """Count, p50, p95 and max ms (nearest rank) of the kept spans, by name."""
    by_name: Dict[str, List[int]] = {}
    for s in spans():
        by_name.setdefault(s.name, []).append(s.end_ns - s.start_ns)
    out = {}
    for name, ns in by_name.items():
        ns.sort()
        rank = lambda q: ns[max(0, math.ceil(q * len(ns)) - 1)] / 1e6  # noqa: E731
        out[name] = {"count": len(ns), "p50_ms": rank(0.5), "p95_ms": rank(0.95),
                     "max_ms": ns[-1] / 1e6}
    return out


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """``with trace('/tmp/tb'):`` → TensorBoard trace of everything inside."""
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
