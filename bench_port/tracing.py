"""The traced window of a ``--trace 1`` run: ``torch.profiler`` over CPU and
CUDA for a part of the measured window, exported to the checkout's
temporary directory, read and deleted.

What it reads: the window's length (its ``bench::window`` range), the
device's busy time (the union of kernel, copy and memset intervals inside
it), the kernels launched, the ten device operations that took most time,
the ten longest idle gaps with the host operation that was running on the
stepping thread at their midpoint, and every ``bench::`` range with the
device time of the kernels launched inside it (each kernel is tied by its
correlation id to the runtime call that launched it, and that call to the
innermost range around it on its thread).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench::window"


@dataclass
class Range:
    name: str
    tid: object
    start: float        # us
    end: float
    device_us: float = 0.0


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: int
    device_ops: List[list]
    idle_gaps: List[list]
    ranges: List[Range] = field(default_factory=list)

    def named(self, prefix: str) -> List[Range]:
        return [r for r in self.ranges if r.name.split("|", 1)[0] == prefix]


class Tracer:
    """``start()`` and ``stop()`` around a part of the window, then
    ``summary()``. ``step_range`` names the ranges whose
    thread labels the idle gaps."""

    def __init__(self, step_range: str):
        self.step_range = step_range
        self._prof = self._window = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * torch.cuda.is_available()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._window = record_function(WINDOW)
        self._window.__enter__()
        _sync(torch)

    def warm(self) -> None:
        """One short session in set-up, so the profiler's own first-use
        costs fall outside the window."""
        self.start()
        self.stop()
        self._prof = self._window = None

    def stop(self) -> None:
        import torch

        self._window.__exit__(None, None, None)
        _sync(torch)
        self._prof.__exit__(None, None, None)

    def summary(self) -> Summary:
        """Export, read and delete the trace (after the window: it takes
        the host some seconds)."""
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_port_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return summarize(events, self.step_range)


def _sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(spans, t: float) -> Optional[int]:
    """Index of the latest-starting span in ``spans`` (sorted by start, each
    (start, end, ...)) that contains ``t``."""
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    while i >= 0:
        if spans[i][0] <= t <= spans[i][1]:
            return i
        i -= 1
        if i >= 0 and t - spans[i][0] > 5e6:     # nothing runs 5 s on one thread
            break
    return None


def summarize(events: List[Dict], step_range: str) -> Summary:
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace has no window range")
    w0, w1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])

    gpu = []
    for e in xs:
        if e.get("cat") in GPU_CATS:
            a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
            if b > w0 and a < w1:
                gpu.append((max(a, w0), min(b, w1), e))
    busy = _union([(a, b) for a, b, _ in gpu])
    busy_us = sum(b - a for a, b in busy)

    by_op: Dict[str, float] = {}
    for a, b, e in gpu:
        by_op[e["name"]] = by_op.get(e["name"], 0.0) + (b - a)
    device_ops = [[n[:160], us / 1e6] for n, us in
                  sorted(by_op.items(), key=lambda kv: -kv[1])[:10]]

    # bench:: ranges by thread, and each kernel's device time to its range
    ranges: Dict[object, List[Range]] = {}
    for e in xs:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name.startswith("bench::") and name != WINDOW:
            r = Range(name, e.get("tid"), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            ranges.setdefault(r.tid, []).append(r)
    spans = {tid: sorted(((r.start, r.end, r) for r in rs), key=lambda s: s[:2])
             for tid, rs in ranges.items()}
    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    kernels = 0
    for a, b, e in gpu:
        if e.get("cat") != "kernel":
            continue
        kernels += 1
        rt = launches.get(e.get("args", {}).get("correlation"))
        if rt is None or rt.get("tid") not in spans:
            continue
        s = spans[rt["tid"]]
        i = _innermost(s, float(rt["ts"]))
        if i is not None:
            s[i][2].device_us += float(e.get("dur", 0))

    inside = [r for rs in ranges.values() for r in rs if r.start >= w0 and r.end <= w1]
    gaps = _idle_gaps(busy, w0, w1, xs, ranges, step_range)
    return Summary(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6, kernels=kernels,
                   device_ops=device_ops, idle_gaps=gaps,
                   ranges=sorted(inside, key=lambda r: r.start))


def _idle_gaps(busy, w0, w1, xs, ranges, step_range: str) -> List[list]:
    """The ten longest spans of the window with nothing on the device, each
    named by the innermost host operation on the stepping thread at its
    midpoint."""
    edges = [w0] + [x for seg in busy for x in seg] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    counts = {tid: sum(r.name == step_range for r in rs) for tid, rs in ranges.items()}
    tid = max(counts, key=counts.get) if counts and max(counts.values()) else None
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
                  if e.get("tid") == tid and e.get("cat") in
                  ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"))
    out = []
    for us, start in gaps:
        i = _innermost(host, start + us / 2) if host else None
        out.append([("host: " + host[i][2][:120]) if i is not None
                    else "host: no traced operation", us / 1e6])
    return out
