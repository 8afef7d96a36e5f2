"""Shared arithmetic of the per-layer metric readers (``metrics/*.py``).
Each returns None where the run has nothing to read, never 0 for a share
of a roofline or of a peak."""

from __future__ import annotations

from typing import Optional

from bench_port import flops


def call_range(kind: str, shape, dtype: str) -> str:
    """The name of a kernel call's profiler range: its kind, shape, dtype."""
    return f"bench::{kind}|{','.join(str(int(s)) for s in shape)}|{dtype}"


WORK = {"bench::flash_fwd": lambda s, dt: flops.flash_fwd_work(*s, dt),
        "bench::flash_bwd": lambda s, dt: flops.flash_bwd_work(*s, dt),
        "bench::k1_yuv": lambda s, dt: flops.k1_yuv_work(*s, dt)}


def roofline_pct(run, kind: str) -> Optional[float]:
    """100 x the least time of every traced call of ``kind`` (from its
    shapes and dtype) over the device time of the kernels its ranges
    launched."""
    trace = getattr(run, "trace", None)
    if trace is None:
        return None
    least = device = 0.0
    for r in trace.named(kind):
        _, shape, dtype = r.name.split("|")
        nbytes, ops = WORK[kind]([int(s) for s in shape.split(",")], dtype)
        least += flops.least_time_s(nbytes, ops, dtype)
        device += r.device_us / 1e6
    return 100.0 * least / device if device > 0 else None


def idle_pct(run) -> Optional[float]:
    trace = getattr(run, "trace", None)
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def device_ms_per_step(run) -> Optional[float]:
    trace = getattr(run, "trace", None)
    steps = getattr(run, "trace_steps", 0)
    if trace is None or not steps or trace.busy_s <= 0:
        return None
    return 1e3 * trace.busy_s / steps


def mfu_pct(run, flops_done: float) -> Optional[float]:
    """100 x the model FLOPs of the useful work done in the traced window
    over the window over the bf16 peak."""
    trace = getattr(run, "trace", None)
    if trace is None or trace.window_s <= 0 or flops_done <= 0:
        return None
    return 100.0 * flops_done / trace.window_s / flops.PEAK_FLOPS["bf16"]
