"""Serving cells: the port's ``Predictor`` behind its ``MicroBatcher``,
driven from the client side.

Each request is one clip of packed YUV420 crops, served by
``Predictor._predict_pretrained(packed, video_id, packed_yuv=True)``: the
call ``predict_video`` makes after in-decoder extraction. A closed loop
keeps ``clients`` threads each waiting on its own verdict; an open loop
hands each request, at its due time, to a pool of worker threads and never
waits on them. Set-up builds the detector from the configuration, loads the
seed's weights, waits for the Predictor's warm-up and sends a warm round of
the cell's own traffic before the window opens.
"""

from __future__ import annotations

import concurrent.futures as cf
import functools
import gc
import math
import os
import threading
import time
import types
from typing import Dict, List

import torch

from bench_port import check, flops, traffic
from bench_port.readings import call_range
from bench_port.tracing import Tracer

LATE_WAIT_S = 60.0       # how long past the window a due request is waited for


def build_detector(c: Dict, device, compute_dtype: torch.dtype) -> torch.nn.Module:
    """The port's detector of configuration ``c``, its tensors allocated on
    ``device`` and not initialised (the seed's weights are loaded next)."""
    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
    from deepfake_video_detection_tpu_torch.nn import init as I

    h = c["head"]
    with I.shapes_only():
        model = BackboneDetector(c["backbone"], num_classes=h["num_classes"],
                                 dropout_rate=h["dropout"], compute_dtype=compute_dtype,
                                 device="meta")
    return model.to_empty(device=device)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


class KernelRanges:
    """While active, the port's K1 packed-YUV entry and its flash forward and
    backward run inside profiler ranges named by their call's shape and
    dtype (``readings.call_range``); the launch counters move with the
    wrapped functions and back."""

    def __init__(self):
        from deepfake_video_detection_tpu_torch.ops import attention as A
        from deepfake_video_detection_tpu_torch.serve import predict as P

        self._swaps = []
        self._wrap(A, "flash_attention_fwd", "flash_fwd",
                   lambda q, *a: (tuple(q.shape), q.dtype))
        self._wrap(A, "flash_attention_bwd", "flash_bwd",
                   lambda q, *a: (tuple(q.shape), q.dtype))
        self._wrap(P, "fused_normalize_yuv", "k1_yuv",
                   lambda x, h, w, out_dtype=torch.bfloat16:
                   ((x.numel() // x.shape[-1], h, w), out_dtype))

    def _wrap(self, module, attr: str, kind: str, shape_of) -> None:
        orig = getattr(module, attr)

        @functools.wraps(orig)
        def wrapped(*args, **kw):
            shape, dt = shape_of(*args, **kw)
            name = call_range(kind, shape, "bf16" if dt == torch.bfloat16 else "f32")
            with torch.profiler.record_function(name):
                return orig(*args, **kw)

        for k, v in vars(orig).items():
            if k.startswith("launches"):
                setattr(wrapped, k, v)
        self._swaps.append((module, attr, orig, wrapped))
        setattr(module, attr, wrapped)

    def close(self) -> None:
        for module, attr, orig, wrapped in self._swaps:
            setattr(module, attr, orig)
            for k, v in vars(wrapped).items():
                if k.startswith("launches"):
                    setattr(orig, k, v)


def account(due, started: Dict[int, tuple], done: Dict[int, tuple], t_end: float):
    """(the requests served, each due request's latency in ms from its due
    or start time, the number served by ``t_end``). A request that failed,
    or never finished, is missing: its latency is infinite."""
    ok = [i for i in due if i in done and isinstance(done[i][1], tuple)]
    good = set(ok)
    lat = [1e3 * (done[i][0] - started[i][1]) if i in good else math.inf for i in due]
    return ok, lat, sum(done[i][0] <= t_end for i in ok)


def _clients(n: int, body) -> List[threading.Thread]:
    threads = [threading.Thread(target=body, name=f"client-{i}", daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    return threads


def run(cell, seed: int, seconds: float, trace: bool, device="cuda") -> types.SimpleNamespace:
    c, m = cell.config, cell.traffic
    T, size = m["frames"], m["face_size"]
    os.environ.update({"MAX_FRAMES": str(T), "SERVE_WINDOWS": "1", "FACE_SIZE": str(size)})
    from deepfake_video_detection_tpu_torch.serve import predict as P

    dtype = P.serving_dtype(device)
    if torch.device(device).type == "cuda" and dtype != dtype_of(c["compute_dtype"]):
        raise RuntimeError(f"the program serves {dtype}, the configuration states "
                           f"{c['compute_dtype']}")
    phases = {"imported": time.perf_counter()}
    model = build_detector(c, device, dtype)
    phases["built"] = time.perf_counter()
    pred = P.Predictor(model, check.detector_state(c, seed, device), "pretrained", device=device)
    if not pred.warmup_done.wait(timeout=900) or pred.warmup_error is not None:
        raise RuntimeError(f"the Predictor's warm-up failed: {pred.warmup_error!r}")
    phases["predictor_warm"] = time.perf_counter()
    pool = traffic.yuv_clip_pool(seed, m["pool_clips"], T, size)
    order = traffic.request_clips(seed, 64 * m["pool_clips"], m["pool_clips"])
    started: Dict[int, tuple] = {}     # request -> (clip, due or start)
    done: Dict[int, tuple] = {}        # request -> (finish, result)
    tracer = Tracer("bench::batch") if trace else None
    window = _TraceWindow(tracer, pred)
    if trace:
        tracer.warm()
        inner = pred._run

        def batch_step(rows, yuv):
            window.batch_starts()
            with torch.profiler.record_function("bench::batch"):
                return inner(rows, yuv)

        pred._run = batch_step
        ranges = KernelRanges()

    def serve_one(i: int, due=None) -> None:
        k = int(order[i % len(order)])
        started[i] = (k, time.perf_counter() if due is None else due)
        try:
            res = pred._predict_pretrained(pool[k], f"r{i}", packed_yuv=True)
            res = (res["prob_fake"], res["prob_real"])     # kept small: see below
        except Exception as e:     # a failed request counts as missing
            res = {"error": repr(e)}
        done[i] = (time.perf_counter(), res)

    lock, counter = threading.Lock(), iter(range(1 << 40))

    def next_request() -> int:
        with lock:
            return next(counter)

    # a warm round of the cell's own traffic, in set-up
    if m["loop"] == "closed":
        per = m["warm_requests_per_client"]
        for t in _clients(m["clients"], lambda: [serve_one(next_request()) for _ in range(per)]):
            t.join()
    else:
        with cf.ThreadPoolExecutor(m["workers"]) as ex:
            list(ex.map(serve_one, [next_request() for _ in range(
                max(m["workers"], int(m["rate_per_s"] * m["warm_seconds"])))]))
    phases["traffic_warm"] = time.perf_counter()
    started.clear()
    done.clear()
    # what set-up made stays out of the collector's scans in the window, and
    # each verdict is kept as two floats: the harness's own objects must not
    # make the collector pause the program
    gc.collect()
    gc.freeze()
    _sync(device)
    out = types.SimpleNamespace(phases=phases)
    lateness: List[float] = []
    b0 = (pred._batcher.batches_run, pred._batcher.items_run)
    out.setup_done = t0 = time.perf_counter()
    t_end = t0 + seconds
    window.arm(t_end - min(m["trace_seconds"], seconds / 2), t_end, out)
    if m["loop"] == "closed":
        def client():
            while True:
                i = next_request()
                if time.perf_counter() >= t_end:
                    return
                serve_one(i)

        threads = _clients(m["clients"], client)
        for t in threads:
            t.join(timeout=max(0.0, t_end + LATE_WAIT_S - time.perf_counter()))
        due = sorted(i for i, (_, t) in started.items() if t < t_end)
    else:
        offsets = traffic.poisson_offsets(seed, m["rate_per_s"], seconds)
        ex = cf.ThreadPoolExecutor(m["workers"])
        futures, due = [], []
        for off in offsets:
            when = t0 + off
            now = time.perf_counter()
            if when > now:
                time.sleep(when - now)
            lateness.append(time.perf_counter() - when)
            due.append(next_request())
            futures.append(ex.submit(serve_one, due[-1], when))
        cf.wait(futures, timeout=max(0.0, t_end + LATE_WAIT_S - time.perf_counter()))
        ex.shutdown(wait=False, cancel_futures=True)
    b1 = (pred._batcher.batches_run, pred._batcher.items_run)
    if tracer is not None:
        window.close(lambda: serve_one(next_request()))
        out.trace = tracer.summary()
        out.trace_steps = len(out.trace.named("bench::batch"))
        ranges.close()

    ok, lat, completed = account(due, started, done, t_end)
    tenth = max(1, len(lat) // 10)
    out.backlog = {"not_done_at_close": len(due) - completed,
                   "median_ms_first_tenth": traffic.nearest_rank(lat[:tenth], 0.5),
                   "median_ms_last_tenth": traffic.nearest_rank(lat[-tenth:], 0.5)}
    out.__dict__.update(
        window_s=seconds, attempted=len(due), failed=len(due) - len(ok),
        completed=completed, latencies_ms=lat,
        batches=b1[0] - b0[0], items=b1[1] - b0[1],
        lateness_ms=[1e3 * x for x in lateness],
        flops_per_clip=flops.model_flops_per_clip(c, T),
        memory_peak_bytes=torch.cuda.max_memory_allocated()
        if torch.device(device).type == "cuda" else 0)

    # the correctness sample, judged once the program's state is freed
    sample = sorted(traffic.rng(seed, 5).choice(
        ok, size=min(len(ok), m["check_requests"]), replace=False).tolist()) if ok else []
    served = [(started[i][0], done[i][1]) for i in sample]
    pred.close()
    del pred, model, started, done
    _free(device)
    numbers = {}
    if served:
        ref = check.reference_logodds(c, seed, pool, [k for k, _ in served], size, device)
        numbers["logodds_gap"] = check.logodds_gap(served, ref)
    out.numbers, out.checked = numbers, len(served)
    return out


class _TraceWindow:
    """The traced part of a serving window, its last seconds, started and
    stopped on the batcher's thread, which launches all the device work
    (the profiler records the host operations of the thread it is started
    on and of the autograd threads it spawns). It opens with the first
    batch to start after ``at`` and closes with the first to end after
    ``t_end``; stopping stalls the host for some seconds, after the window."""

    def __init__(self, tracer, pred):
        self.tracer, self.pred = tracer, pred
        self.at = self.t_end = self.out = self.n0 = None
        self.closed = threading.Event()

    def arm(self, at: float, t_end: float, out) -> None:
        self.at, self.t_end, self.out = at, t_end, out

    def batch_starts(self) -> None:
        """Before each batch: open at the first after ``at``; close at the
        first after ``t_end`` (every traced batch's clips are counted by
        then)."""
        if self.at is None or self.closed.is_set():
            return
        now = time.perf_counter()
        if self.n0 is None and now >= self.at:
            self.n0 = self.pred._batcher.items_run
            self.tracer.start()
        elif self.n0 is not None and now >= self.t_end:
            self.tracer.stop()
            self.out.trace_items = self.pred._batcher.items_run - self.n0
            self.closed.set()

    def close(self, request) -> None:
        """After the window: one more request, if no batch has closed it."""
        if self.n0 is not None and not self.closed.is_set():
            request()
        self.closed.wait(timeout=120)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _free(device) -> None:
    import gc

    gc.collect()
    _sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
