"""The readers of the program's own spans and counters: None with nothing
to read (no trace, no spans, a program without the span API, a ring that
dropped records), the right value from planted spans, and values from a
traced CPU run of the serving and training cells."""

import json
import time
import types

import pytest

from bench_port import registry
from bench_port import run as R
from deepfake_video_detection_tpu_torch.utils import profiling

SEED = 2 ** 31 + 7
SERVE = ("queue_wait_ms.clips", "batcher_busy_pct.clips", "stack_ms_per_step.clips",
         "h2d_ms_per_step.clips", "policy_ms.clips", "flash_host_us.clips")
TRAIN = ("loader_ready_pct.train", "loader_host_ms_per_step.train", "step_host_ms.train",
         "flash_host_us.train")
MS = 1_000_000


def _span(name, start_ms, dur_ms, thread=1):
    return profiling.Span(name, 0, None, thread, int(start_ms * MS),
                          int((start_ms + dur_ms) * MS), {})


PLANTED = [
    _span("batch.collect", 0, 6), _span("batch.step", 6, 18),
    _span("batch.stack", 6, 2), _span("serve.h2d", 8, 1),
    _span("batch.collect", 24, 2), _span("batch.step", 26, 18),
    _span("batch.stack", 26, 4), _span("serve.h2d", 30, 3),
    _span("batch.queue_wait", 0, 10), _span("batch.queue_wait", 0, 30),
    _span("batch.queue_wait", 0, 20),
    _span("serve.policy", 30, 0.5, thread=2), _span("serve.policy", 50, 1.5, thread=3),
    _span("ops.flash_fwd", 10, 0.02), _span("ops.flash_fwd", 11, 0.04),
    _span("ops.flash_bwd", 12, 0.09, thread=4), _span("ops.flash_bwd", 13, 0.11, thread=4),
    # the loader's stack and pin, the trainer's prep and step: a pin and a
    # step whose first half fell before the window are not counted
    _span("loader.pin", 100, 3), _span("train.step", 101, 40),
    _span("loader.stack", 150, 6), _span("loader.pin", 156, 2),
    _span("train.prep", 158, 1), _span("train.step", 159, 30),
    _span("loader.stack", 200, 8), _span("loader.pin", 208, 4),
    _span("train.prep", 212, 3), _span("train.step", 215, 50),
    _span("loader.stack", 270, 10), _span("loader.pin", 280, 5),
    _span("train.prep", 285, 2), _span("train.step", 287, 44),
]
EXPECTED = {
    "queue_wait_ms.clips": 20.0,
    "batcher_busy_pct.clips": 100.0 * 36 / 44,
    "stack_ms_per_step.clips": 3.0,
    "h2d_ms_per_step.clips": 2.0,
    "policy_ms.clips": 1.0,
    "flash_host_us.clips": 30.0,
    "loader_ready_pct.train": 75.0,
    "loader_host_ms_per_step.train": 12.0,     # 8, 12, 15
    "step_host_ms.train": 46.0,                # 31, 53, 46
    "flash_host_us.train": 65.0,                # (30 + 100) / 2
}


@pytest.fixture
def planted(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(PLANTED))
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"loader.asked": 4, "loader.ready": 3})
    return monkeypatch


def _read(name, run):
    return registry.reader(name)(run)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_a_reader_reads_planted_spans(planted, name):
    assert _read(name, types.SimpleNamespace(trace=object())) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_a_reader_with_nothing_to_read_returns_none(planted, name):
    traced = types.SimpleNamespace(trace=object())
    assert _read(name, types.SimpleNamespace(trace=None)) is None
    planted.setattr(profiling, "dropped", lambda: 1)
    assert _read(name, traced) is None
    planted.setattr(profiling, "dropped", lambda: 0)
    planted.setattr(profiling, "spans", lambda: [])
    planted.setattr(profiling, "counters", lambda: {})
    assert _read(name, traced) is None
    planted.delattr(profiling, "spans")         # a program without the span API
    assert _read(name, traced) is None


@pytest.mark.parametrize("cell,names", [("vit_b16.serve.backlog", SERVE),
                                        ("vit_b16.train", TRAIN)])
def test_a_traced_cpu_run_reads_the_programs_spans(tiny_root, cell, names):
    seconds = 1.0
    if cell.endswith("train"):      # seconds for a CPU step to start inside the trace
        mix = tiny_root / "bench_port" / "workloads" / "train_loop.json"
        mix.write_text(json.dumps(dict(json.loads(mix.read_text()), trace_seconds=3)))
        seconds = 6.0
    profiling.clear()
    try:
        result, lines = R.run_cell(cell, SEED, seconds, True, device="cpu", root=tiny_root,
                                   t_start=time.perf_counter())
    finally:
        kept = profiling.summary()
        profiling.clear()
    assert result["correct"], lines
    metrics = result["metrics"]
    assert set(names) <= set(metrics), (sorted(metrics), sorted(kept))
    if cell.endswith("backlog"):
        assert metrics["queue_wait_ms.clips"]["value"] > 0
        assert metrics["policy_ms.clips"]["value"] > 0
        assert 0 < metrics["batcher_busy_pct.clips"]["value"] <= 100
    else:
        assert 0 <= metrics["loader_ready_pct.train"]["value"] <= 100
        assert metrics["step_host_ms.train"]["value"] > 0
