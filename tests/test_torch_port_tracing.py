"""The port's spans and counters (``utils/profiling.py``), on the CPU: off
they record nothing; on, they nest by thread, the batcher ties each item's
queue wait to its caller's request, a profiler trace carries them on its
own clock, and the loader, the Predictor and the train step write theirs.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from deepfake_video_detection_tpu_torch.data.faces import FaceExtractor
from deepfake_video_detection_tpu_torch.data.loader import Loader
from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
from deepfake_video_detection_tpu_torch.models.vit import VisionTransformer
from deepfake_video_detection_tpu_torch.serve import predict as port_predict
from deepfake_video_detection_tpu_torch.serve.batcher import MicroBatcher
from deepfake_video_detection_tpu_torch.train import optim
from deepfake_video_detection_tpu_torch.train.state import TrainState
from deepfake_video_detection_tpu_torch.train.steps import make_train_step
from deepfake_video_detection_tpu_torch.utils import profiling

from test_torch_port_serve import SIZE, T, serve_env  # noqa: F401 (a fixture)


@pytest.fixture(autouse=True)
def empty_ring():
    profiling.clear()
    yield
    profiling.clear()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_records_nothing():
    assert not profiling.enabled()
    assert profiling.annotate("a") is profiling.OFF
    assert profiling.annotate("b", n=3) is profiling.OFF
    with profiling.annotate("a") as span:
        assert not span
        span.set(n=1)
        assert profiling.current() is None
    profiling.count("c")
    profiling.record("d", 0, 1)
    assert profiling.spans() == [] and profiling.counters() == {}
    assert profiling.dropped() == 0 and profiling.summary() == {}


def test_recording_nests_parents_on_one_thread():
    seen = []
    with profiling.recording():
        with profiling.annotate("outer", k=1) as outer:
            assert outer and profiling.current() == outer.id
            with profiling.annotate("inner") as inner:
                inner.set(m=2)
            with profiling.annotate("inner"):
                # another thread's spans have their own stack
                t = threading.Thread(target=lambda: seen.append(
                    profiling.annotate("other").__enter__().parent))
                t.start()
                t.join(timeout=10)
        profiling.count("c", 2)
        profiling.count("c")
    assert not t.is_alive() and seen == [None]
    assert profiling.annotate("after") is profiling.OFF
    spans = _by_name(profiling.spans())
    (o,) = spans["outer"]
    assert o.parent is None and o.attrs == {"k": 1} and o.thread == threading.get_native_id()
    assert [s.parent for s in spans["inner"]] == [o.id, o.id]
    assert spans["inner"][0].attrs == {"m": 2}
    assert all(o.start_ns <= s.start_ns <= s.end_ns <= o.end_ns for s in spans["inner"])
    assert profiling.counters() == {"c": 3}
    assert profiling.summary()["inner"]["count"] == 2


def test_summary_over_ticks(monkeypatch):
    ticks = iter(range(0, 10 ** 9, 1_250_000))      # 1.25 ms between readings
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(ticks))
    with profiling.recording():
        for _ in range(5):
            for name in ("decode", "detect"):
                with profiling.annotate(name):
                    pass
        with pytest.raises(ValueError):
            with profiling.annotate("fails"):
                raise ValueError
    monkeypatch.undo()
    s = profiling.summary()
    assert set(s) == {"decode", "detect", "fails"}
    assert s["decode"] == {"count": 5, "p50_ms": 1.25, "p95_ms": 1.25, "max_ms": 1.25}
    assert s["fails"]["count"] == 1


def test_batcher_ties_each_queue_wait_to_its_request():
    batcher = MicroBatcher(max_batch=4, max_wait_s=0.05)
    fn = lambda x: (x * 2,)          # noqa: E731
    requests, results = {}, {}

    def client(i):
        with profiling.annotate("serve.request") as req:
            requests[i] = req.id
            results[i] = batcher.call(fn, np.full(3, i, np.float32), (0,))[0]

    with profiling.recording():
        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        batcher.close()
    assert not any(t.is_alive() for t in threads)
    for i in range(3):
        np.testing.assert_array_equal(results[i], np.full((1, 3), 2 * i, np.float32))
    spans = _by_name(profiling.spans())
    waits = spans["batch.queue_wait"]
    assert sorted(w.parent for w in waits) == sorted(requests.values())
    assert all(w.end_ns >= w.start_ns for w in waits)
    steps = spans["batch.step"]
    assert sorted(r for s in steps for r in s.attrs["requests"]) == sorted(requests.values())
    assert sum(s.attrs["n"] for s in steps) == 3 and all(s.attrs["b"] >= s.attrs["n"]
                                                         for s in steps)
    batcher_thread = {s.thread for s in steps}
    assert {w.thread for w in waits} == batcher_thread
    assert {s.thread for s in spans["batch.collect"]} == batcher_thread
    step_ids = {s.id for s in steps}
    assert all(s.parent in step_ids for s in spans["batch.stack"] + spans["batch.to_host"])


@pytest.mark.parametrize("fault", ["record", "_append"])
def test_a_failing_span_reaches_the_batchers_waiters(monkeypatch, fault):
    """A fault in the span code (the queue wait's record inside the step, or
    the collect span's close after the take) is each waiter's error, not a
    dead batcher thread and a caller waiting for ever."""
    def fail(*args, **kwargs):
        raise RuntimeError("span fault")

    batcher = MicroBatcher(max_batch=2, max_wait_s=0.01)
    errors = []

    def client():
        try:
            batcher.call(lambda x: (x,), np.zeros(3, np.float32), (0,))
        except RuntimeError as e:
            errors.append(e)

    with profiling.recording():
        monkeypatch.setattr(profiling, fault, fail)
        t = threading.Thread(target=client, daemon=True)
        t.start()
        t.join(timeout=10)
        monkeypatch.undo()
        batcher.close()
        # the worker's last span closes before the next test patches anything
        batcher._worker.join(timeout=10)
    assert not t.is_alive() and not batcher._worker.is_alive()
    assert [str(e) for e in errors] == ["span fault"]


def test_a_span_lands_in_a_profiler_trace_on_its_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.enabled()
        with profiling.annotate("warm"):
            pass
        with profiling.annotate("clock", n=1):
            torch.ones(8).sum()
    assert not profiling.enabled()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    (event,) = [e for e in trace["traceEvents"] if e.get("name") == "dfdt::clock"]
    (span,) = [s for s in profiling.spans() if s.name == "clock"]
    start = profiling.trace_us(span.start_ns, trace["baseTimeNanoseconds"])
    assert abs(start - float(event["ts"])) < 200
    assert event["tid"] == span.thread


def test_loader_counts_batches_asked_and_ready():
    class Items:
        def __init__(self, delay):
            self.delay = delay

        def __len__(self):
            return 4

        def __getitem__(self, i):
            time.sleep(self.delay)
            return np.full((2, 2), i, np.uint8), i % 2, f"clip{i}"

    read = {}
    for delay, pause in ((0.05, 0.0), (0.0, 0.02)):
        profiling.clear()
        with profiling.recording():
            for _ in Loader(Items(delay), batch_size=1, num_workers=1):
                time.sleep(pause)
        read[delay] = profiling.counters()
        spans = _by_name(profiling.spans())
        assert len(spans["loader.wait"]) == len(spans["loader.stack"]) == 4
        assert sum(s.attrs["ready"] for s in spans["loader.wait"]) == read[delay]["loader.ready"]
    assert read[0.05] == {"loader.asked": 4, "loader.ready": 0}
    assert read[0.0]["loader.asked"] == 4 and read[0.0]["loader.ready"] > 0


def test_a_predictor_request_nests_its_spans(serve_env):  # noqa: F811
    model = BackboneDetector("vit_tiny_patch16_224", device="cpu")
    model.backbone = VisionTransformer(variant="vit_tiny_patch16_224", img_size=SIZE,
                                       depth=2, device="cpu")
    pred = port_predict.Predictor(
        model, None, "pretrained", device="cpu",
        extractor=FaceExtractor(detector="center", face_size=SIZE, device="cpu"))
    faces = np.random.default_rng(0).integers(0, 256, (T, SIZE, SIZE, 3), np.uint8)
    with profiling.recording():
        result = pred._predict_pretrained(faces, "clip")
    pred.close()
    assert "error" not in result
    spans = _by_name(profiling.spans())
    (req,), (policy,) = spans["serve.request"], spans["serve.policy"]
    assert policy.parent == req.id and req.start_ns <= policy.start_ns <= policy.end_ns
    (step,), (h2d,), (fwd,) = spans["batch.step"], spans["serve.h2d"], spans["serve.forward"]
    assert step.attrs["requests"] == [req.id] and step.attrs["n"] == 1
    assert h2d.parent == step.id and fwd.parent == step.id
    assert [w.parent for w in spans["batch.queue_wait"]] == [req.id]
    flash = spans["ops.flash_fwd"]
    assert len(flash) == 2 and all(s.attrs["dtype"] == torch.float32 for s in flash)


def test_a_train_step_nests_forward_backward_and_update():
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 2)

    class Wrapped(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = model

        def forward(self, x, train=False, generator=None):
            return self.net(x)

    net = Wrapped()
    tx = optim.build_optimizer("adam", 1e-3)
    state = TrainState.create(net, tx)
    step = make_train_step(net, tx, lambda logits, labels, sample_mask=None:
                           torch.nn.functional.cross_entropy(logits, labels))
    batch = {"frames": torch.randn(3, 4), "labels": torch.tensor([0, 1, 1])}
    with profiling.recording():
        step(state, batch)
    spans = _by_name(profiling.spans())
    (s,) = spans["train.step"]
    assert [spans[n][0].parent for n in ("train.forward", "train.backward",
                                         "train.update")] == [s.id] * 3
