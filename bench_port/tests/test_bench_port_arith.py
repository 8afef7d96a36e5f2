"""The yardstick's arithmetic against hand-worked values, the traffic
generator's determinism, the open loop's accounting, the registry, the
import check and the trace reader."""

import math

import numpy as np
import pytest

from bench_port import flops, guard, registry, serve, tracing, traffic, weights
from bench_port.reference import models as R

VIT = registry.load_json(registry.HERE / "configs" / "vit_b16.json")
B0 = registry.load_json(registry.HERE / "configs" / "efficientnet_b0.json")


def test_flash_work_at_the_vit_training_shape():
    # PERF.md's worked bounds at (128, 12, 197, 64), bf16: 0.0466 and 0.0929 ms
    nbytes, ops = flops.flash_fwd_work(128, 12, 197, 64, "bf16")
    assert nbytes == pytest.approx(156.14e6, rel=1e-3) and ops == pytest.approx(15.26e9, rel=1e-3)
    assert flops.least_time_s(nbytes, ops, "bf16") * 1e3 == pytest.approx(0.0466, rel=1e-3)
    nbytes, ops = flops.flash_bwd_work(128, 12, 197, 64, "bf16")
    assert nbytes == pytest.approx(311.1e6, rel=1e-3) and ops == pytest.approx(38.15e9, rel=1e-3)
    assert flops.least_time_s(nbytes, ops, "bf16") * 1e3 == pytest.approx(0.0929, rel=1e-3)


def test_k1_yuv_work_at_a_full_bucket():
    nbytes, ops = flops.k1_yuv_work(128, 224, 224, "bf16")
    assert nbytes == 128 * (75264 + 301056) and ops == 0
    assert flops.least_time_s(nbytes, ops, "bf16") * 1e3 == pytest.approx(0.0144, rel=1e-2)


def test_model_flops():
    assert flops.vit_macs_per_frame(VIT) == pytest.approx(17.57e9, rel=2e-3)
    assert flops.efficientnet_macs_per_frame(B0) == pytest.approx(0.39e9, rel=0.05)
    clip = flops.model_flops_per_clip(VIT, 8)
    assert clip == pytest.approx(8 * 2 * 17.57e9, rel=3e-3)
    assert flops.train_flops_per_frame(VIT, 16) == pytest.approx(3 * clip / 8, rel=1e-2)


def test_reference_shapes_count_the_published_parameters():
    params, buffers = R.detector_shapes(VIT)
    head = 768 * 64 + 64 + 64 + 1 + 768 * 256 + 256 + 256 * 2 + 2
    assert sum(math.prod(s) for _, s in params) == 85_798_656 + head
    params, buffers = R.detector_shapes(B0)
    body = sum(math.prod(s) for n, s in params if n.startswith("backbone."))
    assert body == 4_007_548          # timm efficientnet_b0 without its classifier
    assert len(buffers) == 2 * 49


def test_traffic_is_fixed_by_the_seed():
    a = traffic.yuv_clip_pool(2 ** 31 + 5, 4, 2, 16)
    assert np.array_equal(a, traffic.yuv_clip_pool(2 ** 31 + 5, 4, 2, 16))
    assert not np.array_equal(a, traffic.yuv_clip_pool(2 ** 31 + 6, 4, 2, 16))
    o = traffic.request_clips(7, 100, 8)
    assert np.array_equal(o, traffic.request_clips(7, 100, 8))
    assert sorted(o[:8]) == list(range(8))
    x, y = traffic.poisson_offsets(1, 500.0, 20.0), traffic.poisson_offsets(2, 500.0, 20.0)
    assert len(x) == len(y) == 10000 and not np.array_equal(x, y)
    assert np.allclose(np.sort(np.diff(x, prepend=0)), np.sort(np.diff(y, prepend=0)))
    assert x[-1] == pytest.approx(20.0, rel=0.02)
    f1, l1 = traffic.face_clips(3, 4, 2, 8)
    f2, _ = traffic.face_clips(3, 4, 2, 8)
    assert np.array_equal(f1, f2) and list(l1) == [0, 1, 0, 1]


def test_weights_are_fixed_by_the_seed():
    shapes = [("a.weight", (4, 8)), ("a.bias", (4,)), ("n.weight", (4,))]
    bufs = [("n.running_var", (4,))]
    s1, s2 = (weights.make_state(shapes, bufs, 9, "cpu") for _ in range(2))
    assert all(np.array_equal(s1[k].numpy(), s2[k].numpy()) for k in s1)
    assert float(s1["a.weight"].std()) == pytest.approx(1 / math.sqrt(8), rel=0.5)
    assert float(s1["n.weight"].mean()) == pytest.approx(1.0, abs=0.2)
    assert 0.5 <= float(s1["n.running_var"].min()) and float(s1["n.running_var"].max()) <= 1.5


def test_open_loop_accounting_counts_a_failed_request_as_missing():
    due = [0, 1, 2, 3]
    started = {0: (0, 10.0), 1: (0, 10.5), 2: (0, 11.0)}       # 3 never started
    done = {0: (10.02, (0.5, 0.5)), 1: (10.6, {"error": "boom"}),
            2: (12.5, (0.5, 0.5))}
    ok, lat, completed = serve.account(due, started, done, t_end=12.0)
    assert ok == [0, 2] and completed == 1
    assert lat[0] == pytest.approx(20.0) and lat[2] == pytest.approx(1500.0)
    assert math.isinf(lat[1]) and math.isinf(lat[3])
    assert traffic.nearest_rank(lat, 0.5) == pytest.approx(1500.0)
    assert math.isinf(traffic.nearest_rank(lat, 0.95))


def test_registry_finds_every_cell_and_metric_by_name():
    bench = registry.load_benchmark()
    for w in bench["workloads"]:
        cell = registry.cell(w["name"], bench)
        assert cell.config and cell.traffic["kind"] in ("serve", "train") and cell.limits
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
        assert all(m["moves"] in names for m in cell.per_layer)
    for m in bench["per_layer"]:
        assert callable(registry.reader(m["name"]))
    with pytest.raises(KeyError):
        registry.cell("no.such.cell", bench)


def test_a_cell_a_configuration_and_a_metric_are_added_by_files_alone(tiny_root):
    here = tiny_root / "bench_port"
    bench = registry.load_benchmark(tiny_root)
    (here / "configs" / "b0_wide.json").write_text((here / "configs" /
                                                     "efficientnet_b0.json").read_text())
    (here / "workloads" / "serve_small.json").write_text(
        (here / "workloads" / "serve_backlog.json").read_text())
    (here / "limits" / "b0_wide.serve.small.json").write_text('{"logodds_gap": 1.0}')
    (here / "metrics" / "clips_a_batch.small.py").write_text(
        "def read(run):\n    return run.items / run.batches\n")
    bench["configs"].append({"name": "b0_wide", "source": "https://arxiv.org/abs/1905.11946",
                             "file": "bench_port/configs/b0_wide.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "b0_wide.serve.small", "config": "b0_wide",
                               "traffic": "serve_small", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("b0_wide.serve.small")
    bench["per_layer"].append({"name": "clips_a_batch.small", "unit": "clips", "better":
                               "higher", "source": "program_counter", "layer": "micro-batcher",
                               "moves": "clips_per_s", "workloads": ["b0_wide.serve.small"]})
    cell = registry.cell("b0_wide.serve.small", bench, tiny_root)
    assert cell.config["backbone"] == "efficientnet_b0"
    assert [m["name"] for m in cell.per_layer] == ["clips_a_batch.small"]
    run = type("Run", (), {"items": 30, "batches": 3})()
    assert registry.reader("clips_a_batch.small", tiny_root)(run) == 10


def test_import_check_compares_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "deepfake_video_detection_tpu", "deepfake_video_detection_tpu.ops.attention",
             "deepfake_video_detection_tpu_torch", "deepfake_video_detection_tpu_torch.ops",
             "jaxtyping", "numpy"]
    assert guard.forbidden_modules(names) == [
        "deepfake_video_detection_tpu", "deepfake_video_detection_tpu.ops.attention",
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client"]


def test_trace_reader_ties_kernels_to_their_ranges():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench::window", "ts": 0, "dur": 1000,
         "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "bench::batch", "ts": 10, "dur": 500,
         "tid": 2},
        {"ph": "X", "cat": "user_annotation", "name": "bench::flash_fwd|2,3,4,64|bf16",
         "ts": 20, "dur": 30, "tid": 2},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 25, "dur": 2,
         "tid": 2, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 60, "dur": 2,
         "tid": 2, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "flash", "ts": 100, "dur": 40,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 130, "dur": 70,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "HtoD", "ts": 900, "dur": 200, "args": {}},
    ]
    s = tracing.summarize(ev, "bench::batch")
    assert s.window_s == pytest.approx(1e-3) and s.kernels == 2
    assert s.busy_s == pytest.approx((200 - 100 + 100) * 1e-6)
    (flash,) = s.named("bench::flash_fwd")
    assert flash.device_us == 40
    assert s.device_ops[0] == ["HtoD", pytest.approx(100e-6)]
    assert s.idle_gaps[0][1] == pytest.approx(700e-6)
