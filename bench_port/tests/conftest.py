"""Fixtures of the benchmark's CPU tests: a checkout-shaped folder holding
the benchmark at a size a CPU runs in seconds (ViT-Tiny in place of
ViT-B/16, 2-frame clips, a few clients), which ``run.run_cell`` drives with
``device="cpu"``."""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "bench_port"


def _load(path: Path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture
def tiny_root(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    here = root / "bench_port"
    for sub in ("configs", "workloads", "limits"):
        (here / sub).mkdir(parents=True)
    shutil.copytree(BENCH / "metrics", here / "metrics")
    bench = _load(REPO / "BENCHMARK.json")
    vit = _load(BENCH / "configs" / "vit_b16.json")
    vit.update(backbone="vit_tiny_patch16_224", hidden_size=192, num_attention_heads=3,
               intermediate_size=768)
    (here / "configs" / "vit_b16.json").write_text(json.dumps(vit))
    shutil.copy(BENCH / "configs" / "efficientnet_b0.json", here / "configs")
    for path in (BENCH / "workloads").glob("*.json"):
        mix = _load(path)
        if mix["kind"] == "train":
            mix.update(clips=8, entries_per_clip=2, frames=2, batch_clips=2, warm_steps=4, trace_seconds=0.5)
        else:
            mix.update(frames=2, pool_clips=8, check_requests=8, trace_seconds=0.5)
            if mix["loop"] == "closed":
                mix.update(clients=4, warm_requests_per_client=1)
            else:
                mix.update(rate_per_s=20, workers=8, warm_seconds=0.2)
        (here / "workloads" / path.name).write_text(json.dumps(mix))
    for path in (BENCH / "limits").glob("*.json"):
        shutil.copy(path, here / "limits")
    # the open loop and EfficientNet-B0, which no cell of BENCHMARK.json
    # runs yet (PERF.md §7), as cells of this folder alone
    bench["configs"].append({"name": "efficientnet_b0", "source": "https://arxiv.org/abs/1905.11946",
                             "file": "bench_port/configs/efficientnet_b0.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "efficientnet_b0.serve.backlog",
                               "config": "efficientnet_b0", "traffic": "serve_backlog",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "vit_b16.serve.backlog" in m.get("workloads", []):
            m["workloads"].append("efficientnet_b0.serve.backlog")
    bench["workloads"].append({"name": "vit_b16.serve.interactive", "config": "vit_b16",
                               "traffic": "serve_interactive", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "latency_p95_ms", "unit": "ms", "better": "lower",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["vit_b16.serve.interactive"]})
    shutil.copy(BENCH / "limits" / "vit_b16.serve.backlog.json",
                here / "limits" / "vit_b16.serve.interactive.json")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
