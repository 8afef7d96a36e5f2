"""Run one cell of the port's benchmark and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. Set-up (imports,
the CUDA context, the kernels' build into ``build/torch_kernels/``, weights
from the seed on the card, the cell's own warm-up) is ``setup_s``; then the
window measures for ``--seconds``; then the outputs of the timed path are
judged against the plain reference (``check.py``). With ``--trace 1`` a part
of the window runs under ``torch.profiler`` and the line carries the cell's
per-layer metrics, ``busy_s``, ``window_s`` and a breakdown, in place of its
end-to-end metrics.

The last lines on standard error, and the ``checks`` key that ends the
result line, give each number compared beside its limit. The run exits 2,
with no result, without CUDA or with fewer cards than the cell asks for, and
3 if anything of JAX or of the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches(root: Path) -> None:
    """Every kernel cache inside the checkout, at fixed paths (the port's
    own nvcc builds go to ``build/torch_kernels/`` there already); no
    library loads JAX on its own."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def end_to_end(cell, out) -> dict:
    """The cell's end-to-end metrics other than ``setup_s``, from the window."""
    from bench_port.traffic import nearest_rank

    values = {"clips_per_s": lambda: out.completed / out.window_s,
              "latency_p95_ms": lambda: nearest_rank(out.latencies_ms, 0.95),
              "train_frames_per_s": lambda: out.frames / out.window_s}
    return {m["name"]: values[m["name"]]() for m in cell.end_to_end if m["name"] != "setup_s"}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: Path = ROOT, bench=None, t_start: float = None):
    """One run; returns (result dict, stderr lines). ``device`` and
    ``bench`` let the CPU tests drive a run without a card."""
    from bench_port import check, registry, serve, train

    bench = registry.load_benchmark(root) if bench is None else bench
    cell = registry.cell(name, bench, root)
    driver = {"serve": serve, "train": train}[cell.traffic["kind"]]
    out = driver.run(cell, seed, seconds, trace, device)
    setup_s = out.setup_done - (T_START if t_start is None else t_start)
    correct, checks = check.compare(out.numbers, cell.limits)
    correct = correct and out.failed == 0 and out.checked > 0
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = registry.reader(m["name"], root)(out)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {k: {"value": v, "unit": u["unit"]} for u in cell.end_to_end
                   for k, v in end_to_end(cell, out).items() if k == u["name"]}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    if any(not math.isfinite(v["value"]) for v in metrics.values()):
        correct = False
        metrics = {k: v if math.isfinite(v["value"]) else {"value": 1e12, "unit": v["unit"]}
                   for k, v in metrics.items()}
    result = {"correct": bool(correct), "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": {}}
    lines = []
    if trace and getattr(out, "trace", None) is not None:
        result["device"].update(busy_s=out.trace.busy_s, window_s=out.trace.window_s)
        result["breakdown"] = {"device_ops": out.trace.device_ops,
                               "idle_gaps": out.trace.idle_gaps}
    if getattr(out, "lateness_ms", None):
        late = sorted(out.lateness_ms)
        lines.append(f"generator lateness ms: median {late[len(late) // 2]}, "
                     f"p99 {late[int(0.99 * (len(late) - 1))]}, max {late[-1]}")
    t0 = T_START if t_start is None else t_start
    lines.append("set-up phases (s from the start): " + json.dumps(
        {k: round(v - t0, 3) for k, v in out.phases.items()}))
    if getattr(out, "trace_overhead", None):
        lines.append(f"traced window: {out.trace_overhead}")
    if getattr(out, "backlog", None):
        lines.append(f"backlog: {json.dumps(out.backlog)}")
    lines.append(f"window: attempted {out.attempted}, failed {out.failed}, "
                 f"checked {out.checked}; other readings "
                 + json.dumps({k: v for k, v in out.numbers.items() if k not in checks}))
    lines += [f"check {k}: {v['value']} (limit {v['limit']})" for k, v in checks.items()]
    result["memory_peak_bytes"] = out.memory_peak_bytes
    result["checks"] = checks
    return result, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path[0] = str(ROOT)     # the checkout, not this folder
    _caches(ROOT)
    from bench_port import guard, registry

    bench = registry.load_benchmark(ROOT)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        raise SystemExit(f"bench_port: no workload {args.workload!r}")
    guard.require_cards(chips)
    import torch

    card = guard.card_description()
    print(f"card: {card}", flush=True)
    print(f"card: {card}", file=sys.stderr, flush=True)
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             bench=bench)
    found = guard.forbidden_modules()
    if found:
        print(f"bench_port: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    peak = result.pop("memory_peak_bytes")
    checks = result.pop("checks")
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                        "count": chips, "memory_peak_bytes": int(peak), **result["device"]}
    result["checks"] = checks
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
