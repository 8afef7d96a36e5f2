"""Find the highest rate an open-loop serving cell sustains: its traffic at
each of several rates, one window each, in one process on the card.

    python3 bench_port/sweep.py --config vit_b16 --traffic serve_interactive \\
        --rates 500,600,700 --seconds 10 --seed 1

One JSON line a rate: latency percentiles over every request due in the
window (from its due time), the requests not finished when the window
closed, the median latency of the first and the last tenth of the requests
(a backlog that grows shows as the last above the first), and how late the
generator ran. The knee is the highest rate whose backlog does not grow;
the cell's file takes four fifths of the lower knee of two sweeps.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True, help="a configuration of BENCHMARK.json")
    p.add_argument("--traffic", required=True, help="an open-loop mix in workloads/")
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    sys.path[0] = str(ROOT)     # the checkout, not this folder
    from bench_port import registry, serve
    from bench_port.run import _caches
    from bench_port.traffic import nearest_rank

    _caches(ROOT)
    entry = {c["name"]: c for c in registry.load_benchmark(ROOT)["configs"]}[args.config]
    cell = registry.Cell(
        name=f"{args.config}.{args.traffic}", config_name=args.config,
        config=registry.load_json(ROOT / entry["file"]), traffic_name=args.traffic,
        traffic=registry.load_json(registry.HERE / "workloads" / f"{args.traffic}.json"),
        limits={}, chips=1, end_to_end=[], per_layer=[])
    for rate in (float(r) for r in args.rates.split(",")):
        cell.traffic = dict(cell.traffic, rate_per_s=rate)
        out = serve.run(cell, args.seed, args.seconds, False)
        lat, late = out.latencies_ms, sorted(out.lateness_ms)
        print(json.dumps({"rate_per_s": rate, "requests": len(lat), "failed": out.failed,
                          "p50_ms": nearest_rank(lat, 0.5), "p95_ms": nearest_rank(lat, 0.95),
                          "p99_ms": nearest_rank(lat, 0.99), **out.backlog,
                          "batch_fill": out.items / max(out.batches, 1),
                          "generator_late_ms_p99": late[int(0.99 * (len(late) - 1))],
                          "numbers": out.numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
