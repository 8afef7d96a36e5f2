"""The control of a cell's correctness check, and the training faults that
need a run: the reference put in the program's place, computed in the
precision below the one the configuration states (float8 e4m3 operands of
every product for bfloat16), at the cell's own sizes. Its numbers must fail
the cell's limits, judged by the harness's own comparison
(``check.compare``): it exits 1 where a control or a fault comes out
correct. Benchmark runs never run it.

    python3 bench_port/control.py --workload <cell> --seeds 1,2,3

Serving: the gap between the control's log-odds and the float32
reference's over every clip of the seed's pool. Training: the numbers of
the control's first three steps against the float32 reference's
on the same batches and draws, and the same for the fault "half of the
batch left out, the mean taken over the rest" planted in the reference.
One JSON line a seed, each reading with its ``correct`` and its
numbers beside their limits.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def serve_readings(cell, seed: int, device) -> dict:
    from bench_port import check, traffic
    from bench_port.reference import models as R

    c, m = cell.config, cell.traffic
    pool = traffic.yuv_clip_pool(seed, m["pool_clips"], m["frames"], m["face_size"])
    clips = list(range(m["pool_clips"]))
    ref = check.reference_logodds(c, seed, pool, clips, m["face_size"], device)
    low = check.reference_logodds(c, seed, pool, clips, m["face_size"], device, R.fp8_e4m3)
    return {"control": {"logodds_gap": max(abs(low[i] - ref[i]) for i in clips)},
            "reference_logodds_abs_max": max(abs(v) for v in ref.values())}


def train_readings(cell, seed: int, device) -> dict:
    import numpy as np

    from bench_port import check, traffic
    from bench_port.reference import models as R

    c, m = cell.config, cell.traffic
    faces, labels = traffic.face_clips(seed, m["clips"], m["frames"], m["face_size"])
    order = traffic.rng(seed, 7).permutation(m["clips"])
    B = m["batch_clips"]
    batches = [order[i * B:(i + 1) * B] for i in range(3)]
    gen_seed = int(traffic.rng(seed, 6).integers(0, 2 ** 31, size=2)[1])

    def steps(**kw):
        return check.reference_steps(c, seed, gen_seed, faces, labels, batches, m["lr"],
                                     device, **kw)

    ref = steps()
    out = {"control": steps(quant=R.fp8_e4m3),
           "half_batch": steps(rows=lambda n: np.arange(n // 2))}
    return {k: {n: v for n, v in check.training_numbers(r, ref).items()}
            for k, r in out.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[0] = str(ROOT)     # the checkout, not this folder
    from bench_port import registry

    cell = registry.cell(args.workload, registry.load_benchmark(ROOT), ROOT)
    fn = train_readings if cell.traffic["kind"] == "train" else serve_readings
    from bench_port import check

    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        got = fn(cell, seed, args.device)
        for kind in ("control", "half_batch"):
            if kind in got:
                ok, table = check.compare(got[kind], cell.limits)
                got[kind] = {"correct": ok, "checks": table, "readings": got[kind]}
                failed_all = failed_all and not ok
        print(json.dumps({"workload": args.workload, "seed": seed, **got}), flush=True)
    print("every control and fault came out not correct" if failed_all
          else "a control or fault came out correct", file=sys.stderr)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
