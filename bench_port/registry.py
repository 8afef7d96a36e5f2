"""Find a cell's parts by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic mix (``workloads/<traffic>.json``), the
limits of its correctness check (``limits/<cell>.json``) and a reader for
each of its metrics (``metrics/<metric>.py``). A cell, a configuration, a
traffic mix or a per-layer metric is added by adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config_name: str
    config: Dict          # the configuration file as it is run
    traffic_name: str
    traffic: Dict         # the traffic mix's parameters
    limits: Dict          # {number: limit} of the correctness check
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, bench: Dict, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench``; KeyError if there is none."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def here(m: Dict) -> bool:
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if here(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(name=name, config_name=w["config"], config=load_json(root / entry["file"]),
                traffic_name=w["traffic"],
                traffic=load_json(root / HERE.name / "workloads" / f"{w['traffic']}.json"),
                limits=load_json(root / HERE.name / "limits" / f"{name}.json"),
                chips=int(w["chips"]),
                end_to_end=e2e, per_layer=per_layer)


def reader(metric: str, root: Path = ROOT) -> Callable:
    """``read(run)`` of ``metrics/<metric>.py``: the metric's value from a
    finished run, or None where the run has nothing to read."""
    path = root / HERE.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
