"""Where the benchmark's parts live, and how they are found by name.

`BENCHMARK.json` at the root of the checkout names the cells; each cell's
traffic is `workloads/<cell>.json`, its model `configs/<config>.json`, its
loop `loops/<loop>.py` and each per-layer metric's reader
`metrics/<metric>.py`, all under this folder. Adding a cell, a
configuration, a loop kind or a metric adds files and edits none.

A loop module declares `TRAINING`, and a traced run asks a per-layer
metric's reader only where the two agree, never by the loop's name: a
metric named `<x>.train` in every loop that trains, any other in every
loop that does not (`trains`). A training loop of another objective
imports the train loop's parts (`loop("train")`) and replaces its step and
its reference loss (`loops/train.py`).
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
BENCHMARK_FILE = ROOT / "BENCHMARK.json"

# the layers a per-layer metric may name (PERF.md, section 3), from the
# loop's input down to the card; "solver" is the port's `ransac/`
LAYERS = ("data", "augmentation", "loss", "solver", "optimizer", "net convs", "norm", "device")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(BENCHMARK_FILE)


def workload(name: str) -> dict:
    return load_json(BENCH_DIR / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def workload_names() -> List[str]:
    """Every workload file's cell, those `BENCHMARK.json` does not name yet
    among them."""
    return sorted(p.stem for p in (BENCH_DIR / "workloads").glob("*.json"))


def trains(metric: str) -> bool:
    """Whether the per-layer metric `metric` is read in loops that train."""
    return metric.endswith(".train")


def _module(path: Path, tag: str) -> ModuleType:
    if not path.exists():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(f"perfbench_{tag}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop(kind: str) -> ModuleType:
    return _module(BENCH_DIR / "loops" / f"{kind}.py", "loop")


def metric_reader(name: str) -> ModuleType:
    return _module(BENCH_DIR / "metrics" / f"{name}.py", "metric")


class Cell:
    """One cell: its workload and configuration dicts, and the metric
    entries of `BENCHMARK.json` that it reports."""

    def __init__(self, name: str, workload: dict, config: dict, end_to_end: List[dict],
                 per_layer: List[dict], chips: int = 1):
        self.name = name
        self.workload = workload
        self.config = config
        self.end_to_end = end_to_end
        self.per_layer = per_layer
        self.chips = chips


def _reports(metric: dict, cell: str) -> bool:
    cells = metric.get("workloads")
    return cells is None or cell in cells


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell `name` of `BENCHMARK.json` (or of `bench`). A workload file
    that `BENCHMARK.json` does not name yet is a cell on one chip that
    reports only the metrics every cell reports; its checks and control
    readings work as any cell's."""
    bench = benchmark() if bench is None else bench
    entry: Dict = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None and not (BENCH_DIR / "workloads" / f"{name}.json").exists():
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")
    wl = workload(name)
    entry = entry or {"config": wl["config"], "chips": 1}
    cfg = config(entry["config"])
    return Cell(name, wl, cfg,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)],
                chips=int(entry["chips"]))
