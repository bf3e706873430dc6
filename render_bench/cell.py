"""Find a cell's files by the names BENCHMARK.json gives."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    with open(BENCH_DIR / "configs" / f"{name}.json") as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(BENCH_DIR / "traffic" / f"{name}.json") as f:
        return json.load(f)


def entry(name: str):
    """The module that drives one entry of the program (entries/<name>.py)."""
    return importlib.import_module(f"render_bench.entries.{name}")


def reader(metric: str):
    """The module that reads one metric (metrics/<name>.py; dots in a
    metric's name become underscores in its file's)."""
    return importlib.import_module(f"render_bench.metrics.{metric.replace('.', '_')}")


def metrics_for(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics (untraced run) or per-layer metrics
    (traced run): those whose ``workloads`` list the cell, or that have no
    such list."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]
