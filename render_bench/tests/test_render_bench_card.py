"""The benchmark on the card: a traced run of each cell reports the
per-layer metrics BENCHMARK.json lists for it. Skips without a CUDA card;
on the card: ``python -m pytest render_bench/tests -m cuda -p no:cacheprovider``."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from render_bench import cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = cell.benchmark()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_traced_run_reports_its_layers(name, card):
    out = subprocess.run(
        [sys.executable, "render_bench/run.py", "--workload", name, "--seed", "99",
         "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    want = {m["name"] for m in cell.metrics_for(BENCH, name, True)}
    assert set(line["metrics"]) == want
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert len(line["breakdown"]["device_ops"]) <= 10
