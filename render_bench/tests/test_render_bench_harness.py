"""The harness on the CPU: files found by name, the traffic from the seed,
the work counts of the rooflines, the trace reading, the import guard and
the last line of a run."""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest

from render_bench import cell, traffic
from render_bench import run as harness
from render_bench.tests.small import one_torch_thread, small_assets, small_cell  # noqa: F401
from render_bench.work import bvh_trace, raster_tiles, trace

BENCH = cell.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    w = cell.workload(BENCH, name)
    cfg = cell.config(w["config"])
    mix = cell.traffic(w["traffic"])
    assert cfg["name"] == w["config"]
    assert cell.entry(mix["entry"]).MODE == cfg["mode"]
    for traced in (False, True):
        for m in cell.metrics_for(BENCH, name, traced):
            assert callable(cell.reader(m["name"]).read)


def test_a_new_file_is_found_with_no_edit(tmp_path, monkeypatch):
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "configs" / "new_cfg.json").write_text(json.dumps({"name": "new_cfg"}))
    (tmp_path / "traffic" / "new_mix.json").write_text(json.dumps({"entry": "rt"}))
    monkeypatch.setattr(cell, "BENCH_DIR", tmp_path)
    assert cell.config("new_cfg") == {"name": "new_cfg"}
    assert cell.traffic("new_mix") == {"entry": "rt"}
    readers = tmp_path / "readers"
    readers.mkdir()
    (readers / "new_metric_x.py").write_text("def read(run):\n    return 7.0\n")
    import render_bench.metrics

    monkeypatch.setattr(render_bench.metrics, "__path__",
                        [*render_bench.metrics.__path__, str(readers)])
    assert cell.reader("new_metric.x").read(None) == 7.0
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["other"]}],
             "per_layer": [{"name": "c", "workloads": ["x", "y"]}]}
    assert [m["name"] for m in cell.metrics_for(bench, "x", False)] == ["a"]
    assert [m["name"] for m in cell.metrics_for(bench, "x", True)] == ["c"]


def test_every_cell_reports_its_metrics():
    for name in CELLS:
        e2e = {m["name"] for m in cell.metrics_for(BENCH, name, False)}
        assert {"frame_ms", "frame_ms_p95", "peak_mem_gib", "setup_s"} <= e2e
        assert cell.metrics_for(BENCH, name, True)
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("mix_name", ["sun_moving", "sun_static", "fly", "light_shadows"])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_traffic_is_repeatable_and_in_the_hall(mix_name, seed):
    cfg, mix = cell.config("sponza_rt_1080p"), cell.traffic(mix_name)
    a, b = traffic.path(cfg, mix, seed), traffic.path(cfg, mix, seed)
    assert a == b
    frames = [traffic.frame(a, mix, k) for k in range(3 * traffic.cycle(mix))]
    for f0, f1 in zip(frames, frames[1:]):
        assert f0["camera"]["eye"] != f1["camera"]["eye"]
    for f in frames:
        x, y, z = f["camera"]["eye"]
        assert -18.0 < x < 18.0 and abs(z) < 7.0 and y == pytest.approx(4.5)
        assert -10.0 <= f["camera"]["rotation"][1] <= 10.0
    suns = {tuple(f["sun"]["rotation"]) for f in frames}
    assert (len(suns) == 1) == (mix["sun_step"] == 0)


def test_every_seed_renders_the_same_stops():
    """A seed moves the start in the cycle and shifts the path by a fraction
    of a step: the set of stops is the same work for every seed."""
    cfg, mix = cell.config("sponza_rt_1080p"), cell.traffic("sun_moving")
    paths = [traffic.path(cfg, mix, s) for s in (1, 2, 3, 2**33)]
    assert len({p["phase"] for p in paths}) > 1
    for p in paths:
        xs = [s["camera"]["eye"][0] for s in p["stops"]]
        assert xs[0] == pytest.approx(mix["start"][0] + p["frac"] * mix["step"][0], abs=1e-5)
        assert np.allclose(np.diff(xs), mix["step"][0], atol=1e-5)
    k = [traffic.stop_of(i, mix) for i in range(2 * traffic.cycle(mix))]
    assert sorted(set(k)) == list(range(mix["viewpoints"]))


def test_raster_work_by_hand():
    cfg = {"scene": {"triangles": 10}, "shadow_size": 8, "resolution": [6, 4]}
    shadow = 8 * 8 * 4 + 10 * 48
    camera = 6 * 4 * (4 + 4) + 10 * 48
    assert raster_tiles.frame_bytes(("shadow", "camera"), cfg) == shadow + camera
    assert raster_tiles.frame_bytes(("camera",), cfg) == camera


def test_bvh_work_by_hand():
    cfg = {"scene": {"triangles": 10}, "resolution": [6, 4], "static_point_lights": 4}
    assert bvh_trace.frame_bytes(cfg, {}) == 2 * 24 * 44 + 10 * 48
    assert bvh_trace.frame_bytes(cfg, {"light_shadows": True}) == 6 * 24 * 44 + 10 * 48


def test_trace_union_and_idle_gaps():
    busy = trace._union(np.array([[5.0, 10.0], [0.0, 2.0], [8.0, 12.0], [20.0, 21.0]]))
    assert busy.tolist() == [[0.0, 2.0], [5.0, 12.0], [20.0, 21.0]]
    ranges = [(0.0, 30.0, "bench.frame"), (1.0, 14.0, "shadow_pass"), (3.0, 4.0, "pcf_shadow")]
    gaps = dict(trace.idle_gaps(busy, 0.0, 30.0, ranges))
    # Gaps 2-5 (middle 3.5: pcf_shadow), 12-20 (16: bench.frame), 21-30 (bench.frame).
    assert gaps == {"pcf_shadow": pytest.approx(3e-6), "bench.frame": pytest.approx(17e-6)}


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "arctic_tpu_torch_like", object())
    monkeypatch.setitem(sys.modules, "arctic_tpu_torch.models.fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "arctic_tpu.models", object())
    assert harness.forbidden_modules() == ["arctic_tpu"]
    monkeypatch.setitem(sys.modules, "jax", object())
    assert harness.forbidden_modules() == ["arctic_tpu", "jax"]


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(var, "unset")
    assert harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs 1 CUDA card" in out.err


@pytest.mark.parametrize("kind", ["sun_moving", "sun_static", "fly", "light_shadows"])
def test_a_run_prints_the_contract_line(kind, small_cell):
    _, run_small = small_cell
    out = run_small(kind)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 2
    assert {"frame_ms", "frame_ms_p95", "setup_s"} <= set(out["metrics"])
    assert out["checks"]["checked_frames"]["value"] == 2
    assert out["checks"]["far_px_share"]["value"] <= out["checks"]["far_px_share"]["max"]
    json.dumps(out)
