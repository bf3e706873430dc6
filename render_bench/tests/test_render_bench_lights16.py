"""The lights16 cell's readers on the CPU: the cell loads through cell.py,
its three metrics are declared for it alone and five accepted ones list it
beside the ray-traced cell, and each of the three reads its range or
kernel off a made-up raster trace, and nothing where the program has no
such range or kernel (the parent's raster frame has neither)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from render_bench import cell
from render_bench.tests.test_render_bench_passes import _event
from render_bench.work import trace

BENCH = cell.benchmark()
# The raster frame's ranges of the lights16 cell: pcf_shadow, then
# forward_shade_skybox holding pbr_lights (K15 alone) and sky_composite.
RASTER_CELL = "sponza_1080p.lights16"
RASTER_METRICS = ("raster_lights_device_ms", "sky_composite_device_ms", "shade_lights_roofline")
# Accepted metrics whose layers the cell runs, which list it too.
SHARED_METRICS = ("host_ms_per_frame", "host_syncs_per_frame", "device_idle_share",
                  "device_ops_per_frame", "scene_build_s")


def test_raster_metrics_are_declared_for_the_lights16_cell():
    declared = {m["name"]: m for m in BENCH["per_layer"]}
    for name, unit, better, layer in zip(RASTER_METRICS, ("ms", "ms", "%"),
                                         ("lower", "lower", "higher"),
                                         ("passes", "passes", "kernels")):
        m = declared[name]
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
            unit, better, "device_trace", layer, "frame_ms")
        assert m["workloads"] == [RASTER_CELL]
    for name in SHARED_METRICS:
        assert declared[name]["workloads"] == ["sponza_rt_1080p.fly", RASTER_CELL]
    traced = {m["name"] for m in cell.metrics_for(BENCH, RASTER_CELL, True)}
    assert traced == set(RASTER_METRICS) | set(SHARED_METRICS)


def test_raster_readers_of_the_lights16_cell_through_the_trace_reading():
    """Two made-up raster frames of the lights16 cell, loaded through
    cell.py: K15 runs 20 us in pbr_lights, the composite 30 us in
    sky_composite; each reader reads its range or kernel per frame, and the
    roofline is K15's byte floor (60 B a pixel at 1920 x 1080) over it."""
    from render_bench.work import HBM_BYTES_PER_S

    w = cell.workload(BENCH, RASTER_CELL)
    cfg, mix = cell.config(w["config"]), cell.traffic(w["traffic"])
    assert (cfg["mode"], mix["entry"], cfg["static_point_lights"]) == ("raster", "raster_cached", 16)
    events = []
    for f in range(2):
        t0 = 1000.0 * f
        events.append(_event(trace.FRAME_RANGE, t0, t0 + 500, annotation=True))
        events.append(_event("forward_shade_skybox", t0 + 100, t0 + 400, annotation=True))
        for name, s, e, kernel in (("pcf_shadow", 10, 90, "pcf"),
                                   ("pbr_lights", 200, 250, "shade_lights_kernel"),
                                   ("sky_composite", 250, 300, "where_kernel")):
            events.append(_event(name, t0 + s, t0 + e, annotation=True))
            events.append(_event(name, t0 + s, t0 + e, cuda=True, annotation=True))
            events.append(_event(kernel, t0 + s + 5, t0 + s + 5 + (e - s) * 0.4 + 10 * (
                name == "sky_composite"), cuda=True))
    events.append(_event(trace.SYNC_RANGE, 1900.0, 2000.0, annotation=True))
    run = SimpleNamespace(trace=trace.read(events, 2), cfg=cfg, mix=mix)
    read = {m: cell.reader(m).read(run) for m in RASTER_METRICS}
    assert read["raster_lights_device_ms"] == pytest.approx(50e-3)
    assert read["sky_composite_device_ms"] == pytest.approx(50e-3)
    floor_s = 1920 * 1080 * 60 / HBM_BYTES_PER_S
    assert read["shade_lights_roofline"] == pytest.approx(100 * floor_s / 20e-6)
    run.trace["kernel_s"].pop("shade_lights_kernel")
    del run.trace["range_device_s"]["sky_composite"]
    assert cell.reader("shade_lights_roofline").read(run) is None
    assert cell.reader("sky_composite_device_ms").read(run) is None
