"""The passes layer's readers on the CPU: each reads its range's device span
per traced frame in ms, and nothing where the program has no such range."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from render_bench import cell
from render_bench.work import trace

BENCH = cell.benchmark()
# The ray-traced frame's ranges, in the order the program enters them.
SPANS = ["rt_primary", "rt_surface", "rt_sun_shadow", "pbr_lights", "rt_sky", "post_process"]


@pytest.mark.parametrize("span", SPANS)
def test_pass_reader_reads_its_range_per_frame(span):
    reader = cell.reader(f"{span}_device_ms")
    others = {s: 1.0 for s in SPANS if s != span} | {"bench.frame": 9.0}
    run = SimpleNamespace(trace={"frames": 12, "range_device_s": others | {span: 0.03}})
    assert reader.read(run) == pytest.approx(2.5)
    run.trace["range_device_s"] = others
    assert reader.read(run) is None


def test_pass_metrics_are_declared_for_the_ray_traced_cell():
    declared = {m["name"]: m for m in BENCH["per_layer"]}
    for span in SPANS:
        m = declared[f"{span}_device_ms"]
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
            "ms", "lower", "device_trace", "passes", "frame_ms")
        assert m["workloads"] == ["sponza_rt_1080p.fly"]


def _event(name, start, end, cuda=False, annotation=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
                           is_user_annotation=annotation)


def test_pass_readers_through_the_trace_reading():
    """Two made-up frames of the six ranges, each 10 us of host and device
    with a 2-us gap in its middle: the profiler's device copy of a user range
    is its span, not an op, and the gap inside a range is charged to it
    rather than to the frame."""
    events = []
    for f in range(2):
        t0 = 100.0 * f
        events.append(_event(trace.FRAME_RANGE, t0, t0 + 60, annotation=True))
        for i, span in enumerate(SPANS):
            s = t0 + 10 * i
            events.append(_event(span, s, s + 10, annotation=True))
            events.append(_event(span, s, s + 10, cuda=True, annotation=True))
            events.append(_event("kernel", s, s + 4, cuda=True))
            events.append(_event("kernel", s + 6, s + 10, cuda=True))
    events.append(_event(trace.SYNC_RANGE, 190.0, 200.0, annotation=True))
    run = SimpleNamespace(trace=trace.read(events, 2))
    assert run.trace["device_ops"] == 24
    for span in SPANS:
        assert cell.reader(f"{span}_device_ms").read(run) == pytest.approx(1e-2)
    gaps = dict(run.trace["idle_gaps"])
    assert gaps == {span: pytest.approx(4e-6) for span in SPANS} | {
        "bench.between": pytest.approx(80e-6)}
