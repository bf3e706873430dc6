#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once and print its result line.

    python3 render_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (from the start of this script to the first timed frame): the
configuration's scene through the program's asset loader and scene build,
the entry's own set-up (pair caps tuned over the seed's path, the sun
cache, or the BVH), and WARM_FRAMES frames. The window: frames back to back
for ``--seconds``, at most IN_FLIGHT of them queued on the card; the clock
stops at a device synchronise after the last. With ``--trace 1`` a
profiled burst of TRACE_FRAMES more frames follows the window. Then the
peak memory is read, the program's state freed, and the frames the seed
picked from the window are held against the plain reference
(render_bench/check.py). The last line of standard output is the result;
the numbers compared, with their limits, end standard error.

Exits 2 without a result when the machine has fewer CUDA cards than the
cell asks for, and 3 when a module of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from contextlib import contextmanager  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

WARM_FRAMES = 4
IN_FLIGHT = 3
TRACE_FRAMES = 12
# Top-level module names that may not be loaded (JAX and the JAX package).
FORBIDDEN = ("jax", "jaxlib", "flax", "arctic_tpu")


class Run:
    """One run of a cell: its files, the program's state, and what the
    metric readers read."""

    def __init__(self, cfg, mix, seed, device, t0=T0):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.t0 = t0
        self.setup_parts: dict[str, float] = {}
        self.trace: dict | None = None

    @contextmanager
    def timed(self, name: str):
        """Host seconds of a set-up step, ending in a device synchronise."""
        t = time.perf_counter()
        yield
        _sync(self.device)
        self.setup_parts[name] = time.perf_counter() - t


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def set_up(run: Run):
    """Scene, path and the entry's frame function; ends after the warm-up."""
    from arctic_tpu_torch.io.build import build_buffers
    from render_bench import cell, scene, traffic

    entry = cell.entry(run.mix["entry"])
    if entry.MODE != run.cfg["mode"]:
        raise ValueError(f"entry {run.mix['entry']} renders {entry.MODE} frames, "
                         f"{run.cfg['name']} is {run.cfg['mode']}")
    with run.timed("scene_build_s"):
        run.bufs = build_buffers(*scene.load(run.cfg), device=run.device)
    run.path = traffic.path(run.cfg, run.mix, run.seed)
    frame = entry.setup(run)
    for k in range(WARM_FRAMES):
        frame(traffic.frame(run.path, run.mix, k))
    _sync(run.device)
    run.setup_s = time.perf_counter() - run.t0
    return frame


def window(run: Run, frame, seconds: float) -> None:
    """The timed window: frames back to back with at most IN_FLIGHT queued,
    the stats of each, and a seed-drawn reservoir of the frames to check."""
    import torch

    from render_bench import check, traffic

    cuda = run.device.type == "cuda"

    def mark():
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    keep = check.FRAMES
    pick = traffic.rng(run.seed, 1)
    run.kept, run.stats, run.host_ms, marks = {}, [], [], []
    start = mark()
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds:
        if cuda and k >= IN_FLIGHT:
            marks[k - IN_FLIGHT].synchronize()
        spec = traffic.frame(run.path, run.mix, WARM_FRAMES + k)
        t = time.perf_counter()
        img, stats = frame(spec)
        run.host_ms.append((time.perf_counter() - t) * 1e3)
        marks.append(mark())
        run.stats.append(stats)
        slot = k if k < keep else int(pick.integers(k + 1))
        if slot < keep:
            run.kept[slot] = (k, img, spec)
        k += 1
    _sync(run.device)
    run.window_s = time.perf_counter() - t0
    run.n_frames = k
    if cuda:
        run.intervals_ms = [a.elapsed_time(b) for a, b in zip([start] + marks[:-1], marks)]
    else:
        run.intervals_ms = [(b - a) * 1e3 for a, b in zip([start] + marks[:-1], marks)]
    run.next_frame = WARM_FRAMES + k


def over_cap(stats_list) -> int:
    """Frames whose pair, penumbra-row or fallback-row count passed its
    buffer's capacity (the program's check_stats)."""
    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.utils.errors import RenderError

    bad = 0
    for st in stats_list:
        if st is None:
            continue
        try:
            pipeline.check_stats(st)
        except RenderError:
            bad += 1
    return bad


def run_cell(run: Run, seconds: float, traced: bool, metrics: list[dict]) -> dict:
    """Set-up, window, trace, check; the result line's dict."""
    import torch

    from render_bench import cell, check, traffic
    from render_bench.work import trace

    frame = set_up(run)
    window(run, frame, seconds)
    if traced:
        specs = [traffic.frame(run.path, run.mix, run.next_frame + i) for i in range(TRACE_FRAMES)]
        run.trace = trace.burst(frame, specs)
    cuda = run.device.type == "cuda"
    run.peak_bytes = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    failed = over_cap(run.stats)
    kept = [run.kept[s] for s in sorted(run.kept, key=lambda s: run.kept[s][0])]
    del frame, run.bufs, run.stats, run.kept
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = check.check(kept, run.cfg, run.seed, run.device)
    print(f"render_bench: checked {len(kept)} frames against the reference in "
          f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
    numbers["over_cap_frames"] = {"value": failed, "max": 0}
    correct = all(check.holds(v) for v in numbers.values())
    values = {}
    for m in metrics:
        v = cell.reader(m["name"]).read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": run.peak_bytes}
    out = {"correct": correct, "attempted": run.n_frames, "failed": failed,
           "metrics": values, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["top_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = numbers
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Build and kernel caches stay inside the checkout, at fixed paths.
    cache = ROOT / "build" / "render_bench" / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    from render_bench import cell

    bench = cell.benchmark()
    w = cell.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"render_bench: {args.workload} needs {w['chips']} CUDA card(s), found {have}",
              file=sys.stderr)
        return 2
    run = Run(cell.config(w["config"]), cell.traffic(w["traffic"]), args.seed,
              torch.device("cuda", 0))
    out = run_cell(run, args.seconds, bool(args.trace),
                   cell.metrics_for(bench, args.workload, bool(args.trace)))
    found = forbidden_modules()
    if found:
        print(f"render_bench: loaded modules of {', '.join(found)}", file=sys.stderr)
        return 3
    for name, v in out["checks"].items():
        print(f"check {name}: {json.dumps(v)}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
