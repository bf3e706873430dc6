#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (arctic_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. device check: refuses to run without CUDA (no CPU fallback); prints the
   card's name and power limit as nvidia-smi reports them;
2. kernel build: compiles csrc/*.cu with nvcc (sm_90a, -fmad=false);
3. entry frame: Cornell at 256x192 with a 256^2 shadow map through the
   port's renderer on the card. All four kernels must launch; the frame must
   be within 1 u8 LSB of the port's CPU frame (plain torch versions) on < 1%
   of the pixels and >= 40 dB PSNR against the f64 golden oracle;
   check_stats must pass;
4. real size: the Sponza-class scene (251,500 tris) at 1920x1080 with a
   4000^2 shadow map, ACES, 4 static point lights, the bench viewpoint and
   light rig; 5 fly-through frames, each passing check_stats and not black.
   Launch counts are zeroed right before these frames and read right after;
5. kernels against their plain torch versions on the card, on the exact
   inputs the entry and real-size frames gave them (recorded): bit-exact
   equality, and CUDA-event times of kernel and plain version at the
   real-size shapes.

The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Frames are saved under build/chip_smoke/ as .npy.
``--profile`` adds a torch.profiler pass over two real-size frames (busy
share, per-pass device time, top kernels; these lines, the profiler's table
and a trace in build/chip_smoke/).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ENTRY = dict(width=256, height=192, shadow=256, eye=[0.0, 4.0, 3.0], rot=[-25.0, -90.0])
REAL = dict(width=1920, height=1080, shadow=4000)
# bench.py:192-222 — the bench viewpoint and light rig, written out here.
REAL_EYE, REAL_ROT = [-14.0, 4.5, 0.0], [-8.0, 0.0]
REAL_SUN = dict(position=[0.0, 24.0, 0.0], rotation=[-65.0, 30.0])
REAL_LIGHTS = [
    ((-6.0, 3.0, -4.0), (30.0, 20.0, 8.0)),
    ((0.0, 3.0, 4.0), (30.0, 20.0, 8.0)),
    ((6.0, 3.0, -4.0), (8.0, 20.0, 30.0)),
    ((12.0, 3.0, 4.0), (30.0, 8.0, 8.0)),
]
FLY_FRAMES = 5
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")


def log(msg: str) -> None:
    print(msg, flush=True)


def entry_scene(device):
    from arctic_tpu_torch.core.config import RenderConfig
    from arctic_tpu_torch.core.scene import default_scene_params, default_settings, make_camera
    from arctic_tpu_torch.io.build import build_buffers
    from arctic_tpu_torch.io.procedural import cornell_like_scene

    w, h, s = ENTRY["width"], ENTRY["height"], ENTRY["shadow"]
    config = RenderConfig(width=w, height=h, shadow_size=s)
    scene = cornell_like_scene()
    bufs = build_buffers(*scene, tri_bucket=256, device=device)
    params = default_scene_params(aspect=w / h)
    params.camera = make_camera(ENTRY["eye"], ENTRY["rot"], w / h)
    return config, scene, bufs, params, default_settings()


def golden_frame(scene, params, settings, config):
    import numpy as np

    from arctic_tpu_torch.models import golden

    meshes, objects, materials, env = scene
    cam = params.camera
    tris, mats = golden.golden_scene(meshes, objects, materials)
    n = params.point_lights.count
    lights = [
        (params.point_lights.position[i].tolist(), params.point_lights.color[i].tolist())
        for i in range(n)
    ]
    return golden.render(
        tris, mats, env.astype(np.float64),
        dict(eye=cam.eye.tolist(), rotation=cam.rotation.tolist(), aspect=float(cam.aspect),
             fov_y=float(cam.fov_y), z_near=float(cam.z_near), z_far=float(cam.z_far)),
        dict(position=params.sun.position.tolist(), rotation=params.sun.rotation.tolist(),
             color=params.sun.color.tolist()),
        lights, ambient=float(params.ambient),
        settings=dict(tm_method=settings.tm_method, gamma=float(settings.gamma),
                      exposure=float(settings.exposure)),
        width=config.width, height=config.height, shadow_size=config.shadow_size,
    )


def run_entry(device):
    """Entry frame on ``device``; returns (img, recorded kernel calls)."""
    import numpy as np
    import torch

    from arctic_tpu_torch.models import golden, pipeline
    from arctic_tpu_torch.utils import kernels

    config, scene, bufs, params, settings = entry_scene(device)
    kernels.reset_launch_counts()
    with kernels.record_calls() as calls:
        img, stats = pipeline.render_frame_stats(bufs, params, settings, config)
        if img.is_cuda:
            torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"entry frame launches: {counts}")
    if img.is_cuda and min(counts.values()) < 1:
        raise RuntimeError(f"entry frame did not launch every kernel: {counts}")
    pipeline.check_stats(stats)
    img = img.cpu().numpy()

    cpu_bufs = entry_scene("cpu")[2]
    img_cpu, stats_cpu = pipeline.render_frame_stats(cpu_bufs, params, settings, config)
    img_cpu = img_cpu.numpy()
    diff = np.abs(img.astype(np.int32) - img_cpu.astype(np.int32))
    frac = float((diff > 0).mean())
    log(f"entry frame vs port CPU frame: max {diff.max()} LSB on {frac:.4%} of pixels")
    if diff.max() > 1 or frac >= 0.01:
        raise RuntimeError("entry frame differs from the CPU frame beyond 1 LSB / 1%")
    s_dev = {k: int(v) for k, v in stats.items()}
    s_cpu = {k: int(v) for k, v in stats_cpu.items()}
    log(f"entry stats: {s_dev}")
    if s_dev != s_cpu:
        raise RuntimeError(f"entry stats differ from the CPU run: {s_cpu}")
    db = golden.psnr(img, golden_frame(scene, params, settings, config))
    log(f"entry frame PSNR vs f64 golden oracle: {db:.2f} dB")
    if db < 40.0:
        raise RuntimeError(f"entry frame PSNR {db:.2f} dB < 40 dB")
    os.makedirs(OUT_DIR, exist_ok=True)
    np.save(os.path.join(OUT_DIR, "chip_smoke_entry.npy"), img)
    return img, calls


def real_params(i: int):
    import torch

    from arctic_tpu_torch.core.scene import (
        TM_ACES, PointLights, Settings, default_scene_params, make_camera,
    )

    def _f32(x):
        return torch.tensor(x, dtype=torch.float32)

    w, h = REAL["width"], REAL["height"]
    params = default_scene_params(aspect=w / h)
    params.camera = make_camera(
        [REAL_EYE[0] + 0.25 * i, REAL_EYE[1], REAL_EYE[2]], [REAL_ROT[0], 0.3 * i], w / h
    )  # bench.py:225-241 fly-through step i
    params.sun.position = _f32(REAL_SUN["position"])
    params.sun.rotation = _f32(REAL_SUN["rotation"])
    params.point_lights = PointLights.from_list(REAL_LIGHTS)
    return params, Settings(tm_method=TM_ACES, gamma=_f32(2.2), exposure=_f32(1.0))


def run_real(device, profile: bool = False):
    """Real-size fly-through; returns (summary dict, recorded kernel calls,
    launch counts of the timed frames)."""
    import numpy as np
    import torch

    from arctic_tpu_torch.core.config import RenderConfig
    from arctic_tpu_torch.io.build import build_buffers
    from arctic_tpu_torch.io.procedural import sponza_like_scene
    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.utils import kernels

    config = RenderConfig(
        width=REAL["width"], height=REAL["height"], shadow_size=REAL["shadow"],
        static_point_lights=4,
    )
    t0 = time.perf_counter()
    bufs = build_buffers(*sponza_like_scene(), device=device)
    torch.cuda.synchronize()
    log(f"real-size scene build: {bufs.geometry.num_tris} tris, capacity "
        f"{bufs.geometry.capacity}, {time.perf_counter() - t0:.1f} s")
    render = pipeline.make_renderer_stats(config, device)

    params, settings = real_params(0)
    with kernels.record_calls() as calls:  # warm-up frame; its inputs feed phase 5
        img, stats = render(bufs, params, settings)
        torch.cuda.synchronize()
    pipeline.check_stats(stats)

    frames = [real_params(i) for i in range(FLY_FRAMES)]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times, all_stats = [], []
    for params, settings in frames:
        t = time.perf_counter()
        img, stats = render(bufs, params, settings)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        all_stats.append(stats)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"real-size launches over {FLY_FRAMES} frames: {counts}")
    if min(counts.values()) < 1:
        raise RuntimeError(f"real-size frames did not launch every kernel: {counts}")
    for st in all_stats:
        pipeline.check_stats(st)
    s = {k: int(v) for k, v in all_stats[-1].items()}
    if profile:
        profile_frames(render, bufs, frames[:2])
    frame = img.cpu().numpy()
    if frame.shape != (REAL["height"], REAL["width"], 3) or frame.mean() < 5.0:
        raise RuntimeError(f"real-size frame is wrong: shape {frame.shape}, mean {frame.mean():.2f}")
    np.save(os.path.join(OUT_DIR, "chip_smoke_real.npy"), frame)
    summary = dict(
        ms_per_frame_median=statistics.median(times), ms_per_frame=times,
        max_memory_allocated=peak, stats=s, frame_mean=float(frame.mean()),
    )
    log(f"real-size frames: median {summary['ms_per_frame_median']:.3f} ms/frame "
        f"(all {['%.3f' % t for t in times]}), peak memory {peak} B, stats {s}")
    return summary, calls, counts


RANGES = ("shadow_pass", "forward_visibility", "forward_shade_skybox", "pcf_shadow",
          "pbr_lights", "post_process")


def profile_frames(render, bufs, frames) -> None:
    """torch.profiler over real-size frames: device kernel time and busy
    share, host time and device span of each frame-graph pass
    (record_function ranges) and the top kernels; the table and a chrome
    trace go to build/chip_smoke/."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for params, settings in frames:
            render(bufs, params, settings)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    n = len(frames)
    kernels_us = collections.Counter()
    count = collections.Counter()
    host_us = collections.Counter()
    span_us = collections.Counter()
    for e in prof.events():
        dur = e.time_range.elapsed_us()
        if e.name in RANGES:
            (span_us if e.device_type == DeviceType.CUDA else host_us)[e.name] += dur
        elif e.device_type == DeviceType.CUDA:
            kernels_us[e.name] += dur
            count[e.name] += 1
    busy_ms = sum(kernels_us.values()) / 1e3
    lines = [
        f"profile: {n} frames, wall {wall_ms / n:.3f} ms/frame with the profiler on, "
        f"device kernel time {busy_ms / n:.3f} ms/frame, busy share {busy_ms / wall_ms:.4f}, "
        f"{sum(count.values()) // n} device ops/frame"
    ]
    for rng in RANGES:
        lines.append(f"profile range {rng}: host {host_us[rng] / 1e3 / n:.3f} ms/frame, "
                     f"device span {span_us[rng] / 1e3 / n:.3f} ms/frame")
    for name, us in kernels_us.most_common(15):
        lines.append(f"profile kernel {us / 1e3 / n:8.3f} ms/frame x{count[name] // n:5d}  {name[:100]}")
    for line in lines:
        log(line)
    with open(os.path.join(OUT_DIR, "chip_smoke_profile.txt"), "w") as f:
        f.write("\n".join(lines) + "\n\n")
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    prof.export_chrome_trace(os.path.join(OUT_DIR, "chip_smoke_trace.json"))


def _tensors(out):
    return [t for t in (out if isinstance(out, tuple) else (out,)) if t is not None]


def max_abs_diff(a, b) -> float:
    """Max |a - b| where both are numbers; inf if the shapes, dtypes or NaN
    positions differ (NaNs sit in never-binned dead slots of the shade-row
    table, the same in both versions)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return float("inf")
    a, b = a.double(), b.double()
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if not torch.equal(nan_a, nan_b):
        return float("inf")
    d = (a[~nan_a] - b[~nan_b]).abs()
    return d.max().item() if d.numel() else 0.0


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` launches, CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare_kernels(calls, label: str, timed: bool):
    """Each recorded call: kernel vs plain version on the same inputs.
    Returns {kernel: {"max_abs_err", "ms", "plain_ms"}} (times summed over
    the kernel's calls in one frame)."""
    import torch

    from arctic_tpu_torch.utils import kernels

    result = {}
    for fn in kernels.KERNELS:
        name = fn.kernel_name
        if name not in calls:
            raise RuntimeError(f"{label}: kernel {name} was not called")
        err, ms, plain_ms = 0.0, 0.0, 0.0
        for args, kw in calls[name]:
            got = _tensors(fn(*args, **kw))
            want = _tensors(fn.plain(*args, **kw))
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                d = max_abs_diff(a, b)
                if d != 0.0:
                    raise RuntimeError(f"{label}: {name} differs from its plain version (max {d})")
                err = max(err, d)
            if timed:
                ms += cuda_ms(lambda: fn(*args, **kw), 20)
                plain_ms += cuda_ms(lambda: fn.plain(*args, **kw), 2)
        result[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        log(f"{label}: {name} x{len(calls[name])} bit-exact vs plain"
            + (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per frame" if timed else ""))
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; the port needs a CUDA device")
    # Imported after the device check: outside the repo these imports fail.
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.utils import kernels

    pipeline.use_full_f32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    lib = kernels.build_library()
    kernels.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s -> {os.path.basename(lib)}")

    dev = torch.device("cuda")
    _, entry_calls = run_entry(dev)
    summary, real_calls, counts = run_real(dev, profile="--profile" in sys.argv[1:])
    entry_cmp = compare_kernels(entry_calls, "entry", timed=False)
    real_cmp = compare_kernels(real_calls, "real-size", timed=True)

    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "arctic_tpu"))
    if foreign:
        raise RuntimeError(f"the port imported JAX or the JAX package: {foreign}")

    rows = []
    for fn in kernels.KERNELS:
        name = fn.kernel_name
        rows.append(dict(
            name=name, route=fn.route, source=fn.source, replaces=fn.replaces,
            launches=counts[name],
            max_abs_err=max(entry_cmp[name]["max_abs_err"], real_cmp[name]["max_abs_err"]),
            ms=real_cmp[name]["ms"], plain_ms=real_cmp[name]["plain_ms"],
        ))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
