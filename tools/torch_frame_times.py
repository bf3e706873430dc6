"""Real-size ms/frame of arctic_tpu_torch's default (fused) frame, to compare
two checkouts of the port on one card: run it once per checkout, in turn,
several times, on the same machine.

    python3 tools/torch_frame_times.py CHECKOUT [--rounds N] [--label NAME]

CHECKOUT is the root of a checkout of the repo: its arctic_tpu_torch and
its chip_smoke.py are imported from there. The scene, the viewpoints and the
tuned pair caps are chip_smoke.py's phase 4 (bench.py's Sponza-class scene
through its GLB round trip, the fly-through's FLY_FRAMES viewpoints). After
two warm-up frames it renders N rounds of the viewpoints and prints, per
round, each frame's wall ms (to the synchronise after it) and host ms (to
the return of the frame function), with the card's SM clock, power draw,
temperature and throttle reasons from nvidia-smi and the host's load
average; then a JSON summary, and chip_smoke's torch.profiler pass over the
viewpoints (host time and device span of each named range). Needs a CUDA
device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SMI_FIELDS = ("name,power.limit,clocks.sm,clocks.max.sm,power.draw,temperature.gpu,"
              "clocks_throttle_reasons.active")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={SMI_FIELDS}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkout")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_frame_times: no CUDA device")
    root = os.path.abspath(args.checkout)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.utils import kernels

    label = args.label or root
    pipeline.use_full_f32()
    kernels.library()
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    dev = torch.device("cuda")
    bufs = cs.real_buffers(dev)
    render = pipeline.make_renderer_stats(cs.tune_caps(bufs, "real-size"), dev)
    frames = [cs.real_params(i) for i in range(cs.FLY_FRAMES)]
    for params, settings in frames[:2]:
        render(bufs, params, settings)
        torch.cuda.synchronize()

    print(f"{label} before: {smi()}; load average {os.getloadavg()}", flush=True)
    wall, host = [], []
    for r in range(args.rounds):
        w, h, all_stats = [], [], []
        for params, settings in frames:
            t0 = time.perf_counter()
            _, stats = render(bufs, params, settings)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            w.append((t2 - t0) * 1e3)
            h.append((t1 - t0) * 1e3)
            all_stats.append(stats)
        for stats in all_stats:
            pipeline.check_stats(stats)
        wall += w
        host += h
        print(f"{label} round {r}: wall ms {[f'{x:.3f}' for x in w]}, host ms "
              f"{[f'{x:.3f}' for x in h]}; {smi()}; load average {os.getloadavg()}", flush=True)
    print(json.dumps({
        "label": label, "frames": len(wall),
        "wall_ms_median": statistics.median(wall), "wall_ms_min": min(wall),
        "wall_ms_max": max(wall), "host_ms_median": statistics.median(host),
    }), flush=True)
    cs.profile_frames(render, bufs, frames, "default")
    return 0


if __name__ == "__main__":
    sys.exit(main())
