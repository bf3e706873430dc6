"""The traced burst: torch.profiler over a few frames, and what the
per-layer metrics read from it.

The reading is a frozen copy of chip_smoke.profile_frames (commit
b3e24800): device kernel time by name and each record_function range's
device span, with device busy time taken as the union of the device
operations' intervals (kernels, copies and fills), so that operations that
overlap count once. Host syncs are the runtime's stream and device
synchronisations inside the frame calls (a blocking copy makes one). An
idle gap is charged to the innermost range the host was in at its middle.
"""

from __future__ import annotations

import collections

import numpy as np

FRAME_RANGE = "bench.frame"
SYNC_RANGE = "bench.sync"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
# record_function ranges known by name, where the profiler does not mark
# its annotations as such (the harness's and the program's passes).
RANGES = {FRAME_RANGE, SYNC_RANGE, "shadow_pass", "forward_visibility",
          "forward_shade_skybox", "pcf_shadow", "pbr_lights", "post_process"}
TOP = 10
# Characters of a device operation's name kept in the breakdown.
NAME_CHARS = 96


def burst(frame, specs) -> dict:
    """Profile ``frame`` over ``specs`` back to back, then read the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for spec in specs:
            with record_function(FRAME_RANGE):
                frame(spec)
        with record_function(SYNC_RANGE):
            torch.cuda.synchronize()
    return read(prof.events(), len(specs))


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged (start, end) intervals of (n, 2) intervals."""
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def read(events, n_frames: int) -> dict:
    """Seconds and counts of the burst from the profiler's events."""
    from torch.autograd import DeviceType

    def is_range(e):
        return getattr(e, "is_user_annotation", False) or e.name in RANGES

    names = {e.name for e in events if is_range(e) and e.device_type != DeviceType.CUDA}
    host_ranges, device_ops, range_span = [], [], collections.Counter()
    kernel_s = collections.Counter()
    syncs = []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name in names:
                range_span[e.name] += (end - start) / 1e6
            else:
                device_ops.append((start, end))
                kernel_s[e.name] += (end - start) / 1e6
        elif is_range(e):
            host_ranges.append((start, end, e.name))
        elif e.name in SYNC_CALLS:
            syncs.append(start)
    frames = [(s, e) for s, e, n in host_ranges if n == FRAME_RANGE]
    tail = [(s, e) for s, e, n in host_ranges if n == SYNC_RANGE]
    lo = min(s for s, _ in frames)
    hi = max(e for _, e in tail) if tail else max(e for _, e in frames)
    busy = _union(np.clip(np.asarray(device_ops, np.float64).reshape(-1, 2), lo, hi))
    busy_us = float((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0.0
    in_frames = sum(any(s <= t <= e for s, e in frames) for t in syncs)
    return {
        "frames": n_frames,
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy_us / 1e6,
        "device_ops": len(device_ops),
        "host_syncs": in_frames,
        "kernel_s": dict(kernel_s),
        "range_device_s": dict(range_span),
        "idle_gaps": idle_gaps(busy, lo, hi, host_ranges),
        "top_ops": [[name[:NAME_CHARS], s] for name, s in kernel_s.most_common(TOP)],
    }


def idle_gaps(busy: np.ndarray, lo: float, hi: float, host_ranges) -> list:
    """The device's idle time in the window, summed by the innermost host
    range at each gap's middle ("bench.between" outside every range), the
    longest TOP."""
    edges = np.concatenate([[lo], busy.reshape(-1), [hi]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    mid = (gaps[:, 0] + gaps[:, 1]) / 2
    order = np.argsort(mid)
    mid_sorted = mid[order]
    owner = np.full(len(gaps), -1)
    owner_start = np.full(len(gaps), -np.inf)
    for i, (s, e, _) in enumerate(host_ranges):
        a, b = np.searchsorted(mid_sorted, [s, e])
        idx = order[a:b]
        inner = owner_start[idx] <= s
        owner[idx[inner]] = i
        owner_start[idx[inner]] = s
    by_name = collections.Counter()
    for g, o in zip(gaps, owner):
        by_name[host_ranges[o][2] if o >= 0 else "bench.between"] += float(g[1] - g[0]) / 1e6
    return [[name, s] for name, s in by_name.most_common(TOP)]

