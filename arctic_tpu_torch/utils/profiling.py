"""Frame statistics and profiler hooks — port of arctic_tpu/utils/profiling.py.

The reference's 1000-entry frame-time history behind its Stats window
(app.hpp:24, app.cpp:404-453) becomes a ring buffer with a text summary;
its Tracy zones become record_function ranges (named_scope), which a
torch.profiler capture records.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque

import torch

FRAME_TIME_HISTORY_SIZE = 1000  # app.hpp:24


class FrameStats:
    def __init__(self, capacity: int = FRAME_TIME_HISTORY_SIZE):
        self.history: deque[float] = deque(maxlen=capacity)
        self._last = None

    def tick(self) -> float:
        """Record a frame boundary; returns the delta time in seconds."""
        now = time.perf_counter()
        dt = 0.0
        if self._last is not None:
            dt = now - self._last
            if dt > 0:
                self.history.append(dt)
        self._last = now
        return dt

    def add(self, dt: float) -> None:
        """Record an explicitly measured frame duration (seconds), for
        callers that bracket only the render and the device sync (the CLI's
        --stats), so that PNG encoding is not frame time."""
        if dt > 0:
            self.history.append(dt)

    @property
    def fps(self) -> float:
        return 1.0 / self.history[-1] if self.history else 0.0

    def summary(self) -> str:
        if not self.history:
            return "no frames"
        times = sorted(self.history)
        n = len(times)
        avg = sum(times) / n
        return (
            f"frames={n} avg={avg*1e3:.2f}ms ({1/avg:.1f} fps) "
            f"p50={times[n//2]*1e3:.2f}ms min={times[0]*1e3:.2f}ms "
            f"max={times[-1]*1e3:.2f}ms"
        )


# The context named_scope returns while no profiler runs.
_NO_SCOPE = contextlib.nullcontext()


def named_scope(name: str):
    """A torch.profiler.record_function range while a profiler runs (Kineto
    or emit_nvtx): a per-pass zone marker (TracyD3D12Zone analogue; the
    frame's passes carry these names). With every profiler off, a shared
    no-op context: a record_function costs host time even then, and the
    host paces the frame."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SCOPE
