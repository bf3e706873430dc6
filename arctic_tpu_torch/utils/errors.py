"""Failure types of the port, the render guard and the debug checks
(arctic_tpu/utils/errors.py): fail fast with context, like the reference's
DXERR + try/catch wall (dxerr.hpp:5-10, main.cpp:43-65) and its D3D debug
layer."""

from __future__ import annotations

import contextlib
import logging

log = logging.getLogger("arctic")


class RenderError(RuntimeError):
    """A frame that must not be used: overflowed buffers, or a scene, file
    or option that takes a route this port does not have yet."""


@contextlib.contextmanager
def render_guard(description: str):
    """Wrap a render call; annotate a failure with the scene and config
    (CUDA errors say nothing of which scene caused them) and re-raise it
    as RenderError."""
    try:
        yield
    except Exception as e:  # noqa: BLE001 — the catch-all wall is the point
        msg = f"render failed ({description}): {type(e).__name__}: {e}"
        log.error(msg)
        raise RenderError(msg) from e


_debug_checks = False


def enable_debug_checks(enabled: bool = True) -> None:
    """Debug mode (SURVEY.md §5.2), the D3D debug-layer analogue: turn NaN
    and Inf into FloatingPointError where they first appear, at a cost of
    one host read per checked tensor. The flag is process-wide;
    ``enable_debug_checks(False)`` turns it off.

    Unlike the JAX package's jax_debug_nans / jax_debug_infs, which check
    every primitive's output, the checks run between the frame's named
    passes: the frame's float inputs (camera, sun, lights, settings), the
    shadow map after ``shadow_pass``, the G-buffer on covered pixels after
    ``forward_visibility`` and the HDR after ``forward_shade_skybox`` (the
    ray-traced frame: its inputs and its HDR). The port runs eagerly, and
    some of its plain torch versions compute non-finite values on purpose
    and discard them (K14's IEEE 1/d, for example): a check of every op's
    output would reject good frames."""
    global _debug_checks
    _debug_checks = enabled


def debug_checks_enabled() -> bool:
    return _debug_checks


def check_finite(where: str, **tensors) -> None:
    """With the debug checks on, raise FloatingPointError naming ``where``,
    the first float tensor holding a NaN or an Inf, and how many it holds;
    None and non-float tensors are skipped. Without the checks, nothing."""
    if not _debug_checks:
        return
    for name, t in tensors.items():
        if t is None or not t.is_floating_point():
            continue
        bad = int((~t.isfinite()).sum())
        if bad:
            raise FloatingPointError(
                f"{where}: {bad} non-finite value(s) in {name} (shape {tuple(t.shape)})")
