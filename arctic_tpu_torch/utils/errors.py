"""Failure types of the port and the render guard (arctic_tpu/utils/errors.py):
fail fast with context, like the reference's DXERR + try/catch wall
(dxerr.hpp:5-10, main.cpp:43-65)."""

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
