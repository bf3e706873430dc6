"""Failure types of the port (arctic_tpu/utils/errors.py)."""

from __future__ import annotations


class RenderError(RuntimeError):
    """A frame that must not be used: overflowed buffers, or a scene that
    takes a route this port does not have yet."""
