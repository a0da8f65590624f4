"""Tracing hooks.

Only :func:`traced` with ``tracer=None`` is ported so far: the span tracer
(device-timeline lanes, Chrome export) is ROADMAP queue 1 item 4's
``obs/trace.py`` and still to come.
"""
from __future__ import annotations

import contextlib

__all__ = ["traced"]


def traced(tracer, category: str, name: str, **args):
    """A span around a block of work; a no-op when tracing is off."""
    if tracer is None:
        return contextlib.nullcontext()
    raise NotImplementedError(
        "span tracing is not ported yet (ROADMAP queue 1 item 4, obs/trace.py)")
