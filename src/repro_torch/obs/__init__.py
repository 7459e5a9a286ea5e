"""Minimal telemetry for the port: `span`, `observe` and `enabled`.

The names and call shapes are those of the JAX package's `obs`, so the
core modules keep their instrumentation points unchanged.  Recording is
off by default, and then every call is a no-op.  `enable()` starts a
plain in-memory list of events, `disable()` stops it and returns what it
holds.  Profile export, histograms and the CLI belong to the full layer,
which is still to be ported (ROADMAP.md, queue 1, item 6).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Iterator

__all__ = ["span", "observe", "enabled", "enable", "disable"]

_events: "list[dict] | None" = None


def enabled() -> bool:
    """True while events are being recorded."""
    return _events is not None


def enable() -> None:
    """Start recording into a fresh event list."""
    global _events
    _events = []


def disable() -> "list[dict]":
    """Stop recording; return the events recorded since `enable()`."""
    global _events
    events, _events = _events or [], None
    return events


@contextlib.contextmanager
def span(name: str, lane: str = "main", cat: str = "op",
         **args: Any) -> Iterator[None]:
    """Time the enclosed block as one complete event (no-op when off)."""
    if _events is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _events.append({"name": name, "lane": lane, "cat": cat,
                        "t0_s": t0, "dur_s": time.perf_counter() - t0,
                        "args": args})


def observe(name: str, value: float) -> None:
    """Record one sample of a named quantity (no-op when off)."""
    if _events is not None:
        _events.append({"name": name, "value": float(value)})
