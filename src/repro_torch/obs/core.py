"""Structured telemetry: spans, counters, gauges.

The API, the event layout and the `REPRO_PROFILE` hook are those of the
JAX package's `obs` (its `docs/observability.md` describes them), so a
profile from either package renders with either CLI.

Design contract:

* **Zero-cost when disabled.**  ``span()`` / ``counter()`` / ``event()``
  check one module global and return immediately; the disabled ``span()``
  hands back a shared no-op context manager, so instrumented hot loops
  pay a dict lookup and nothing else.
* **One clock with ``torch.profiler``.**  While the profiler records
  (``prof.start()`` up to ``prof.stop()``), ``span()`` also enters
  ``record_function(name)`` for the span's extent, collector or not, so
  the span lands in the profiler's trace as a ``user_annotation`` on the
  device trace's own clock.  The check reads the profiler's flag through
  ``sys.modules``: this module never imports torch.  ``complete()``
  (spans timed after the fact) is not mirrored.
* **Thread-safe.**  A :class:`Collector` guards its event list with a
  lock; spans measure time outside the lock and append once.
* **Process-safe by construction.**  Worker processes never talk to the
  coordinator's collector.  They time their own work with
  ``time.perf_counter()`` — CLOCK_MONOTONIC, system-wide on Linux, so
  timestamps from forked/spawned children are directly comparable — and
  ship ``(t0, t1)`` pairs home over the existing result channels; the
  coordinator records them with :func:`complete` at merge time.

Timestamps are absolute ``perf_counter()`` microseconds.  Exporters
rebase to the earliest event (``repro_torch.obs.export``).

Event categories steer the summarizer's concurrency sweep
(``repro_torch.obs.summarize``):

* ``"op"`` (default) — real work attributed to a lane.
* ``"wait"`` — a lane blocking on someone else (e.g. the dist
  coordinator waiting for the parse pool); excluded from busy time.
* ``"section"`` — an orchestration envelope around finer-grained ops
  (e.g. ``pipeline.partition`` around the dist engine's rounds);
  excluded from busy time so nesting never fakes parallelism.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
from contextlib import contextmanager
from time import perf_counter
from typing import Any, Dict, Iterator, List, Optional

from .metrics import MetricsRegistry

PROFILE_ENV = "REPRO_PROFILE"

__all__ = [
    "Collector",
    "PROFILE_ENV",
    "complete",
    "counter",
    "current",
    "disable",
    "enable",
    "enabled",
    "event",
    "gauge",
    "observe",
    "profiled",
    "scoped",
    "span",
]


class Collector:
    """Thread-safe sink for spans, instants, counters, gauges and the
    metrics registry (histograms — see `repro_torch.obs.metrics`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.metrics = MetricsRegistry()

    # -- events ---------------------------------------------------------
    def complete(
        self,
        name: str,
        t0: float,
        t1: float,
        lane: str = "main",
        cat: str = "op",
        **args: Any,
    ) -> None:
        """Record a finished span from absolute perf_counter seconds."""
        ev: Dict[str, Any] = {
            "name": name,
            "ph": "X",
            "ts": t0 * 1e6,
            "dur": max(t1 - t0, 0.0) * 1e6,
            "lane": lane,
            "cat": cat,
        }
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    def instant(self, name: str, lane: str = "main", **args: Any) -> None:
        ev: Dict[str, Any] = {
            "name": name,
            "ph": "i",
            "ts": perf_counter() * 1e6,
            "lane": lane,
            "cat": "instant",
        }
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    # -- scalars --------------------------------------------------------
    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    # -- merging --------------------------------------------------------
    def absorb_events(self, events: List[Dict[str, Any]]) -> None:
        with self._lock:
            self.events.extend(events)

    def absorb(self, other: "Collector") -> None:
        """Merge another collector (a scoped child) into this one."""
        with self._lock:
            self.events.extend(other.events)
            for k, v in other.counters.items():
                self.counters[k] = self.counters.get(k, 0.0) + v
            self.gauges.update(other.gauges)
        self.metrics.merge(other.metrics)  # registry has its own lock


def _profiler() -> Any:
    """``torch.autograd.profiler`` while ``torch.profiler`` records in
    this process, else None; never imports torch."""
    mod = sys.modules.get("torch.autograd.profiler")
    if mod is not None and getattr(mod, "_is_profiler_enabled", False):
        return mod
    return None


class _Span:
    """Context manager recording one complete event on exit into the
    collector, if any, and spanning a ``record_function`` of its name
    while the profiler records."""

    __slots__ = ("_col", "_name", "_lane", "_cat", "_args", "_t0", "_rf")

    def __init__(self, col: Optional[Collector], name: str, lane: str,
                 cat: str, args: dict, prof: Any = None):
        self._col = col
        self._name = name
        self._lane = lane
        self._cat = cat
        self._args = args
        self._rf = prof.record_function(name) if prof is not None else None

    def set(self, **kw: Any) -> None:
        """Attach args discovered mid-span (e.g. ``sp.set(full=True)``)."""
        self._args.update(kw)

    def __enter__(self) -> "_Span":
        if self._rf is not None:
            self._rf.__enter__()
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        if self._col is not None:
            self._col.complete(
                self._name, self._t0, perf_counter(), self._lane, self._cat,
                **self._args
            )
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


class _NoopSpan:
    __slots__ = ()

    def set(self, **kw: Any) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NOOP = _NoopSpan()

_active: Optional[Collector] = None


def current() -> Optional[Collector]:
    """The active collector, or None when telemetry is disabled."""
    return _active


def enabled() -> bool:
    return _active is not None


def enable(collector: Optional[Collector] = None) -> Collector:
    """Install ``collector`` (or a fresh one) as the active sink."""
    global _active
    _active = collector if collector is not None else Collector()
    return _active


def disable() -> Optional[Collector]:
    """Deactivate telemetry; returns the collector that was active."""
    global _active
    col, _active = _active, None
    return col


def span(name: str, lane: str = "main", cat: str = "op", **args: Any):
    """``with obs.span("dist.round", lane="cut/w0", round=3): ...``

    Returns a shared no-op when telemetry is disabled and
    ``torch.profiler`` is not recording.
    """
    col, prof = _active, _profiler()
    if col is None and prof is None:
        return _NOOP
    return _Span(col, name, lane, cat, args, prof)


def complete(
    name: str, t0: float, t1: float, lane: str = "main", cat: str = "op", **args: Any
) -> None:
    """Record an externally-timed span (absolute perf_counter seconds)."""
    col = _active
    if col is not None:
        col.complete(name, t0, t1, lane, cat, **args)


def event(name: str, lane: str = "main", **args: Any) -> None:
    """Record an instant event (e.g. a fallback reason)."""
    col = _active
    if col is not None:
        col.instant(name, lane, **args)


def counter(name: str, value: float = 1.0) -> None:
    col = _active
    if col is not None:
        col.add(name, value)


def gauge(name: str, value: float) -> None:
    col = _active
    if col is not None:
        col.set_gauge(name, value)


def observe(name: str, value: float) -> None:
    """Record one sample into the active collector's named histogram
    (microseconds by repo convention).  No-op when telemetry is off —
    same zero-cost contract as `span()`."""
    col = _active
    if col is not None:
        col.metrics.observe(name, value)


@contextmanager
def scoped(merge: bool = True) -> Iterator[Collector]:
    """Activate a fresh collector for the block; restore the outer one.

    With ``merge=True`` (default) the outer collector, if any, absorbs
    the child's events and counters on exit, so a scoped measurement
    still contributes to a surrounding ``REPRO_PROFILE`` dump.
    """
    global _active
    outer = _active
    col = Collector()
    _active = col
    try:
        yield col
    finally:
        _active = outer
        if merge and outer is not None:
            outer.absorb(col)


@contextmanager
def profiled(path: str) -> Iterator[Collector]:
    """Scoped collection that writes a profile JSON to ``path`` on exit."""
    from .export import write_profile

    with scoped() as col:
        try:
            yield col
        finally:
            write_profile(path, col)


def _install_env_profile() -> None:
    """``REPRO_PROFILE=out.json`` enables collection for the whole
    process and dumps the profile at interpreter exit."""
    path = os.environ.get(PROFILE_ENV)
    if not path:
        return
    col = enable()
    pid = os.getpid()

    def _dump() -> None:
        if os.getpid() != pid:  # forked child: not our profile
            return
        try:
            from .export import write_profile

            write_profile(path, col)
        except OSError as e:  # pragma: no cover - disk-full etc.
            print(f"repro_torch.obs: could not write {path}: {e}", file=sys.stderr)

    atexit.register(_dump)


_install_env_profile()
