"""Process-wide metrics registry: counters, gauges, latency histograms.

This is the scalar half of `repro_torch.obs` (spans/events are the temporal
half — see `core`).  A :class:`MetricsRegistry` holds *named
instruments*:

* **counters** — monotone sums (`cache_hit`, `evictions`);
* **gauges** — last-write-wins levels (`hot_entries`);
* **histograms** — fixed-bucket latency distributions with
  `percentile()` estimation, built for merging: two histograms over the
  same bucket bounds combine by adding bucket counts, so per-worker
  recordings fold into one distribution without keeping raw samples.

Design contract (mirrors the span layer; the JAX package's
`docs/observability.md` describes both):

* **Zero-cost when disabled.**  The module-level helpers in
  `repro_torch.obs.core` (`obs.observe(...)`) check the active-collector
  global and return immediately; a disabled process pays one attribute
  load per call site.  A registry owned directly (the JAX package's plan service
  keeps one) is always on: live serving metrics must not depend on
  profiling being enabled.
* **Lock-guarded.**  One registry lock covers every instrument; the
  critical sections are a few float ops, so contention is bounded by
  the caller's own throughput.
* **Process-safe by construction.**  Worker processes never touch the
  coordinator's registry.  They ship durations home over the existing
  dist result channels (the same `(t0, us)` pairs the span layer
  records) and the coordinator observes them at merge time — so the
  "merged" histogram is recorded in one process and needs no shared
  memory.  `merge()` exists for the scoped-collector path
  (`obs.scoped()` absorbing a child registry) and for folding snapshot
  dicts that did cross a process boundary.

Histogram buckets are upper bounds in the observed unit (the repo
convention is **microseconds**); the default covers 1 µs .. 100 s on a
1-2.5-5 grid, with an implicit +inf overflow bucket.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, Optional

__all__ = ["DEFAULT_BUCKETS_US", "Histogram", "MetricsRegistry"]

# 1-2.5-5 per decade, 1 µs .. 100 s; +inf overflow is implicit
DEFAULT_BUCKETS_US = tuple(
    base * scale
    for scale in (1.0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7)
    for base in (1.0, 2.5, 5.0)
)


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max sidecars.

    Not thread-safe on its own — the owning :class:`MetricsRegistry`
    serialises access under its lock.
    """

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, bounds: Iterable[float] = DEFAULT_BUCKETS_US):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(self.bounds) or not self.bounds:
            raise ValueError("histogram bounds must be sorted and non-empty")
        self.counts = [0] * (len(self.bounds) + 1)  # +1: overflow
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, value: float) -> None:
        # linear scan beats bisect at these bucket counts for typical
        # (small) latencies, and keeps this file dependency-free
        i = 0
        bounds = self.bounds
        n = len(bounds)
        while i < n and value > bounds[i]:
            i += 1
        self.counts[i] += 1
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (q in [0, 100]) by linear
        interpolation inside the covering bucket, clamped to the exact
        observed min/max so single-sample histograms report the sample."""
        if self.count == 0:
            return 0.0
        rank = q / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                frac = (rank - seen) / c
                est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                return min(max(est, self.min), self.max)
            seen += c
        return self.max

    def merge(self, other: "Histogram") -> None:
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different buckets")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "bounds": list(self.bounds),
            "counts": list(self.counts),
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
        }

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any]) -> "Histogram":
        h = cls(snap["bounds"])
        h.counts = [int(c) for c in snap["counts"]]
        h.count = int(snap["count"])
        h.sum = float(snap["sum"])
        if h.count:
            h.min = float(snap["min"])
            h.max = float(snap["max"])
        return h


class MetricsRegistry:
    """Named counters, gauges and histograms behind one lock."""

    def __init__(self, buckets: Iterable[float] = DEFAULT_BUCKETS_US):
        self._lock = threading.Lock()
        self._buckets = tuple(float(b) for b in buckets)
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}

    # -- recording ------------------------------------------------------
    def counter(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        """Record one sample into the named histogram (created with the
        registry's default buckets on first use)."""
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = Histogram(self._buckets)
            h.observe(value)

    def histogram(self, name: str,
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        """Get-or-create the named histogram (optionally with explicit
        bucket bounds — only honoured at creation)."""
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = Histogram(
                    buckets if buckets is not None else self._buckets)
            return h

    # -- summarising ----------------------------------------------------
    def percentile(self, name: str, q: float) -> float:
        with self._lock:
            h = self.histograms.get(name)
            return h.percentile(q) if h is not None else 0.0

    def snapshot(self) -> Dict[str, Any]:
        """A JSON-able view: counters/gauges flat, histograms with
        bucket arrays and p50/p99 summaries."""
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {k: h.snapshot()
                               for k, h in self.histograms.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()

    # -- merging --------------------------------------------------------
    def merge(self, other: "MetricsRegistry | Dict[str, Any]") -> None:
        """Fold another registry (or a `snapshot()` dict that crossed a
        process boundary) into this one."""
        if isinstance(other, MetricsRegistry):
            other = other.snapshot()
        with self._lock:
            for k, v in other.get("counters", {}).items():
                self.counters[k] = self.counters.get(k, 0.0) + v
            self.gauges.update(other.get("gauges", {}))
            for k, snap in other.get("histograms", {}).items():
                h = self.histograms.get(k)
                if h is None:
                    self.histograms[k] = Histogram.from_snapshot(snap)
                else:
                    h.merge(Histogram.from_snapshot(snap))

    def __len__(self) -> int:
        with self._lock:
            return (len(self.counters) + len(self.gauges)
                    + len(self.histograms))
