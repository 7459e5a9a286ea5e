"""Profile exporters: Chrome trace-event / Perfetto JSON + flat summary.

The profile file is a standard Chrome trace-event object —
``{"traceEvents": [...], ...}`` — which https://ui.perfetto.dev and
``chrome://tracing`` open directly.  Extra top-level keys carry the
repro-specific scalars (the key is ``repro`` in both packages, so
profiles move between them):

* ``repro.counters`` / ``repro.gauges`` — flat metrics summary.
* ``repro.phases`` — per-phase totals (also derivable from the events).
* ``repro.metrics`` — the collector's :class:`MetricsRegistry` snapshot
  (histograms with bucket arrays and p50/p99; see `repro_torch.obs.metrics`).

Every span becomes a ``ph:"X"`` complete event.  Lanes map to ``tid``s
in order of first appearance, each named via a ``ph:"M"``
``thread_name`` metadata event, so Perfetto shows one labelled track
per worker.  Timestamps are rebased to the earliest event and events
are sorted by ``ts``, which makes per-lane timestamps monotone.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from .core import Collector

PID = 1

__all__ = ["chrome_trace", "events_from_chrome", "load_profile",
           "timeline_trace", "write_profile"]


def _phase_totals(events: List[Dict[str, Any]]) -> Dict[str, Dict[str, float]]:
    phases: Dict[str, Dict[str, float]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        ph = phases.setdefault(ev["name"], {"count": 0, "total_us": 0.0})
        ph["count"] += 1
        ph["total_us"] += ev.get("dur", 0.0)
    return phases


def chrome_trace(col: Collector) -> Dict[str, Any]:
    """Render a collector as a Perfetto-loadable trace-event object."""
    events = sorted(col.events, key=lambda ev: ev["ts"])
    base = events[0]["ts"] if events else 0.0
    lanes: Dict[str, int] = {}
    out: List[Dict[str, Any]] = []
    for ev in events:
        lane = ev.get("lane", "main")
        tid = lanes.get(lane)
        if tid is None:
            tid = lanes[lane] = len(lanes)
        rec: Dict[str, Any] = {
            "name": ev["name"],
            "ph": ev["ph"],
            "pid": PID,
            "tid": tid,
            "ts": round(ev["ts"] - base, 3),
            "cat": ev.get("cat", "op"),
        }
        if ev["ph"] == "X":
            rec["dur"] = round(ev.get("dur", 0.0), 3)
        if ev["ph"] == "i":
            rec["s"] = "t"  # instant scope: thread
        if "args" in ev:
            rec["args"] = ev["args"]
        out.append(rec)
    meta = [
        {
            "name": "thread_name",
            "ph": "M",
            "pid": PID,
            "tid": tid,
            "args": {"name": lane},
        }
        for lane, tid in lanes.items()
    ]
    return {
        "traceEvents": meta + out,
        "displayTimeUnit": "ms",
        "repro": {
            "counters": dict(col.counters),
            "gauges": dict(col.gauges),
            "phases": _phase_totals(col.events),
            "metrics": col.metrics.snapshot(),
        },
    }


def events_from_chrome(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Recover normalized events (name/ts/dur/lane/cat) from a profile
    file, resolving ``tid`` back to lane names via the metadata events."""
    raw = doc.get("traceEvents", [])
    names: Dict[Any, str] = {}
    for ev in raw:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[ev.get("tid")] = ev.get("args", {}).get("name", str(ev.get("tid")))
    out: List[Dict[str, Any]] = []
    for ev in raw:
        if ev.get("ph") not in ("X", "i"):
            continue
        out.append(
            {
                "name": ev.get("name", "?"),
                "ph": ev["ph"],
                "ts": float(ev.get("ts", 0.0)),
                "dur": float(ev.get("dur", 0.0)),
                "lane": names.get(ev.get("tid"), str(ev.get("tid"))),
                "cat": ev.get("cat", "op"),
                "args": ev.get("args", {}),
            }
        )
    return out


def timeline_trace(timeline: Dict[str, Any]) -> Dict[str, Any]:
    """Reconstruct a Perfetto-loadable trace from a dist *round
    timeline* (the ``timeline=`` dict `dist_vertex_cut` fills, also
    persisted in ``BENCH_dist_scaling.json`` meta).

    The timeline records durations, not wall-clock timestamps, so the
    tracks are synthetic: each round lays ``parse_wait`` then ``merge``
    on the ``coord`` lane and the per-worker ``cut`` spans in parallel
    on ``cut/wN`` lanes, advancing a cumulative clock by the round's
    critical path (parse_wait + max cut + merge) — the idealized
    dataflow the recorded durations imply.  A trailing ``finalize``
    span closes the coord lane when the timeline carries
    ``finalize_us``.
    """
    col = Collector()
    t = 0.0                                     # seconds, rebased at 0
    for rnd in timeline.get("rounds") or []:
        r = rnd.get("round", 0)
        pw = float(rnd.get("parse_wait_us", 0.0)) / 1e6
        if pw > 0:
            col.complete("dist.parse_wait", t, t + pw, lane="coord",
                         cat="wait", round=r)
        t += pw
        cuts = [float(u) / 1e6 for u in rnd.get("cut_us", [])]
        for w, cu in enumerate(cuts):
            col.complete("dist.cut", t, t + cu, lane=f"cut/w{w}",
                         cat="op", round=r,
                         edges=rnd.get("edges"))
        t += max(cuts, default=0.0)
        mu = float(rnd.get("merge_us", 0.0)) / 1e6
        if mu > 0:
            col.complete("dist.merge", t, t + mu, lane="coord", cat="op",
                         round=r, full=bool(rnd.get("full_merge")))
        t += mu
    fu = float(timeline.get("finalize_us") or 0.0) / 1e6
    if fu > 0:
        col.complete("dist.finalize", t, t + fu, lane="coord", cat="op")
    for key in ("workers", "merge_period", "full_merges", "round_merges"):
        if isinstance(timeline.get(key), (int, float)):
            col.set_gauge(f"timeline.{key}", timeline[key])
    return chrome_trace(col)


def write_profile(path: str, col: Collector) -> None:
    doc = chrome_trace(col)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, separators=(",", ":"))
        fh.write("\n")


def load_profile(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)
