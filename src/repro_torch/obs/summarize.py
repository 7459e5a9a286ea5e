"""Profile analysis: phase table, lane utilization, serial fraction.

Works on normalized events (``name``/``ts``/``dur``/``lane``/``cat``),
either straight from a :class:`~repro_torch.obs.core.Collector` or recovered
from a profile file via :func:`repro_torch.obs.export.events_from_chrome`.

The concurrency sweep considers only **leaf** spans (``cat == "op"``) —
``wait`` and ``section`` envelopes never count as busy time, so nested
orchestration spans cannot fake parallelism.  It decomposes wall time
exactly into:

* ``parallel_us`` — at least two lanes doing real work at once,
* ``serial_us``  — exactly one lane busy (this time is on the critical
  path by definition; the phase table attributes it to the innermost
  span that owns it),
* ``idle_us``    — no lane busy (scheduling gaps, uninstrumented code).

``serial_fraction = 1 - parallel_us / wall_us`` is the measured
non-parallel share, i.e. the *s* in Amdahl's bound ``1/(s + (1-s)/W)``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

__all__ = ["render_summary", "summarize_events"]


def _leaf_spans(events: List[Dict[str, Any]]) -> List[Tuple[float, float, str, str]]:
    out = []
    for ev in events:
        if ev.get("ph", "X") != "X" or ev.get("cat", "op") != "op":
            continue
        t0 = float(ev["ts"])
        out.append((t0, t0 + float(ev.get("dur", 0.0)), ev.get("lane", "main"), ev["name"]))
    return out


def _sweep(spans: List[Tuple[float, float, str, str]]) -> Dict[str, Any]:
    """Single pass over span endpoints; O(S log S)."""
    points: List[Tuple[float, int, int]] = []  # (time, +1/-1, span index)
    for i, (t0, t1, _lane, _name) in enumerate(spans):
        if t1 > t0:
            points.append((t0, 1, i))
            points.append((t1, -1, i))
    points.sort(key=lambda p: (p[0], -p[1]))

    active_by_lane: Dict[str, Dict[int, Tuple[float, str]]] = {}
    busy_lanes = 0
    serial = parallel = 0.0
    lane_busy: Dict[str, float] = {}
    phase_serial: Dict[str, float] = {}

    prev_t = points[0][0] if points else 0.0
    for t, kind, i in points:
        dt = t - prev_t
        if dt > 0:
            if busy_lanes == 1:
                serial += dt
                # attribute to the innermost active span on the busy lane
                for lane, active in active_by_lane.items():
                    if active:
                        _t0, name = max(active.values(), key=lambda v: v[0])
                        phase_serial[name] = phase_serial.get(name, 0.0) + dt
                        lane_busy[lane] = lane_busy.get(lane, 0.0) + dt
                        break
            elif busy_lanes >= 2:
                parallel += dt
                for lane, active in active_by_lane.items():
                    if active:
                        lane_busy[lane] = lane_busy.get(lane, 0.0) + dt
        prev_t = t
        t0, t1, lane, name = spans[i]
        active = active_by_lane.setdefault(lane, {})
        if kind == 1:
            if not active:
                busy_lanes += 1
            active[i] = (t0, name)
        else:
            active.pop(i, None)
            if not active:
                busy_lanes -= 1
    return {
        "serial_us": serial,
        "parallel_us": parallel,
        "lane_busy": lane_busy,
        "phase_serial": phase_serial,
    }


def summarize_events(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Compute the summary dict the CLI renders (see module docstring)."""
    xs = [ev for ev in events if ev.get("ph", "X") == "X"]
    if not xs:
        return {
            "wall_us": 0.0,
            "serial_us": 0.0,
            "parallel_us": 0.0,
            "idle_us": 0.0,
            "serial_fraction": 1.0,
            "amdahl_bound": 1.0,
            "phases": {},
            "lanes": {},
            "instants": {},
        }
    start = min(float(ev["ts"]) for ev in xs)
    end = max(float(ev["ts"]) + float(ev.get("dur", 0.0)) for ev in xs)
    wall = max(end - start, 1e-9)

    spans = _leaf_spans(events)
    sw = _sweep(spans)
    serial, parallel = sw["serial_us"], sw["parallel_us"]
    idle = max(wall - serial - parallel, 0.0)
    s = max(min(1.0 - parallel / wall, 1.0), 0.0)

    phases: Dict[str, Dict[str, float]] = {}
    for ev in xs:
        ph = phases.setdefault(
            ev["name"], {"count": 0, "total_us": 0.0, "serial_us": 0.0}
        )
        ph["count"] += 1
        ph["total_us"] += float(ev.get("dur", 0.0))
    for name, us in sw["phase_serial"].items():
        if name in phases:
            phases[name]["serial_us"] = us

    lanes = {
        lane: {"busy_us": busy, "utilization": busy / wall}
        for lane, busy in sorted(sw["lane_busy"].items())
    }
    nlanes = max(len(lanes), 1)
    amdahl = 1.0 / (s + (1.0 - s) / nlanes) if nlanes > 1 else 1.0

    instants: Dict[str, int] = {}
    for ev in events:
        if ev.get("ph") == "i":
            key = ev["name"]
            reason = (ev.get("args") or {}).get("reason")
            if reason:
                key = f"{key}[{reason}]"
            instants[key] = instants.get(key, 0) + 1

    return {
        "wall_us": wall,
        "serial_us": serial,
        "parallel_us": parallel,
        "idle_us": idle,
        "serial_fraction": s,
        "amdahl_bound": amdahl,
        "phases": phases,
        "lanes": lanes,
        "instants": instants,
    }


def _ms(us: float) -> str:
    return f"{us / 1e3:10.2f}"


def render_summary(summary: Dict[str, Any], counters: Dict[str, float] | None = None) -> str:
    """Human-readable phase table + concurrency decomposition."""
    wall = summary["wall_us"]
    lines = [
        f"wall {wall / 1e3:.2f} ms   "
        f"parallel {_pct(summary['parallel_us'], wall)}   "
        f"serial {_pct(summary['serial_us'], wall)}   "
        f"idle {_pct(summary['idle_us'], wall)}",
        f"serial fraction s = {summary['serial_fraction']:.3f}   "
        f"Amdahl speedup bound @ {len(summary['lanes'])} lanes: "
        f"{summary['amdahl_bound']:.2f}x",
        "",
        f"{'phase':<24} {'count':>6} {'total ms':>10} {'mean ms':>9} "
        f"{'% wall':>7} {'critical ms':>12}",
    ]
    for name, ph in sorted(
        summary["phases"].items(), key=lambda kv: -kv[1]["total_us"]
    ):
        mean = ph["total_us"] / max(ph["count"], 1)
        lines.append(
            f"{name:<24} {ph['count']:>6} {_ms(ph['total_us'])} "
            f"{mean / 1e3:>9.2f} {100 * ph['total_us'] / wall:>6.1f}% "
            f"{ph['serial_us'] / 1e3:>12.2f}"
        )
    if summary["lanes"]:
        lines += ["", f"{'lane':<24} {'busy ms':>10} {'util':>7}"]
        for lane, st in summary["lanes"].items():
            lines.append(
                f"{lane:<24} {_ms(st['busy_us'])} {100 * st['utilization']:>6.1f}%"
            )
    if summary["instants"]:
        lines += ["", "instant events:"]
        for key, n in sorted(summary["instants"].items()):
            lines.append(f"  {key:<38} x{n}")
    if counters:
        lines += ["", "counters:"]
        for key, v in sorted(counters.items()):
            lines.append(f"  {key:<38} {v:g}")
    return "\n".join(lines)


def _pct(us: float, wall: float) -> str:
    return f"{us / 1e3:.2f} ms ({100 * us / max(wall, 1e-9):.1f}%)"
