"""The program's own spans in the traced window.

`repro_torch.obs` spans enter `record_function(name)` while the profiler
records, so they arrive in the Chrome trace as `user_annotation` events
on the device trace's clock, among `TraceWindow.host_ops`.  A device
operation (kernel, copy or memset) belongs to a span when its launch on
the host, found by the trace's correlation id (`TraceWindow.launches`),
lies inside the span's interval, on any host thread.

A program that predates the spans leaves none of `PROGRAM_SPANS` in the
window, and its readers read nothing there.  Where the program emits
them, a span that does not appear once a unit, or that launches nothing,
fails the run: a renamed or dropped span never reads 0.
"""
from __future__ import annotations

import bisect

from . import yardstick

__all__ = ["PROGRAM_SPANS", "intervals", "launched_in", "union_ms",
           "idle_ms"]

# the spans of `repro_torch.launch.steps`, `.optim.adamw` and `.models`
PROGRAM_SPANS = ("launch.train_step", "launch.forward", "launch.backward",
                 "launch.accumulate", "optim.adamw", "launch.prefill_step",
                 "models.unembed")


def intervals(w, name: str) -> list | None:
    """(start, end) of each `name` span in the window, in order, one a
    unit; None where the window holds none of the program's spans."""
    found = sorted((s, e) for s, e, n in w.host_ops if n == name)
    if not found and not any(n in PROGRAM_SPANS for _, _, n in w.host_ops):
        return None
    if len(found) != w.units:
        raise RuntimeError(f"program span {name!r}: {len(found)} in the "
                           f"trace, {w.units} traced units")
    return found


def launched_in(w, spans: list, name: str) -> list:
    """The device operations, as in `TraceWindow.device_ops`, whose launch
    on the host lies inside one of `spans` (sorted, not overlapping)."""
    starts = [s for s, _ in spans]
    out = []
    for op in w.device_ops:
        launch = w.launches.get(op[4])
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch[1]) - 1
        if i >= 0 and launch[1] <= spans[i][1]:
            out.append(op)
    if not out:
        raise RuntimeError(f"program span {name!r}: no device operation "
                           f"launched inside it")
    return out


def union_ms(w, ops: list) -> float:
    """The union of `ops`' device intervals, milliseconds a unit."""
    return yardstick.union_seconds([(s, s + d) for _, s, d, _, _ in ops],
                                   w.lo, w.hi) / 1e3 / w.units


def idle_ms(w, spans: list) -> float:
    """The device's idle time inside `spans` (each span's length less the
    union of every device interval inside it), milliseconds a unit."""
    busy = [(s, s + d) for _, s, d, _, _ in w.device_ops]
    idle = sum((e - s) - yardstick.union_seconds(busy, s, e)
               for s, e in spans)
    return idle / 1e3 / w.units
