"""The traced window: `torch.profiler`'s trace of whole units, read from
its Chrome trace export.

The window runs from the start of the first unit marked
`portbench.unit` to the end of the last, on the trace's own clock.  The
device is busy where at least one kernel, copy or memset runs: the union
of their intervals, never a sum of their times, so that launches that
overlap on two streams count once.  A kernel belongs to the host
operator in which it was launched: its launch on the host carries the
same correlation id, and the operator covers the launch on its thread.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import math
import os
import tempfile

import numpy as np

from . import yardstick

__all__ = ["TraceWindow", "window_from_profile", "window_from_events",
           "product_flops"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
UNIT = "portbench.unit"
# the operators that run a matrix product, whatever kernel they launch
PRODUCT_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
               "aten::matmul", "aten::linear", "aten::addmv", "aten::mv",
               "aten::einsum", "aten::_scaled_mm")


@dataclasses.dataclass
class TraceWindow:
    units: int                   # whole units in the window
    lo: float                    # microseconds, the trace's clock
    hi: float
    device_ops: list             # (name, start, duration, category,
                                 #  correlation id)
    host_ops: list               # (start, end, name), by start
    runtime_ops: list            # (start, end, name), by start
    work: yardstick.UnitWork     # the model's work in one unit
    counters: dict               # the program's counters over the window
    products: list = dataclasses.field(default_factory=list)
                                 # (thread, start, end, FLOPs) of each
                                 # product operator (PRODUCT_OPS)
    launches: dict = dataclasses.field(default_factory=dict)
                                 # correlation id -> (thread, time) of
                                 # the launch on the host

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return yardstick.union_seconds(
            [(s, s + d) for _, s, d, _, _ in self.device_ops],
            self.lo, self.hi) / 1e6

    def kernels(self, *parts: str) -> list:
        """(name, seconds) of the kernels whose name holds any of
        `parts`, or of every kernel without parts."""
        return [(n, d / 1e6) for n, _, d, c, _ in self.device_ops
                if c == "kernel" and (not parts or any(p in n for p in parts))]

    def product_time(self) -> tuple[float, float, int]:
        """(FLOPs, device seconds, operators) of the matrix products: the
        outermost product operators on each host thread (an `aten::mm`
        inside an `aten::matmul` counts once), the FLOPs their input
        shapes give, and the device time of every kernel, copy or memset
        launched inside them, whatever its name."""
        outer: dict = {}
        for tid, s, e, flops in sorted(self.products,
                                       key=lambda p: (p[0], p[1], -p[2])):
            spans = outer.setdefault(tid, [])
            if spans and s < spans[-1][1]:
                continue                    # nested in the last one
            spans.append((s, e, flops))
        starts = {tid: [sp[0] for sp in spans] for tid, spans in outer.items()}
        seconds = 0.0
        for _, _, dur, _, corr in self.device_ops:
            tid, t = self.launches.get(corr, (None, None))
            if tid not in outer:
                continue
            i = bisect.bisect_right(starts[tid], t) - 1
            if i >= 0 and t <= outer[tid][i][1]:
                seconds += dur / 1e6
        flops = sum(f for spans in outer.values() for _, _, f in spans)
        return flops, seconds, sum(len(v) for v in outer.values())

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, and the idle
        time by what the host was doing in each gap (the innermost
        operator running at the gap's middle, on any thread)."""
        by_name: dict = {}
        for name, _, dur, _, _ in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + dur / 1e6
        idle: dict = {}
        spans = [(s, s + d) for _, s, d, _, _ in self.device_ops]
        gaps = sorted(yardstick.gaps(spans, self.lo, self.hi),
                      key=lambda g: g[0] - g[1])
        for s, e in gaps[:2000]:
            name = (_innermost(self.host_ops, (s + e) / 2)
                    or _innermost(self.runtime_ops, (s + e) / 2)
                    or "no operator")
            idle[name] = idle.get(name, 0.0) + (e - s) / 1e6

        def head(d):
            return [[_short(k), v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": head(by_name), "idle_gaps": head(idle)}


def _short(name: str) -> str:
    return name if len(name) <= 160 else name[:157] + "..."


def _innermost(ops: list, t: float) -> str | None:
    """The name of the op that covers t and started last, among (start,
    end, name) sorted by start."""
    i = bisect.bisect_right(ops, (t, float("inf"), ""))
    for j in range(i - 1, max(i - 20000, -1), -1):
        if ops[j][1] >= t:
            return ops[j][2]
    return None


def window_from_events(events: list, work, counters: dict) -> TraceWindow:
    """The window of Chrome trace `events` between the first and last
    `portbench.unit` annotation."""
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == UNIT]
    if not marks:
        raise RuntimeError("the trace holds no portbench.unit annotation")
    lo = min(e["ts"] for e in marks)
    hi = max(e["ts"] + e["dur"] for e in marks)
    device, host, runtime, products, launches = [], [], [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, s = e.get("cat"), e.get("ts", 0.0)
        end = s + e.get("dur", 0.0)
        if end <= lo or s >= hi:
            continue
        args = e.get("args", {})
        if cat in DEVICE_CATS:
            device.append((e["name"], s, e["dur"], cat,
                           args.get("correlation")))
        elif cat in HOST_CATS and e.get("name") != UNIT:
            host.append((s, end, e["name"]))
            if e["name"] in PRODUCT_OPS:
                products.append((e.get("tid"), s, end,
                                 product_flops(e["name"],
                                               args.get("Input Dims"))))
        elif cat in RUNTIME_CATS:
            runtime.append((s, end, e["name"]))
            if "correlation" in args:
                launches[args["correlation"]] = (e.get("tid"), s)
    host.sort()
    runtime.sort()
    return TraceWindow(len(marks), lo, hi, device, host, runtime, work,
                       counters, products, launches)


def product_flops(name: str, dims) -> int:
    """The FLOPs (a multiply and an add each) of a product operator from
    its input shapes as the profiler records them; 0 where the shapes do
    not say (an einsum's equation is not among them)."""
    if not dims or name == "aten::einsum":
        return 0
    if name in ("aten::addmm", "aten::baddbmm", "aten::addmv"):
        dims = dims[1:]                      # the added term first
    a, b = list(dims[0]), list(dims[1])
    if not a or not b:
        return 0
    if name == "aten::linear":               # x [..., K], weight [N, K]
        return 2 * math.prod(a) * b[0]
    if len(a) == 1:
        a = [1] + a
    if len(b) == 1:
        b = b + [1]
    batch = math.prod(np.broadcast_shapes(tuple(a[:-2]), tuple(b[:-2])))
    return 2 * batch * a[-2] * a[-1] * b[-1]


def window_from_profile(prof, work, counters: dict) -> TraceWindow:
    """Export `prof` as a Chrome trace into a temporary directory (under
    TMPDIR), read it back and delete it."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return window_from_events(events, work, counters)
