"""One run of one cell: set-up, the measured window, the per-layer
readings of a traced window, and the comparison with the plain reference
that decides `correct`.

Everything that belongs to one configuration, traffic mix or metric is a
file the harness finds by the name in `BENCHMARK.json`:
  configs/<file>          the model's sizes, its source and its reference
  traffic/<traffic>.json  the mix's parameters and the loop that drives it
  loops/<loop>.py         a drive loop (`Driver`, `reference`, `compare`)
  reference/<module>.py   a plain reference model
  metrics/<name>.py       a per-layer metric's reader (or <base>.py for
                          `<base>.<suffix>`)
  limits/<workload>.json  the limits of the cell's compared numbers
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

__all__ = ["BENCH_DIR", "Cell", "load_cell", "Run", "execute",
           "forbidden_modules"]

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict           # the configuration's file: the model's sizes
                           # under the program's ModelConfig names
    traffic: dict          # the traffic mix's file
    end_to_end: list       # BENCHMARK.json entries that this cell reports
    per_layer: list
    limits: dict           # compared number -> {"limit": ...}


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: str = ROOT, overrides: dict | None = None
              ) -> Cell:
    """The cell `name` of `root`'s BENCHMARK.json with its files.
    `overrides` ({"model": {...}, "traffic": {...}}) shrink a cell for a
    test on the CPU; the benchmark itself never passes them."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: "
                         f"{sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(BENCH_DIR, "limits", name + ".json")) as f:
        limits = json.load(f)
    if overrides:
        config = {**config, **overrides.get("model", {})}
        config.pop("n_params", None)
        traffic = {**traffic, **overrides.get("traffic", {})}
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
                limits=limits)


class Run:
    """What a drive loop is given: the cell, the device, the seeds
    derived from `--seed`, the program's model configuration, the
    reference module and a hook that may wrap the program's step (a
    planted fault in the harness's own tests and calibration)."""

    def __init__(self, cell: Cell, seed: int, device, wrap_step=None):
        import torch
        from repro_torch.configs.base import ModelConfig
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        names = {f.name for f in dataclasses.fields(ModelConfig)}
        self.model = {k: v for k, v in cell.config.items() if k in names}
        self.model_cfg = ModelConfig(**self.model)
        self.traffic = cell.traffic
        self.ref = importlib.import_module(
            "portbench.reference." + cell.config["reference"])
        self.wrap_step = wrap_step or (lambda step: step)
        seq = np.random.SeedSequence(seed % (1 << 64))
        words = seq.generate_state(3, np.uint32)
        self.seeds = {"weights": int(words[0]), "text": int(words[1]),
                      "sample": int(words[2])}

    def loop(self):
        return importlib.import_module(
            "portbench.loops." + self.traffic["loop"])


def _reader(name: str):
    """The per-layer metric's reader: metrics/<name>.py, else
    metrics/<base>.py for a name <base>.<suffix>."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(BENCH_DIR, "metrics", stem + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                "portbench.metrics." + stem.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise SystemExit(f"no reader for the per-layer metric {name!r}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, wrap_step=None) -> dict:
    """One run: returns the result line's object.  The window runs whole
    units (train steps or requests) until `seconds` have passed; with
    `trace` the profiler records the first `trace_units` of them."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cuda = torch.device(device).type == "cuda"

    run = Run(cell, seed, device, wrap_step)
    loop = run.loop()
    readers = {m["name"]: _reader(m["name"]) for m in cell.per_layer} \
        if trace else {}
    counters = {}
    for r in readers.values():
        counters.update(getattr(r, "COUNTERS", {}))

    t_driver = time.perf_counter()
    driver = loop.Driver(run)                 # set-up and warm-up
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # with `trace`, the profiler runs over the window's first
    # `trace_units` + 1 units and the traced window is the last
    # `trace_units` of them: the first takes the profiler's own start
    n_trace = int(run.traffic["trace_units"]) + 1 if trace else 0
    prof = before = after = None
    if n_trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if cuda else []),
                       record_shapes=True)
        prof.start()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    units = []                  # (start, end) on the host clock
    while True:
        u0 = time.perf_counter()
        if 0 < len(units) < n_trace:
            with torch.profiler.record_function("portbench.unit"):
                driver.unit()
        else:
            driver.unit()
        units.append((u0, time.perf_counter()))
        if len(units) == 1 and n_trace:
            before = _read_counters(counters)
        if len(units) == n_trace:
            after = _read_counters(counters)
            prof.stop()
        if units[-1][1] - t0 >= seconds and len(units) >= n_trace:
            break
    window_s = units[-1][1] - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f"portbench: set-up {setup_s:.3f} s (import and start "
          f"{t_driver - t_start:.3f}, the loop's set-up and warm-up "
          f"{t0 - t_driver:.3f}); window {window_s:.3f} s, {len(units)} "
          f"units", file=sys.stderr)

    result = {"correct": False, "attempted": len(units),
              "failed": driver.failures(), "metrics": {}}
    if trace:
        from . import tracing
        tw = tracing.window_from_profile(
            prof, driver.unit_work(),
            {k: after[k] - before[k] for k in counters})
        for m in cell.per_layer:
            value = readers[m["name"]].read(tw)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        device_extra = {"busy_s": tw.busy_s, "window_s": tw.window_s}
        breakdown = tw.breakdown()
    else:
        values = driver.end_to_end(units, window_s)
        values["setup_s"] = setup_s
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
        device_extra, breakdown = {}, None
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak), **device_extra}
    if breakdown is not None:
        result["breakdown"] = breakdown

    obs = driver.observe()
    driver.release()
    del driver
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = loop.compare(obs, loop.reference(run, obs))
    checks = {}
    for name, value in numbers.items():
        limit = cell.limits[name]["limit"]
        checks[name] = {"value": value, "limit": limit}
    result["correct"] = (bool(checks) and result["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    if cuda:
        result["device"]["power"] = _power_limit()
    result["checks"] = checks          # last: the numbers and their limits
    return result


def _read_counters(counters: dict) -> dict:
    """name -> the program's counter (module, attribute) now."""
    out = {}
    for key, (mod, attr) in counters.items():
        out[key] = getattr(importlib.import_module(mod), attr)
    return out


def check_lines(result: dict) -> list:
    """The compared numbers beside their limits, one line each."""
    return [f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}"
            for name, c in result["checks"].items()]
