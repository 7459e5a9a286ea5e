"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line(s):

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them;
2. build: compile `src/repro_torch/csrc/*.cu` with nvcc for sm_90a;
3. kernels: the segment-sum kernel against its plain version and
   `np.add.at`, exactly, on float64 and int64 layouts (empty segments,
   one segment of millions of elements, p, p+1 and p^2+1 segments at
   p=1024, a random sorted layout from a fixed seed);
4. main path: `run_pipeline(..., backend="cuda")` on the n=3,000,000
   power-law graph (5,528,199 edges) at p=1024 and p=64, held against the
   port's host engine `backend="fast"` (cut, replica CSR, core_of and
   core_times bit-identical; exec_time and data_comm_bytes to rtol
   1e-12), with the kernel's launch count read around each run;
5. timing: the kernel, its plain version and one PyTorch call computing
   the same sum (`index_add_`, timed only as a yardstick) at the main
   path's largest shapes, then one JSON line `{"kernels": [...]}`.

The last line is `{"ok": true, "device": {...}}`.  Any failure raises
and the script exits non-zero before that line.  It imports nothing of
JAX and nothing of the JAX package; without a CUDA device, or outside a
checkout of the repository, it fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM (NVIDIA data sheet): 3.35 TB/s HBM3; 34 TFLOP/s float64 outside
# the tensor cores (the kernel's adds are float64 or int64 adds)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_OPS_PER_S = 34e12

GRAPH_N, GRAPH_ALPHA, GRAPH_SEED = 3_000_000, 2.2, 0
P_MAIN = (1024, 64)


def log(*args) -> None:
    print(*args, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------- #
# 1. device
# ---------------------------------------------------------------------- #
def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(f"device: {name} (torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(smi.stdout.strip().splitlines()[0])
    return name


# ---------------------------------------------------------------------- #
# 2. build
# ---------------------------------------------------------------------- #
def phase_build() -> None:
    from repro_torch.core.cuda import _build
    t0 = time.perf_counter()
    path, report = _build.build_library()
    _build.load_library()
    log(f"build: {len(_build.sources())} CUDA source(s) -> "
        f"{os.path.relpath(path, HERE)} in "
        f"{time.perf_counter() - t0:.3f} s")
    for line in report.splitlines():
        if "Used" in line or "spill" in line:
            log(f"build: {line.strip()}")


# ---------------------------------------------------------------------- #
# 3. the kernel against its plain version
# ---------------------------------------------------------------------- #
def _layouts(rng: np.random.Generator):
    """(name, sorted ids, num_segments) at the main path's shapes."""
    m_edges = 5_528_199
    yield "empty-stream", np.zeros(0, np.int64), 1024
    yield ("mostly-empty-segments",
           np.sort(rng.integers(0, 1 << 20, 4096)), 1 << 20)
    yield "one-giant-segment", np.zeros(4_000_000, np.int64), 1
    for nseg in (1024, 1025):
        yield f"p={nseg}", np.sort(rng.integers(0, nseg, m_edges)), nseg
    yield ("p^2+1", np.sort(rng.integers(0, 1024 * 1024 + 1, 2_000_000)),
           1024 * 1024 + 1)
    # random runs, with empty segments and runs of every length
    nseg = 200_003
    lens = rng.geometric(0.02, size=nseg) * (rng.random(nseg) < 0.6)
    yield "random-runs", np.repeat(np.arange(nseg), lens), nseg


def phase_kernel_vs_plain() -> float:
    from repro_torch.core.cuda import segsum
    rng = np.random.default_rng(11)
    worst = 0.0
    for name, ids, nseg in _layouts(rng):
        for dtype in (np.float64, np.int64):
            if dtype is np.float64:
                data = rng.integers(-50, 50, len(ids)) * np.pi
            else:
                data = rng.integers(-10**12, 10**12, len(ids))
            d = torch.from_numpy(data).cuda()
            i = torch.from_numpy(ids).cuda()
            got = segsum.segment_sum(d, i, nseg, validate=True)
            torch.cuda.synchronize()
            plain = segsum.segment_sum_plain(d, i, nseg)
            want = np.zeros(nseg, dtype)
            np.add.at(want, ids, data)
            check(got.dtype == d.dtype and got.shape == (nseg,),
                  f"{name}/{dtype.__name__}: dtype or shape")
            check(torch.equal(got, plain),
                  f"{name}/{dtype.__name__}: kernel != plain version")
            host = got.cpu().numpy()
            check(np.array_equal(host, want),
                  f"{name}/{dtype.__name__}: kernel != np.add.at")
            worst = max(worst, float((got - plain).abs().max())
                        if nseg else 0.0)
            log(f"kernel {name:22s} {dtype.__name__:8s} m={len(ids):>9d} "
                f"segments={nseg:>8d}: equal to plain and np.add.at")
    return worst


# ---------------------------------------------------------------------- #
# 4. the main path
# ---------------------------------------------------------------------- #
def _compare(cuda, fast, p: int) -> None:
    (cp, cm, cr), (fp, fm, fr) = cuda, fast
    for field in ("assignment", "loads", "edge_counts", "replica_indptr",
                  "replica_flat"):
        a, b = getattr(cp, field), getattr(fp, field)
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"p={p}: {field} differs from fast")
    check(np.array_equal(cm.core_of, fm.core_of), f"p={p}: core_of")
    check(np.array_equal(cr.core_times, fr.core_times),
          f"p={p}: core_times")
    for field in ("exec_time", "data_comm_bytes"):
        a, b = getattr(cr, field), getattr(fr, field)
        check(np.isfinite(a) and abs(a - b) <= 1e-12 * abs(b),
              f"p={p}: {field} {a!r} vs {b!r}")


def _timed_run(g, p: int, backend: str):
    """One `run_pipeline` on the card's default device: (result, wall
    seconds, {span name: seconds}) with the port's spans recorded."""
    from repro_torch import obs
    from repro_torch.core import run_pipeline
    torch.cuda.synchronize()
    obs.enable()
    try:
        t0 = time.perf_counter()
        out = run_pipeline(g, p, "wb_libra", backend=backend)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        spans = obs.disable()
    stages = {e["name"]: round(e["dur_s"], 6) for e in spans
              if e["name"].startswith(("pipeline.", "cut.", "map.", "sim."))}
    return out, wall, stages


def phase_main_path() -> dict:
    from repro_torch.core import resolve_backend, synthesize_powerlaw_graph
    from repro_torch.core.cuda import segsum
    engine = resolve_backend("fast")
    log(f"resolve_backend('fast') = {engine}")
    check(engine == "native", "the host stream must run on the C engine")
    t0 = time.perf_counter()
    g = synthesize_powerlaw_graph(n=GRAPH_N, alpha=GRAPH_ALPHA,
                                  seed=GRAPH_SEED)
    log(f"graph: n={g.n} edges={g.num_edges} "
        f"({time.perf_counter() - t0:.3f} s to build on the host)")
    check(g.num_edges == 5_528_199, "unexpected edge count")
    runs = {}
    for p in P_MAIN:
        # fast, cuda, cuda, fast: the first cuda run is the one whose
        # launches are counted and whose outputs are checked; the wall
        # times are the better of each pair
        fast, t_fast, fast_stages = _timed_run(g, p, "fast")
        segsum.launches = 0
        cuda, t_cuda, cuda_stages = _timed_run(g, p, "cuda")
        launches = segsum.launches
        _compare(cuda, fast, p)
        check(launches > 0, f"p={p}: the main path launched no kernel")
        t_cuda = min(t_cuda, _timed_run(g, p, "cuda")[1])
        t_fast = min(t_fast, _timed_run(g, p, "fast")[1])
        log(f"main path p={p}: segment_sum launches {launches}, exec_time "
            f"{cuda[2].exec_time!r}, data_comm_bytes "
            f"{cuda[2].data_comm_bytes!r}, replication_factor "
            f"{cuda[0].replication_factor!r}: bit-identical to fast")
        log(f"wall p={p} (host clock, better of two runs): cuda "
            f"{t_cuda:.6f} s, fast {t_fast:.6f} s")
        log(f"stages p={p} cuda (host clock, s): {json.dumps(cuda_stages)}")
        log(f"stages p={p} fast (host clock, s): {json.dumps(fast_stages)}")
        runs[p] = {"launches": launches, "part": cuda[0], "graph": g}
    return runs


# ---------------------------------------------------------------------- #
# 5. timing at the main path's largest shapes
# ---------------------------------------------------------------------- #
def _cuda_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _host_ms(fn, reps: int = 3) -> float:
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def _time_shape(name: str, data: torch.Tensor, ids: torch.Tensor,
                nseg: int) -> dict:
    from repro_torch.core.cuda import segsum
    m = data.numel()
    ms = _cuda_ms(lambda: segsum.segment_sum(data, ids, nseg))
    plain_ms = _host_ms(lambda: segsum.segment_sum_plain(data, ids, nseg))
    library_ms = _cuda_ms(lambda: torch.zeros(
        nseg, dtype=data.dtype, device=data.device).index_add_(0, ids, data))
    nbytes = data.element_size() * m + ids.element_size() * m \
        + data.element_size() * nseg
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = m / PEAK_F64_OPS_PER_S * 1e3
    return {"shape": f"{name}: m={m} segments={nseg} {data.dtype}",
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_timing(runs: dict, max_abs_err: float) -> dict:
    from repro_torch.core import vertex_bytes_model
    from repro_torch.core.cuda import metrics as cm
    from repro_torch.core.cuda import segsum
    dev = torch.device("cuda")
    part, g = runs[1024]["part"], runs[1024]["graph"]
    p = part.p
    # the m-element loads sum of _finalize: keyed_sum(assignment, w, p)
    a = cm.as_tensor(part.assignment, torch.int64, dev)
    keys, order = torch.sort(a, stable=True)
    w = cm.as_tensor(g.w, torch.float64, dev)[order].contiguous()
    loads = _time_shape("loads sum", w, keys, p)
    # the p^2-key star-comm sum of the interaction graphs
    owners, replicas, b = cm.star_triples(
        *part.replica_csr(), vertex_bytes_model(g), dev)
    keys, order = torch.sort(owners * p + replicas, stable=True)
    star = _time_shape("star-comm sum", b[order].contiguous(), keys, p * p)
    entry = {"name": "segment_sum", "route": "cuda",
             "source": "src/repro_torch/csrc/segsum.cu",
             "replaces": "src/repro/core/pallas/segsum.py:138",
             "launches": runs[1024]["launches"],
             "launches_p64": runs[64]["launches"],
             "max_abs_err": max_abs_err,
             **{k: loads[k] for k in ("ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by", "shape")},
             "plain_on": "host CPU, copies to and from the card included",
             "at_shapes": [loads, star]}
    check(segsum.launches > 0, "timing launched no kernel")
    return {"kernels": [entry]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    name = phase_device()
    phase_build()
    max_abs_err = phase_kernel_vs_plain()
    runs = phase_main_path()
    kernels = phase_timing(runs, max_abs_err)
    check(not any(m in sys.modules for m in ("jax", "repro")),
          "the port imported JAX or the JAX package")
    log(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
