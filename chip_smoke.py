"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line(s):

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them;
2. build: compile `src/repro_torch/csrc/*.cu` with nvcc for sm_90a, one
   nvcc per source, all at once;
3. kernels: the segment-sum kernel against its plain version and
   `np.add.at`, exactly, on float64 and int64 layouts (empty segments,
   one segment of millions of elements, p, p+1 and p^2+1 segments at
   p=1024, a random sorted layout from a fixed seed);
4. partition path: `run_pipeline(..., backend="cuda")` on the
   n=3,000,000 power-law graph (5,528,199 edges) at p=1024 and p=64,
   held against the port's host engine `backend="fast"` (cut, replica
   CSR, core_of and core_times bit-identical; exec_time and
   data_comm_bytes to rtol 1e-12), with the kernel's launch count read
   around each run;
5. model kernels: flash attention on the shapes of the JAX package's
   `FA_CASES` and at the serving shape (B=2, S=3072, 16 heads, 1 kv head,
   head_dim 256, causal, window 2048), and the RG-LRU scan at the serving
   shape (B=2, S=3072, D=4096, with and without h0) and at D=96, each
   against its plain version (float32 2e-5, bfloat16 2e-2, RG-LRU 1e-5);
6. prefill path: recurrentgemma-9b at full width and depth (9,396,195,328
   float32 parameters from a seeded generator) runs `make_prefill_step`
   on 2 prompts of 3,072 tokens, with the launch counts of both kernels
   read around the run (12 flash attention, 26 RG-LRU) and finite logits;
7. serving path: the port's launcher (`repro_torch.launch.serve.serve`)
   with the JAX launcher's defaults (batch 4, prompt 32, generate 32) at
   full width; its logits after replaying the prompt are held against
   `prefill` on the same prompts (1e-3);
8. timing: each kernel, its plain version and, where one exists, one
   PyTorch call computing the same function (timed only, as a
   yardstick) at the main paths' largest shapes, then one JSON line
   `{"kernels": [...]}`.

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

# H100 SXM (NVIDIA data sheet): 3.35 TB/s HBM3; 34 TFLOP/s float64 and
# 67 TFLOP/s float32 outside the tensor cores (the kernels' arithmetic)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_OPS_PER_S = 34e12
PEAK_F32_OPS_PER_S = 67e12

ARCH = "recurrentgemma-9b"
N_PARAMS = 9_396_195_328
PREFILL_B, PREFILL_S = 2, 3072
# the serving shape of one attention layer and one recurrent layer
FA_MAIN = (PREFILL_B, PREFILL_S, PREFILL_S, 16, 1, 256, True, 2048, None,
           "float32")
RG_MAIN = (PREFILL_B, PREFILL_S, 4096)
# tests/test_kernels.py::FA_CASES:
# (B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, dtype)
FA_CASES = [
    (2, 128, 128, 4, 2, 64, True, None, None, "float32"),
    (1, 256, 256, 8, 1, 64, True, 64, None, "float32"),
    (2, 64, 64, 4, 4, 128, True, None, 50.0, "float32"),
    (1, 100, 100, 2, 2, 64, False, None, None, "float32"),
    (1, 192, 320, 4, 2, 64, True, None, None, "float32"),
    (2, 128, 128, 4, 2, 64, True, None, None, "bfloat16"),
    (1, 128, 128, 6, 3, 32, True, 32, 30.0, "float32"),
]
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
RG_TOL = 1e-5
SERVE_TOL = 1e-3

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
# 4. the partition path
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
# 5. the model kernels against their plain versions
# ---------------------------------------------------------------------- #
def _fa_inputs(case, seed: int = 0):
    B, Sq, Sk, Hq, Hkv, D, _, _, _, dt = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    dtype = getattr(torch, dt)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((B, Sq, Hq, D), (B, Sk, Hkv, D),
                               (B, Sk, Hkv, D)))


def _rg_inputs(B: int, S: int, D: int, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, S, D), generator=g, device="cuda")
    a = torch.rand((B, S, D), generator=g, device="cuda") * 0.94 + 0.05
    h0 = torch.randn((B, D), generator=g, device="cuda")
    return x, a, h0


def phase_model_kernels_vs_plain() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru
    worst = {}
    for case in FA_CASES + [FA_MAIN]:
        causal, window, cap, dt = case[6:]
        q, k, v = _fa_inputs(case)
        got = fa.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=cap)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, softcap=cap)
        check(got.dtype == q.dtype and got.shape == q.shape,
              f"flash attention {case}: dtype or shape")
        err = float((got.float() - want.float()).abs().max())
        check(err <= FA_TOL[dt], f"flash attention {case}: error {err!r}")
        if case is FA_MAIN:
            worst["flash_attention"] = err
        log(f"kernel flash_attention {case}: max abs error {err!r} "
            f"(tolerance {FA_TOL[dt]})")
        del q, k, v, got, want
    for B, S, D in (RG_MAIN, (1, 33, 96)):
        x, a, h0 = _rg_inputs(B, S, D)
        for init in (None, h0):
            h, last = rglru.rglru_scan(x, a, init)
            torch.cuda.synchronize()
            want_h, want_last = rglru.rglru_plain(x, a, init)
            err = max(float((h - want_h).abs().max()),
                      float((last - want_last).abs().max()))
            check(err <= RG_TOL, f"rglru {B, S, D}: error {err!r}")
            if (B, S, D) == RG_MAIN:
                worst["rglru"] = max(worst.get("rglru", 0.0), err)
            log(f"kernel rglru B={B} S={S} D={D} "
                f"h0={'given' if init is not None else 'none'}: max abs "
                f"error {err!r} (tolerance {RG_TOL})")
    torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------------- #
# 6. the prefill path at full width
# ---------------------------------------------------------------------- #
def _build_model(seed: int = 0):
    from repro_torch import models
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    model = models.Model(cfg, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(seed))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log(f"model {cfg.name}: {n} float32 parameters "
        f"({n * 4 / 1e9:.3f} GB) built on the card in "
        f"{time.perf_counter() - t0:.3f} s; layers "
        f"{''.join(k[0] for k in model.kinds)} (r = rec, a = attn)")
    check(n == N_PARAMS, f"expected {N_PARAMS} parameters, built {n}")
    return model


def phase_prefill() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru
    from repro_torch.launch.steps import make_prefill_step
    model = _build_model()
    kinds = model.kinds
    check(kinds.count("attn") == 12 and kinds.count("rec") == 26,
          "recurrentgemma-9b must have 12 attention and 26 recurrent layers")
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(
        0, model.cfg.vocab_size, (PREFILL_B, PREFILL_S))).cuda()
    step = make_prefill_step(model.cfg)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fa.launches = rglru.launches = 0
    t0 = time.perf_counter()
    logits = step(model, {"tokens": tokens})
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches, "rglru": rglru.launches}
    check(launches == {"flash_attention": 12, "rglru": 26},
          f"prefill launches {launches}, expected 12 and 26")
    check(tuple(logits.shape) == (PREFILL_B, model.cfg.vocab_size),
          "prefill logits shape")
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    t0 = time.perf_counter()
    again = step(model, {"tokens": tokens})
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    rerun_diff = float((again - logits).abs().max())
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"prefill path B={PREFILL_B} S={PREFILL_S}: launches "
        f"{json.dumps(launches)}, logits finite, |logits| max "
        f"{float(logits.abs().max())!r}, second run differs by "
        f"{rerun_diff!r}")
    log(f"prefill wall (host clock after synchronize): first "
        f"{first_s:.6f} s, second {second_s:.6f} s "
        f"({PREFILL_B * PREFILL_S / second_s:.1f} prompt tokens/s); peak "
        f"device memory {peak:.3f} GB")
    del model, logits, again
    torch.cuda.empty_cache()
    return {"launches": launches, "first_s": first_s, "second_s": second_s}


# ---------------------------------------------------------------------- #
# 7. the serving path at full width
# ---------------------------------------------------------------------- #
def phase_serve() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls must stay off: the checks are float32")
    fa.launches = rglru.launches = 0
    out = serve(get_config(ARCH), device="cuda")
    serve_launches = {"flash_attention": fa.launches,
                      "rglru": rglru.launches}
    gen = out["generated"]
    check(tuple(gen.shape) == (4, 32) and gen.dtype == torch.int32,
          "generated ids shape or dtype")
    check(bool(((gen >= 0) & (gen < out["model"].cfg.vocab_size)).all()),
          "generated ids outside the vocabulary")
    fa.launches = rglru.launches = 0
    last = make_prefill_step(out["model"].cfg)(
        out["model"], {"tokens": out["prompts"]})
    torch.cuda.synchronize()
    check(fa.launches == 12 and rglru.launches == 26,
          "the comparison prefill did not run the kernels")
    err = float((last - out["last_logits"]).abs().max())
    check(err <= SERVE_TOL,
          f"prefill vs prompt replay: max abs difference {err!r}")
    log(f"serving path: prefill (prompt replay) "
        f"{out['prefill_s'] * 1e3:.3f} ms, decode "
        f"{out['gen_s'] / gen.shape[1] * 1e3:.3f} ms/step, "
        f"{out['tok_per_s']:.3f} tok/s; launches in the launcher "
        f"{json.dumps(serve_launches)} (its decode computes attention and "
        f"the recurrence inline, as the JAX launcher's does)")
    log(f"serving first generated ids: {gen[0, :16].tolist()}")
    log(f"prefill vs prompt replay, last-position logits: max abs "
        f"difference {err!r} (tolerance {SERVE_TOL}); "
        f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32} (no "
        f"convolution runs)")
    del out, last
    torch.cuda.empty_cache()
    return {"max_abs_diff": err}


# ---------------------------------------------------------------------- #
# 8. timing of the segment sum at the partition path's largest shapes
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


# ---------------------------------------------------------------------- #
# 8b. timing of the model kernels at the serving shapes
# ---------------------------------------------------------------------- #
def _fa_bound(case) -> tuple[float, str]:
    """Least time for one flash attention call: its unmasked (query, key)
    pairs at 4*D float32 operations each over the float32 peak, against
    q, k, v read once and the output written once over the memory rate."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, _, dt = case
    pos = np.arange(Sq)[:, None]
    kp = np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= kp <= pos
    if window is not None:
        ok &= kp > pos - window
    pairs = int(ok.sum()) * B * Hq
    size = torch.tensor([], dtype=getattr(torch, dt)).element_size()
    nbytes = size * (2 * B * Sq * Hq * D + 2 * B * Sk * Hkv * D)
    t_ops = 4 * D * pairs / PEAK_F32_OPS_PER_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_model_timing(prefill: dict, errs: dict) -> list[dict]:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru
    F = torch.nn.functional
    causal, window, cap, _ = FA_MAIN[6:]
    q, k, v = _fa_inputs(FA_MAIN)
    ms = _cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                             window=window, softcap=cap),
                  reps=10)
    plain_ms = _host_ms(lambda: fa.flash_attention_plain(
        q, k, v, causal=causal, window=window, softcap=cap))
    # the yardstick: one PyTorch call with an explicit causal+window mask
    S = FA_MAIN[1]
    pos = torch.arange(S, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = _cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), reps=10)
    bound_ms, bound_by = _fa_bound(FA_MAIN)
    fa_entry = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29",
        "launches": prefill["launches"]["flash_attention"],
        "max_abs_err": errs["flash_attention"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "shape": "q [2,3072,16,256] k/v [2,3072,1,256] float32, causal, "
                 "window 2048",
        "library": "scaled_dot_product_attention, explicit bool mask, "
                   "enable_gqa",
        "plain_on": "the card (attention_ref: einsum, mask, softmax)"}
    del q, k, v, qt, kt, vt, mask
    torch.cuda.empty_cache()

    B, S, D = RG_MAIN
    x, a, _ = _rg_inputs(B, S, D)
    ms = _cuda_ms(lambda: rglru.rglru_scan(x, a), reps=10)
    plain_ms = _host_ms(lambda: rglru.rglru_plain(x, a))
    n = B * S * D
    t_bytes = 4 * (3 * n + B * D) / PEAK_BYTES_PER_S * 1e3
    t_ops = 8 * n / PEAK_F32_OPS_PER_S * 1e3
    rg_entry = {
        "name": "rglru", "route": "cuda",
        "source": "src/repro_torch/csrc/rglru.cu",
        "replaces": "src/repro/kernels/rglru.py:25",
        "launches": prefill["launches"]["rglru"],
        "max_abs_err": errs["rglru"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "library": "none: no single PyTorch call computes the recurrence",
        "shape": "x, a [2,3072,4096] float32, no h0",
        "plain_on": "the card (rglru_ref: one step of elementwise ops "
                    "per time step)"}
    for e in (fa_entry, rg_entry):
        log(f"timing {e['name']} at {e['shape']}: kernel {e['ms']!r} ms, "
            f"plain {e['plain_ms']!r} ms, bound {e['bound_ms']!r} ms "
            f"({e['bound_by']}), library {e['library_ms']!r} ms")
    return [fa_entry, rg_entry]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    t_start = time.perf_counter()
    name = phase_device()
    phase_build()
    max_abs_err = phase_kernel_vs_plain()
    runs = phase_main_path()
    errs = phase_model_kernels_vs_plain()
    prefill = phase_prefill()
    phase_serve()
    kernels = phase_timing(runs, max_abs_err)
    kernels["kernels"] += phase_model_timing(prefill, errs)
    check(not any(m in sys.modules for m in ("jax", "repro")),
          "the port imported JAX or the JAX package")
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
