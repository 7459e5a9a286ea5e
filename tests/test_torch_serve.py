"""The port's plan service (`repro_torch.serve`) and checkpoint store
(`repro_torch.checkpoint`) against the JAX package's (`repro.serve`,
`repro.checkpoint`) on the same inputs.

  * fingerprints are string-equal to the reference's for the same
    request;
  * a plan cache directory written by either package is a "disk" hit in
    the other, with the bundle equal array for array;
  * cold → memory → disk transitions and in-batch dedup;
  * the incremental planner's warm plan equals its cold recut across
    window boundaries, and the reference planner's plan;
  * `backend="cuda", device="cpu"` (the kernels' plain versions) equals
    `backend="fast"` for the service and the incremental planner;
  * LRU and byte-bound eviction, live `metrics()`, the CLI;
  * the checkpoint store's crash-recovery contract, and a nested
    dict/list state of torch tensors that either package restores.

The cases mirror `tests/test_serve.py`, the plan-cache and service cases
of `tests/test_metrics.py` and the checkpoint cases of
`tests/test_substrate.py`.  The JAX package is imported inside fixtures
only, so the `cuda` cases run where JAX is not installed.
"""
import io
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serve import (IncrementalPlanner, PlanRequest,  # noqa: E402
                               PlanService, plan_fingerprint)
from repro_torch.serve.cache import PlanBundle, PlanCache  # noqa: E402
from repro_torch.serve.fingerprint import (FP_VERSION,  # noqa: E402
                                           clear_stat_memo, content_digest,
                                           knob_digest)
from repro_torch.trace import ingest_trace, synthesize_trace  # noqa: E402
from repro_torch.trace.ingest import TraceSession  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
P = 16
LAM = 1.1
BUNDLE_ARRAYS = ("assignment", "loads", "edge_counts", "replica_indptr",
                 "replica_flat", "core_of", "core_times")
BUNDLE_SCALARS = ("exec_time", "comm_bytes", "graph_name", "n_vertices",
                  "total_weight", "p", "method", "lam")


@pytest.fixture(scope="module")
def ref():
    """The JAX package's serve and checkpoint modules."""
    serve = pytest.importorskip("repro.serve")
    import repro.checkpoint as checkpoint
    from repro.serve import __main__ as cli, fingerprint
    return types.SimpleNamespace(serve=serve, checkpoint=checkpoint,
                                 fingerprint=fingerprint, cli=cli)


@pytest.fixture(autouse=True)
def _obs_clean():
    obs.disable()
    yield
    obs.disable()


@pytest.fixture(scope="module")
def trace_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve") / "trace.ndjson")
    synthesize_trace(path, 12_000, seed=0)
    return path


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


def service(cache_dir, **kw):
    """A port service on the kernels' plain versions (no card here)."""
    return PlanService(cache_dir=str(cache_dir), device="cpu", **kw)


def assert_same_bundle(a, b):
    for f in BUNDLE_ARRAYS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in BUNDLE_SCALARS:
        assert getattr(a, f) == getattr(b, f), f


def assert_same_plan(a, b, rtol=0.0):
    """Two (graph, cut, mapping, report) plans."""
    _, cut, mapping, rep = a
    _, cut_b, mapping_b, rep_b = b
    for f in ("assignment", "loads", "edge_counts", "replica_indptr",
              "replica_flat"):
        x, y = getattr(cut, f), getattr(cut_b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    np.testing.assert_array_equal(mapping.core_of, mapping_b.core_of)
    np.testing.assert_array_equal(rep.core_times, rep_b.core_times)
    np.testing.assert_allclose(rep.exec_time, rep_b.exec_time, rtol=rtol)
    np.testing.assert_allclose(rep.data_comm_bytes, rep_b.data_comm_bytes,
                               rtol=rtol)


# ----------------------------- fingerprint ---------------------------- #
@pytest.mark.parametrize("kw", [
    dict(), dict(p=P + 1), dict(method="w_libra"), dict(lam=LAM + 0.1),
    dict(seed=1), dict(edge_order="trace"), dict(weight_model="unit"),
    dict(extras={"merge_period": 4096, "workers": 2}),
])
def test_fingerprint_equals_reference(ref, trace_path, kw):
    kw = {"p": P, "method": "wb_libra", "lam": LAM, **kw}
    p, method, lam = kw.pop("p"), kw.pop("method"), kw.pop("lam")
    got = plan_fingerprint(trace_path, p, method, lam, **kw)
    assert got == ref.serve.plan_fingerprint(trace_path, p, method, lam,
                                             **kw)
    assert got == plan_fingerprint(trace_path, p, method, lam,
                                   use_stat_memo=False, **kw)
    assert FP_VERSION == ref.fingerprint.FP_VERSION == 1
    assert knob_digest(p, method, lam, 0, "auto", "bytes") == \
        ref.fingerprint.knob_digest(p, method, lam, 0, "auto", "bytes")


def test_fingerprint_tracks_content(ref, tmp_path, trace_path):
    other = str(tmp_path / "other.ndjson")
    synthesize_trace(other, 12_000, seed=1)
    assert (plan_fingerprint(trace_path, P, "wb_libra", LAM)
            != plan_fingerprint(other, P, "wb_libra", LAM))
    g = T.IRGraph(n=4, src=np.array([0, 1]), dst=np.array([2, 3]),
                  w=np.array([1.0, 2.0]), name="a")
    g2 = T.IRGraph(n=4, src=np.array([0, 1]), dst=np.array([2, 3]),
                   w=np.array([1.0, 2.5]), name="a")
    assert content_digest(g) != content_digest(g2)
    from repro.core import IRGraph
    for gt in (g, g2, ingest_trace(trace_path)):
        assert content_digest(gt) == ref.fingerprint.content_digest(
            IRGraph(n=gt.n, src=gt.src, dst=gt.dst, w=gt.w, name=gt.name))


def test_fingerprint_stat_memo_skips_rehash(tmp_path):
    path = str(tmp_path / "t.ndjson")
    synthesize_trace(path, 1_000, seed=0)
    clear_stat_memo()
    d1 = content_digest(path)
    assert content_digest(path) == d1
    assert content_digest(path, use_stat_memo=False) == d1


# -------------------------- service / cache --------------------------- #
def test_service_cold_then_memory_then_disk(tmp_path, trace_path):
    cache = tmp_path / "plans"
    svc = service(cache)
    req = PlanRequest(source=trace_path, p=P, lam=LAM)
    r1 = svc.plan(req)
    assert r1.cache == "cold"
    r2 = svc.plan(req)
    assert r2.cache == "memory"
    assert_same_bundle(r2.bundle, r1.bundle)
    svc2 = service(cache)
    r3 = svc2.plan(req)
    assert r3.cache == "disk"
    assert_same_bundle(r3.bundle, r1.bundle)
    assert svc2.stats()["disk_entries"] == 1


@pytest.mark.parametrize("writer", ("port", "reference"))
def test_cache_directories_move_between_the_packages(ref, tmp_path,
                                                     trace_path, writer):
    """A directory written by either package is a disk hit in the other,
    with the bundle equal array for array to the reader's own cold one."""
    cache = str(tmp_path / "plans")
    req_kw = dict(source=trace_path, p=P, lam=LAM)
    if writer == "port":
        cold = service(cache).plan(PlanRequest(**req_kw))
        hit = ref.serve.PlanService(cache_dir=cache).plan(
            ref.serve.PlanRequest(**req_kw))
        own = ref.serve.PlanService(cache_dir=str(tmp_path / "own")).plan(
            ref.serve.PlanRequest(**req_kw))
    else:
        cold = ref.serve.PlanService(cache_dir=cache).plan(
            ref.serve.PlanRequest(**req_kw))
        hit = service(cache).plan(PlanRequest(**req_kw))
        own = service(tmp_path / "own").plan(PlanRequest(**req_kw))
    assert cold.cache == "cold" and hit.cache == "disk"
    assert hit.fingerprint == cold.fingerprint == own.fingerprint
    assert_same_bundle(hit.bundle, cold.bundle)
    assert_same_bundle(own.bundle, cold.bundle)
    assert hit.summary() == {**cold.summary(), "cache": "disk"}
    assert sorted(PlanCache(cache).fingerprints()) == \
        sorted(ref.serve.PlanCache(cache).fingerprints())


def test_service_bundle_matches_direct_pipeline(tmp_path, trace_path):
    r = service(tmp_path / "plans").plan(
        PlanRequest(source=trace_path, p=P, lam=LAM))
    cut = T.vertex_cut(ingest_trace(trace_path), P, method="wb_libra",
                       lam=LAM, backend="fast")
    np.testing.assert_array_equal(r.bundle.assignment, cut.assignment)
    assert r.bundle.replication_factor == pytest.approx(
        cut.replication_factor)


@pytest.mark.parametrize("source", ("ndjson", "rtb", "graph"))
def test_cuda_service_equals_fast_and_reference(ref, tmp_path, trace_path,
                                                source):
    """`backend="cuda", device="cpu"` plans cold what `backend="fast"`
    and the reference plan: cut, `core_of` and `core_times` bit for bit,
    the cost to rtol 1e-12."""
    g = ingest_trace(trace_path)
    rtb = str(tmp_path / "t.rtb")
    from repro_torch.trace import write_trace_bin
    write_trace_bin(rtb, g)
    src = {"ndjson": trace_path, "rtb": rtb, "graph": g}[source]
    cuda = service(tmp_path / "cuda").plan(PlanRequest(src, p=P, lam=LAM))
    fast = PlanService(cache_dir=str(tmp_path / "fast"), backend="fast",
                       device="cuda").plan(PlanRequest(src, p=P, lam=LAM))
    ref_src = src
    if source == "graph":
        from repro.core import IRGraph
        ref_src = IRGraph(n=g.n, src=g.src, dst=g.dst, w=g.w, name=g.name)
    want = ref.serve.PlanService(cache_dir=str(tmp_path / "ref")).plan(
        ref.serve.PlanRequest(ref_src, p=P, lam=LAM))
    assert cuda.fingerprint == fast.fingerprint == want.fingerprint
    for other in (fast, want):
        for f in BUNDLE_ARRAYS:
            np.testing.assert_array_equal(getattr(cuda.bundle, f),
                                          getattr(other.bundle, f),
                                          err_msg=f)
        np.testing.assert_allclose(cuda.bundle.exec_time,
                                   other.bundle.exec_time, rtol=1e-12)
        np.testing.assert_allclose(cuda.bundle.comm_bytes,
                                   other.bundle.comm_bytes, rtol=1e-12)


def test_plan_many_dedups_and_serves(tmp_path, trace_path):
    other = str(tmp_path / "other.ndjson")
    synthesize_trace(other, 4_000, seed=2)
    svc = service(tmp_path / "plans")
    reqs = [PlanRequest(source=trace_path, p=P, lam=LAM),
            PlanRequest(source=other, p=P, lam=LAM),
            PlanRequest(source=trace_path, p=P, lam=LAM)]  # duplicate
    out = svc.plan_many(reqs)
    assert [r.cache for r in out] == ["cold", "cold", "memory"]
    assert out[0].fingerprint == out[2].fingerprint
    assert out[0].fingerprint != out[1].fingerprint
    assert_same_bundle(out[2].bundle, out[0].bundle)
    assert svc.stats() == {**svc.stats(), "hits": 1, "misses": 2}
    again = svc.plan_many(reqs[:2])
    assert [r.cache for r in again] == ["memory", "memory"]


def test_default_service_asks_for_the_card(tmp_path, trace_path, no_gpu):
    """Cold plans default to the card and raise without one; a hit
    touches no card."""
    cache = str(tmp_path / "plans")
    req = PlanRequest(source=trace_path, p=P, lam=LAM)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        PlanService(cache_dir=cache).plan(req)
    service(cache).plan(req)
    assert PlanService(cache_dir=cache).plan(req).cache == "disk"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        IncrementalPlanner(p=P).plan()


# ----------------------------- LRU cache ------------------------------ #
def _bundle(tag: int) -> PlanBundle:
    return PlanBundle(
        assignment=np.full(16, tag, np.int32),
        loads=np.ones(4), edge_counts=np.full(4, 4, np.int64),
        replica_indptr=np.arange(9, dtype=np.int64),
        replica_flat=np.zeros(8, np.int32),
        core_of=np.arange(4), core_times=np.ones(4),
        exec_time=1.0, comm_bytes=2.0, graph_name=f"g{tag}",
        n_vertices=8, total_weight=16.0, p=4, method="wb_libra", lam=1.0)


def test_plan_cache_lru_eviction_counts(tmp_path):
    reg = MetricsRegistry()
    cache = PlanCache(str(tmp_path / "plans"), max_entries=2, metrics=reg)
    for i in range(3):
        cache.put(f"fp{i}", _bundle(i))
    assert list(cache._hot) == ["fp1", "fp2"]
    assert cache.evictions == 1
    assert reg.snapshot()["counters"]["serve.cache.evictions"] == 1
    got = cache.get("fp0")                  # an evicted bundle reloads
    assert got is not None and got.graph_name == "g0"
    assert_same_bundle(got, _bundle(0))
    assert list(cache._hot) == ["fp2", "fp0"]
    assert cache.evictions == 2
    cache.get("fp2")
    cache.put("fp3", _bundle(3))
    assert list(cache._hot) == ["fp2", "fp3"]
    assert cache.hot_bytes == sum(
        cache._bundle_nbytes(b) for b in cache._hot.values())


def test_plan_cache_byte_bound(ref, tmp_path):
    one = PlanCache._bundle_nbytes(_bundle(0))
    cache = PlanCache(str(tmp_path / "plans"), max_bytes=2 * one)
    for i in range(3):
        cache.put(f"fp{i}", _bundle(i))
    assert len(cache._hot) == 2
    assert cache.hot_bytes <= 2 * one
    assert cache.evictions == 1
    # the reference reads the bundles the port's cache wrote
    theirs = ref.serve.PlanCache(str(tmp_path / "plans")).get("fp0")
    assert_same_bundle(theirs, _bundle(0))


def test_service_metrics_live_snapshot(tmp_path, trace_path):
    svc = service(tmp_path / "plans")
    req = PlanRequest(source=trace_path, p=8, lam=1.1)
    for _ in range(3):
        svc.plan(req)
    m = svc.metrics()
    assert m["plans"] == 3 and m["hits"] == 2 and m["misses"] == 1
    assert m["hit_rate"] == round(2 / 3, 4)
    assert m["tiers"]["cold"]["count"] == 1
    assert m["tiers"]["memory"]["count"] == 2
    assert m["plan_latency_p99_us"] >= m["plan_latency_p50_us"] > 0
    assert m["tiers"]["memory"]["p99_us"] < m["tiers"]["cold"]["p50_us"]
    assert m["plans_per_s"] > 0 and m["uptime_s"] > 0
    assert m["evictions"] == 0
    assert obs.current() is None            # the registry is always on


def test_service_bounded_hot_map_evicts_and_recovers(tmp_path, trace_path):
    other = str(tmp_path / "other.ndjson")
    synthesize_trace(other, 8_000, seed=3)
    svc = service(tmp_path / "plans", max_hot_entries=1)
    r_a = svc.plan(PlanRequest(source=trace_path, p=8, lam=1.1))
    svc.plan(PlanRequest(source=other, p=8, lam=1.1))
    m = svc.metrics()
    assert m["evictions"] == 1 and m["hot_entries"] == 1
    r2 = svc.plan(PlanRequest(source=trace_path, p=8, lam=1.1))
    assert r2.cache == "disk"
    assert_same_bundle(r2.bundle, r_a.bundle)
    m = svc.metrics()
    assert m["misses"] == 2 and m["tiers"]["disk"]["count"] == 1
    assert svc.registry.snapshot()["counters"]["serve.plans.disk"] == 1


def test_zipf_mix_equals_reference(ref, tmp_path):
    """A small Zipf request mix over an LRU-bounded hot map: the tier of
    every response, the hit rate and the evictions are the reference's."""
    paths = []
    for i in range(4):
        p = str(tmp_path / f"s{i}.ndjson")
        synthesize_trace(p, 600, seed=100 + i)
        paths.append(p)
    pop = 1.0 / np.arange(1, 5) ** 1.2
    picks = np.random.default_rng(0).choice(4, size=40, p=pop / pop.sum())
    svc = service(tmp_path / "port", max_hot_entries=2)
    theirs = ref.serve.PlanService(cache_dir=str(tmp_path / "ref"),
                                   max_hot_entries=2)
    tiers, ref_tiers = [], []
    for i in picks:
        tiers.append(svc.plan(PlanRequest(paths[i], p=8, lam=LAM)).cache)
        ref_tiers.append(theirs.plan(
            ref.serve.PlanRequest(paths[i], p=8, lam=LAM)).cache)
    assert tiers == ref_tiers
    m, m_ref = svc.metrics(), theirs.metrics()
    for key in ("plans", "hits", "misses", "hit_rate", "evictions",
                "hot_entries", "hot_bytes"):
        assert m[key] == m_ref[key], key
    assert {t: v["count"] for t, v in m["tiers"].items()} == \
        {t: v["count"] for t, v in m_ref["tiers"].items()}
    assert m["evictions"] > 0


# ------------------------ incremental planner ------------------------- #
def test_trace_session_matches_one_shot(trace_path):
    lines = open(trace_path).read().splitlines(keepends=True)
    sess = TraceSession()
    sess.feed(io.StringIO("".join(lines[:5_000])))
    sess.feed(io.StringIO("".join(lines[5_000:])))
    g_inc = sess.graph("t")
    g_one = ingest_trace(trace_path, name="t")
    assert g_inc.n == g_one.n
    for f in ("src", "dst", "w"):
        np.testing.assert_array_equal(getattr(g_inc, f), getattr(g_one, f))


def test_incremental_single_quantum_matches_vertex_cut(trace_path):
    pl = IncrementalPlanner(p=P, method="wb_libra", lam=LAM,
                            quantum=1 << 22, device="cpu")
    pl.append(trace_path)
    _, cut, _, _ = pl.plan()
    want = T.vertex_cut(ingest_trace(trace_path), P, method="wb_libra",
                        lam=LAM, edge_order="trace", backend="fast")
    for f in ("assignment", "replica_indptr", "replica_flat", "loads",
              "edge_counts"):
        np.testing.assert_array_equal(getattr(cut, f), getattr(want, f))


@pytest.mark.parametrize("method", ["libra", "w_libra", "wb_libra"])
def test_incremental_window_invariance_and_reference(ref, trace_path,
                                                     method):
    """Warm incremental == cold over the concatenated trace, bit for bit,
    and == the reference planner fed the same windows."""
    lines = open(trace_path).read().splitlines(keepends=True)
    plans = []
    windows = [[len(lines)],
               [7_000, len(lines)],
               [2_000, 5_000, 9_000, len(lines)]]
    for bounds in windows:
        pl = IncrementalPlanner(p=P, method=method, lam=LAM, quantum=2048,
                                device="cpu")
        start = 0
        for end in bounds:
            pl.append(io.StringIO("".join(lines[start:end])))
            start = end
            pl.plan()        # interleaved plans must not perturb state
        plans.append(pl.plan())
    cold = plans[0]
    for warm in plans[1:]:
        assert_same_plan(warm, cold)
    theirs = ref.serve.IncrementalPlanner(p=P, method=method, lam=LAM,
                                          quantum=2048)
    theirs.append(io.StringIO("".join(lines[:7_000])))
    theirs.append(io.StringIO("".join(lines[7_000:])))
    assert_same_plan(cold, theirs.plan(), rtol=1e-12)


@pytest.mark.parametrize("backend", ("cuda", "fast", "native", "python"))
def test_incremental_backends_equal_fast(trace_path, backend):
    """The `cuda` planner streams on the fast engine and runs
    `finish_plan` on the device (here the plain versions): bit-identical
    to `backend="fast"`, as every host engine is."""
    from repro_torch.core._native import native_available
    if backend == "native" and not native_available():
        pytest.skip("no C compiler for the native engine")
    lines = open(trace_path).read().splitlines(keepends=True)
    plans = []
    for b in ("fast", backend):
        pl = IncrementalPlanner(p=P, lam=LAM, quantum=4096, backend=b,
                                device="cpu")
        pl.append(io.StringIO("".join(lines[:9_000])))
        pl.append(io.StringIO("".join(lines[9_000:])))
        plans.append(pl.plan())
    assert_same_plan(plans[1], plans[0], rtol=1e-12)
    np.testing.assert_array_equal(plans[1][3].core_times,
                                  plans[0][3].core_times)


def test_incremental_rejects_like_reference(ref):
    for kw in (dict(method="wb_pg"), dict(lam=0.5), dict(p=0),
               dict(quantum=0)):
        kw = {"p": 4, **kw}
        with pytest.raises(ValueError) as want:
            ref.serve.IncrementalPlanner(**kw)
        with pytest.raises(ValueError) as got:
            IncrementalPlanner(device="cpu", **kw)
        assert str(got.value) == str(want.value)


# -------------------------------- CLI --------------------------------- #
def test_cli_plan_cache_and_reference(ref, tmp_path, trace_path, capsys):
    from repro_torch.serve.__main__ import main
    cache = str(tmp_path / "plans")
    args = ["plan", trace_path, "-p", str(P), "--lam", str(LAM)]
    assert main(["--cache-dir", cache, "--device", "cpu"] + args) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["cache"] == "cold" and doc["p"] == P
    assert ref.cli.main(["--cache-dir", str(tmp_path / "r")] + args) == 0
    assert doc == json.loads(capsys.readouterr().out)
    assert main(["--cache-dir", cache] + args) == 0    # a hit: no card
    assert json.loads(capsys.readouterr().out)["cache"] == "disk"
    assert main(["--cache-dir", cache, "cache"]) == 0
    assert doc["fingerprint"] in capsys.readouterr().out


def test_cli_batch_and_metrics(ref, tmp_path, trace_path, capsys):
    from repro_torch.serve.__main__ import main
    reqs = str(tmp_path / "reqs.json")
    with open(reqs, "w") as f:
        json.dump([{"source": trace_path, "p": P, "lam": LAM},
                   {"source": trace_path, "p": P, "lam": LAM}], f)
    assert main(["--cache-dir", str(tmp_path / "plans"), "--device", "cpu",
                 "batch", reqs]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert [r["cache"] for r in doc["responses"]] == ["cold", "memory"]
    assert doc["stats"]["hits"] == 1 and doc["stats"]["misses"] == 1
    assert ref.cli.main(["--cache-dir", str(tmp_path / "r"), "batch",
                         reqs]) == 0
    theirs = json.loads(capsys.readouterr().out)
    assert doc["responses"] == theirs["responses"]
    assert main(["--cache-dir", str(tmp_path / "m"), "--device", "cpu",
                 "metrics", reqs]) == 0
    m = json.loads(capsys.readouterr().out)
    assert m["plans"] == 2 and m["hits"] == 1 and m["hit_rate"] == 0.5
    assert m["tiers"]["cold"]["count"] == 1
    assert main(["--cache-dir", str(tmp_path / "m"), "metrics"]) == 0
    m = json.loads(capsys.readouterr().out)
    assert m["plans"] == 0 and m["hit_rate"] == 0.0
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump({"source": trace_path}, f)
    assert main(["--cache-dir", str(tmp_path / "m"), "batch", bad]) == 1


def test_cli_runs_as_a_module(tmp_path, trace_path):
    """`python -m repro_torch.serve` in a process that imports only the
    port."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "repro_torch.serve",
         "--cache-dir", str(tmp_path / "plans"), "--device", "cpu", "plan",
         trace_path, "-p", "8"], capture_output=True, text=True, env=env,
        timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["cache"] == "cold"
    imported = {line.split("|")[-1].strip()
                for line in r.stderr.splitlines() if "|" in line}
    assert not any(m == "jax" or m == "repro" or m.startswith(
        ("repro.", "jax.")) for m in imported)


# ---------------------------- checkpoint ------------------------------ #
def _state():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "b": [torch.ones(3, dtype=torch.float64),
                             torch.tensor([1, 2], dtype=torch.int32)]},
            "opt": (torch.zeros(2, 2), None, np.arange(4)),
            "step": torch.tensor(7)}


def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = _state()
    for s in (10, 20, 30):
        mgr.save(s, state, meta={"loss": 1.0})
    assert mgr.all_steps() == [20, 30]
    restored, meta = mgr.restore(state)
    assert meta["step"] == 30 and meta["loss"] == 1.0
    assert restored["opt"][1] is None
    assert isinstance(restored["opt"], tuple)
    for path in (("params", "w"), ("step",)):
        a, b = restored, state
        for k in path:
            a, b = a[k], b[k]
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(a, b)
    assert restored["params"]["b"][1].dtype == torch.int32
    np.testing.assert_array_equal(restored["opt"][2], np.arange(4))


def test_checkpoint_keys_are_the_reference_flatten_keys(ref, tmp_path):
    """The nested torch state flattens to the keys `jax.tree_util` gives
    the same tree, so each package restores the other's directory."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.checkpoint import store as ref_store
    state = _state()
    want = ref_store._flatten(
        {"params": {"w": np.arange(6.0).reshape(2, 3),
                    "b": [np.ones(3), np.array([1, 2], np.int32)]},
         "opt": (np.zeros((2, 2)), None, np.arange(4)),
         "step": np.array(7)})
    from repro_torch.checkpoint import store
    got = store._flatten(store._map_tree(store._to_host, state))
    assert list(got) == list(want)
    # port writes, the reference restores into a jax template
    CheckpointManager(str(tmp_path / "port"), keep=1).save(3, state)
    template = {"params": {"w": jnp.zeros((2, 3)),
                           "b": [jnp.zeros(3), jnp.zeros(2, jnp.int32)]},
                "opt": (jnp.zeros((2, 2)), None, jnp.zeros(4, jnp.int32)),
                "step": jnp.int32(0)}
    theirs, meta = ref.checkpoint.CheckpointManager(
        str(tmp_path / "port")).restore(template)
    assert meta["step"] == 3
    np.testing.assert_array_equal(np.asarray(theirs["params"]["w"]),
                                  state["params"]["w"].numpy())
    np.testing.assert_array_equal(np.asarray(theirs["params"]["b"][1]),
                                  [1, 2])
    # the reference writes jax arrays, the port restores torch tensors
    ref.checkpoint.CheckpointManager(str(tmp_path / "ref")).save(
        5, template, meta={"tag": "x"})
    mine, meta = CheckpointManager(str(tmp_path / "ref")).restore(state)
    assert meta["step"] == 5 and meta["tag"] == "x"
    assert torch.equal(mine["params"]["w"], torch.zeros(2, 3))
    assert mine["params"]["b"][1].dtype == torch.int32
    flat, _ = CheckpointManager(str(tmp_path / "ref")).restore_flat()
    assert sorted(flat) == sorted(got)


def test_checkpoint_async_save_copies_the_state(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    w = torch.ones(4)
    mgr.save(5, {"w": w}, blocking=False)
    w.add_(1.0)                     # an update after save() returns
    mgr.wait()
    assert mgr.latest_step() == 5
    flat, _ = mgr.restore_flat()
    np.testing.assert_array_equal(flat["w"], np.ones(4))


def test_checkpoint_crash_between_commit_and_rename(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    state = {"w": torch.arange(4.0)}
    mgr.save(5, state)
    stale = tmp_path / "step_00000010.tmp"
    stale.mkdir()
    (stale / "COMMIT").touch()
    assert mgr.all_steps() == [5]
    _, meta = mgr.restore(state)
    assert meta["step"] == 5
    mgr.save(7, state)
    assert mgr.all_steps() == [5, 7]
    mgr2 = CheckpointManager(str(tmp_path), keep=3)
    assert not stale.exists()
    mgr2.save(10, state)
    assert mgr2.all_steps() == [5, 7, 10]


def test_checkpoint_step_names_are_strict(tmp_path):
    """Only `step_<digits>` with a COMMIT counts, and only its `.tmp`
    staging twin is collected."""
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, {"w": torch.ones(2)})
    for name in ("step_2x", "step_", "xstep_3", "step_00000004.tmp.bak"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "COMMIT").touch()
    (tmp_path / "step_00000009").mkdir()          # no COMMIT
    (tmp_path / "notes.tmp").mkdir()
    assert mgr.all_steps() == [1]
    CheckpointManager(str(tmp_path), keep=5)
    assert (tmp_path / "notes.tmp").exists()
    assert (tmp_path / "step_2x").exists()


def test_checkpoint_async_save_error_propagates(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    mgr.dir = str(tmp_path / "blocked")
    open(mgr.dir, "w").close()
    mgr.save(1, {"w": torch.ones(2)}, blocking=False)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.dir = str(tmp_path / "ck")
    mgr.save(2, {"w": torch.ones(2)}, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 2


def test_checkpoint_restore_flat_and_errors(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore_flat()
    mgr.save(3, {"a": np.arange(5), "b": torch.ones(2, 2)},
             meta={"tag": "x"})
    flat, meta = mgr.restore_flat()
    assert meta["step"] == 3 and meta["tag"] == "x"
    np.testing.assert_array_equal(flat["a"], np.arange(5))
    np.testing.assert_array_equal(flat["b"], np.ones((2, 2)))
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({"a": torch.zeros(6), "b": torch.zeros(2, 2)})
    with pytest.raises(KeyError, match="missing leaf c"):
        mgr.restore({"a": torch.zeros(5), "c": torch.zeros(1)})


# ------------------------------ on the card --------------------------- #
def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    from repro_torch.core.cuda import segsum
    return segsum


@pytest.mark.cuda
def test_service_cold_plan_on_the_card_equals_fast(tmp_path, trace_path):
    segsum = _on_card()
    req = PlanRequest(source=trace_path, p=P, lam=LAM)
    fast = PlanService(cache_dir=str(tmp_path / "fast"),
                       backend="fast").plan(req)
    svc = PlanService(cache_dir=str(tmp_path / "cuda"))
    segsum.launches = 0
    cold = svc.plan(req)
    assert cold.cache == "cold" and segsum.launches > 0
    segsum.launches = 0
    assert svc.plan(req).cache == "memory"
    assert PlanService(cache_dir=str(tmp_path / "cuda")).plan(
        req).cache == "disk"
    assert segsum.launches == 0
    for f in BUNDLE_ARRAYS:
        np.testing.assert_array_equal(getattr(cold.bundle, f),
                                      getattr(fast.bundle, f), err_msg=f)
    np.testing.assert_allclose(cold.bundle.exec_time, fast.bundle.exec_time,
                               rtol=1e-12)


@pytest.mark.cuda
def test_incremental_planner_on_the_card_equals_fast(trace_path):
    segsum = _on_card()
    lines = open(trace_path).read().splitlines(keepends=True)
    plans = []
    for backend in ("fast", "cuda"):
        pl = IncrementalPlanner(p=P, lam=LAM, quantum=2048, backend=backend)
        pl.append(io.StringIO("".join(lines[:7_000])))
        pl.append(io.StringIO("".join(lines[7_000:])))
        segsum.launches = 0
        plans.append(pl.plan())
        assert (segsum.launches > 0) == (backend == "cuda")
    assert_same_plan(plans[1], plans[0], rtol=1e-12)
