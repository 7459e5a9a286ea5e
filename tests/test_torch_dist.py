"""The port's sharded partitioner (`repro_torch.dist`) against the JAX
package's (`repro.dist`) on the same inputs.

The determinism contract of the reference, held across the two packages:

  * `workers=1` is bit-identical to the port's own single-stream `fast`
    engine, for the raw cut and through `run_pipeline(backend="dist")`;
  * `workers>1` gives the reference's assignment, loads, edge counts and
    replica CSR for the same (graph, p, method, lam, seed, W,
    merge_period, divergence), on the serial, thread and process pools,
    in the two-phase and the pipelined dataflows, for any parse-shard
    count and round size;
  * the sharded parse gives the reference's graph and the port's
    streaming ingester's graph (plain, `.gz`, `.zst`, `.rtb`, labels,
    skipped lines, byte ranges);
  * the merge helpers, the shard state and the warnings (class, text,
    the caller's line) are the reference's.

The cases mirror `tests/test_dist.py` and `tests/test_dist_property.py`.
The JAX package is imported inside the `ref` fixture only, so the `cuda`
case runs where JAX is not installed.
"""
import gzip
import json
import os
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core._arrayops import (masks_to_replica_csr,  # noqa: E402
                                        merge_deltas, merge_limb_masks,
                                        replica_csr)
from repro_torch.core._native import native_available  # noqa: E402
from repro_torch.dist import (dist_ingest, dist_ingest_with_stats,  # noqa: E402
                              dist_vertex_cut, shard_bounds,
                              shard_byte_ranges)
from repro_torch.trace import (ingest_trace_with_stats,  # noqa: E402
                               synthesize_trace, write_trace_bin)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
METHODS = ("wb_libra", "w_pg", "pg", "libra")
CUT_FIELDS = ("assignment", "loads", "edge_counts", "replica_indptr",
              "replica_flat")


@pytest.fixture(scope="module")
def ref():
    """The JAX package's dist, trace and core modules."""
    dist = pytest.importorskip("repro.dist")
    import repro.core as core
    import repro.trace as trace
    from repro.core import _arrayops as arrayops
    return types.SimpleNamespace(dist=dist, core=core, trace=trace,
                                 arrayops=arrayops)


@pytest.fixture(autouse=True)
def _obs_clean():
    obs.disable()
    yield
    obs.disable()


@pytest.fixture(scope="module")
def graph():
    return T.synthesize_powerlaw_graph(n=4000, alpha=2.2, seed=1)


@pytest.fixture(scope="module")
def ref_graph(ref, graph):
    return ref.core.IRGraph(n=graph.n, src=graph.src, dst=graph.dst,
                            w=graph.w, name=graph.name)


@pytest.fixture(scope="module")
def trace_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("traces") / "synth.ndjson"
    synthesize_trace(str(path), 20_000, seed=0)
    return str(path)


def assert_same_cut(a, b):
    for f in CUT_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.replication_factor == b.replication_factor


def assert_same_graph(a, b):
    assert a.n == b.n
    for f in ("src", "dst", "w"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def stats_no_peak(stats):
    d = stats.summary()
    d.pop("peak_chunk_edges")       # per-shard buffer high-water mark
    d.pop("engine")                 # provenance tag, not a semantic stat
    return d


def assert_same_raise(port_call, ref_call):
    """Both packages raise the same class (by name and bases) with the
    same message."""
    with pytest.raises(Exception) as want:
        ref_call()
    with pytest.raises(Exception) as got:
        port_call()
    mro = [[c.__name__ for c in type(e.value).__mro__] for e in (got, want)]
    assert mro[0] == mro[1]
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------- #
# engine contracts
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("method", METHODS)
def test_workers1_bit_identical_to_fast(graph, method):
    want = T.vertex_cut(graph, 64, method=method, seed=3, backend="fast")
    for merge_period in (1 << 16, 997):    # chunking must not matter
        got = dist_vertex_cut(graph, 64, method=method, seed=3,
                              workers=1, merge_period=merge_period)
        assert_same_cut(got, want)


@pytest.mark.parametrize("pool", ("serial", "thread", "process"))
@pytest.mark.parametrize("workers", (2, 4, 7))
def test_multi_worker_equals_reference(ref, graph, ref_graph, workers, pool):
    want = ref.dist.dist_vertex_cut(ref_graph, 32, seed=5, workers=workers,
                                    merge_period=1000, pool="serial")
    got = dist_vertex_cut(graph, 32, seed=5, workers=workers,
                          merge_period=1000, pool=pool)
    assert_same_cut(got, want)


@pytest.mark.parametrize("method", METHODS)
def test_methods_equal_reference(ref, graph, ref_graph, method):
    kw = dict(method=method, seed=2, workers=3, merge_period=700, lam=1.1)
    assert_same_cut(dist_vertex_cut(graph, 16, **kw),
                    ref.dist.dist_vertex_cut(ref_graph, 16, **kw))


@pytest.mark.parametrize("divergence", (0.0, 0.05, 1.0))
def test_adaptive_merges_equal_reference(ref, graph, ref_graph, divergence):
    tl, tl_ref = {}, {}
    kw = dict(workers=4, merge_period=500, divergence=divergence)
    got = dist_vertex_cut(graph, 16, timeline=tl, **kw)
    want = ref.dist.dist_vertex_cut(ref_graph, 16, timeline=tl_ref, **kw)
    assert_same_cut(got, want)
    for key in ("mode", "workers", "merge_period", "divergence",
                "full_merges", "round_merges"):
        assert tl[key] == tl_ref[key], key
    assert [r["full_merge"] for r in tl["rounds"]] == \
        [r["full_merge"] for r in tl_ref["rounds"]]


def test_multi_worker_valid_cut(graph):
    p = 16
    r = dist_vertex_cut(graph, p, workers=4, merge_period=500)
    assert len(r.assignment) == graph.num_edges
    assert (r.assignment >= 0).all() and (r.assignment < p).all()
    assert np.isclose(r.loads.sum(), graph.total_weight)
    replicas = r.replicas
    for e in range(0, graph.num_edges, 97):
        c = int(r.assignment[e])
        assert c in replicas[graph.src[e]]
        assert c in replicas[graph.dst[e]]


def test_run_pipeline_dist_matches_fast(graph):
    """backend="dist", workers=1 reproduces backend="fast" bit for bit
    through partition -> map -> simulate; `device` is ignored (the dist
    backend runs on the host), so asking for the card needs none."""
    pf, mf, rf = T.run_pipeline(graph, 16, "wb_libra", backend="fast")
    pd, md, rd = T.run_pipeline(graph, 16, "wb_libra", backend="dist",
                                workers=1, device="cuda")
    assert_same_cut(pd, pf)
    np.testing.assert_array_equal(md.core_of, mf.core_of)
    np.testing.assert_array_equal(rd.core_times, rf.core_times)
    assert rd.exec_time == rf.exec_time
    assert rd.data_comm_bytes == rf.data_comm_bytes
    assert T.resolve_mapping_backend("dist") == "fast"


def test_run_pipeline_dist_multiworker_equals_reference(ref, graph,
                                                        ref_graph):
    kw = dict(backend="dist", workers=3, merge_period=2000)
    part, mapping, rep = T.run_pipeline(graph, 16, "wb_libra", **kw)
    want = ref.core.run_pipeline(ref_graph, 16, "wb_libra", **kw)
    assert_same_cut(part, want[0])
    np.testing.assert_array_equal(mapping.core_of, want[1].core_of)
    np.testing.assert_array_equal(rep.core_times, want[2].core_times)
    assert rep.summary() == want[2].summary()


def test_trace_paths_through_the_entry_points(ref, trace_path, tmp_path):
    """A trace path under backend="dist" is ingested by the sharded
    parser first, as in the reference (`run_pipeline`, `plan_graph`)."""
    from repro.core.planner import plan_graph as ref_plan_graph
    npz = str(tmp_path / "g.npz")
    ingest_trace_with_stats(trace_path)[0].save_npz(npz)
    for source in (trace_path, npz):
        part, mapping, rep = T.run_pipeline(source, 8, "wb_libra",
                                            backend="dist", workers=2)
        want = ref.core.run_pipeline(source, 8, "wb_libra", backend="dist",
                                     workers=2)
        assert_same_cut(part, want[0])
        np.testing.assert_array_equal(mapping.core_of, want[1].core_of)
        assert rep.summary() == want[2].summary()
        plan = T.plan_graph(source, 8, backend="dist", workers=2,
                            merge_period=3000, divergence=0.05)
        assert plan.summary() == ref_plan_graph(
            source, 8, backend="dist", workers=2, merge_period=3000,
            divergence=0.05).summary()


def test_random_method_delegates(graph):
    a = dist_vertex_cut(graph, 8, method="random", seed=2, workers=4)
    b = T.vertex_cut(graph, 8, method="random", seed=2, backend="fast")
    assert_same_cut(a, b)


@pytest.mark.parametrize("kw", [
    dict(method="nope"), dict(p=0), dict(lam=0.5), dict(merge_period=0),
    dict(backend="reference"), dict(workers=2, divergence=-0.1),
    dict(workers=2, pipeline="sometimes"), dict(workers=2, pool="threads"),
])
def test_dist_rejects_bad_args_like_reference(ref, graph, ref_graph, kw):
    kw = dict(kw)
    p = kw.pop("p", 8)
    assert_same_raise(lambda: dist_vertex_cut(graph, p, **kw),
                      lambda: ref.dist.dist_vertex_cut(ref_graph, p, **kw))


def test_dist_rejects_the_cuda_backend(graph):
    """The greedy stream is sequential on the host: "cuda" is refused,
    as the reference refuses "pallas"."""
    with pytest.raises(ValueError, match="fast engines only"):
        dist_vertex_cut(graph, 8, backend="cuda")


def test_pipeline_forced_ineligible_raises_like_reference(ref, graph,
                                                          ref_graph,
                                                          trace_path):
    for port_g, ref_g, kw in (
            (graph, ref_graph, dict(workers=2)),
            (trace_path, trace_path, dict(workers=1)),
            (trace_path, trace_path, dict(workers=2, method="pg"))):
        assert_same_raise(
            lambda: dist_vertex_cut(port_g, 8, pipeline=True, **kw),
            lambda: ref.dist.dist_vertex_cut(ref_g, 8, pipeline=True, **kw))


# ---------------------------------------------------------------------- #
# shard state + merge hooks
# ---------------------------------------------------------------------- #
def test_shard_state_chunked_equals_one_shot(graph):
    p = 24
    want = T.vertex_cut(graph, p, method="wb_libra", backend="fast")
    deg = graph.degrees()
    swap = deg[graph.src] > deg[graph.dst]
    su = np.ascontiguousarray(np.where(swap, graph.dst, graph.src), np.int32)
    sv = np.ascontiguousarray(np.where(swap, graph.src, graph.dst), np.int32)
    w = np.ascontiguousarray(graph.w, np.float64)
    st = T.ShardCutState.create(graph.n, p, deg,
                                graph.total_weight / p, True)
    out = np.empty(graph.num_edges, np.int32)
    for a in range(0, graph.num_edges, 1234):
        b = min(a + 1234, graph.num_edges)
        st.stream_chunk(su[a:b], sv[a:b], w[a:b], out[a:b])
    np.testing.assert_array_equal(out, want.assignment)
    np.testing.assert_array_equal(st.loads, want.loads)


def test_shard_state_rejects_non_fast_backends():
    for backend in ("cuda", "reference"):
        with pytest.raises(ValueError, match="fast engines only"):
            T.ShardCutState.create(10, 4, np.zeros(10, np.int64), np.inf,
                                   True, backend=backend)


def test_shard_state_grow_and_adopt_loads():
    st = T.ShardCutState.create(4, 128, np.zeros(4, np.int64), np.inf,
                                True, "python")
    st.masks[: 4 * st.limbs] = 7
    st.rem[:] = 5
    st.grow(9)
    assert len(st.rem) == 9 and len(st.masks) == 9 * st.limbs
    assert (st.masks[: 4 * st.limbs] == 7).all()
    assert (st.masks[4 * st.limbs:] == 0).all()
    assert (st.rem[:4] == 5).all() and (st.rem[4:] == 0).all()
    st.grow(3)
    assert len(st.rem) == 9
    st2 = T.ShardCutState.create(3, 8, np.zeros(3, np.int64), np.inf,
                                 True, "python")
    assert st2.fresh
    st2.adopt_loads(np.arange(8, dtype=np.float64))
    assert not st2.fresh and st2.loads[7] == 7.0
    st2.rem[:] = 9
    st2.adopt(np.zeros(8), None, np.zeros(3 * st2.limbs, np.uint64))
    assert (st2.rem == 9).all()


def test_merge_helpers_equal_reference(ref):
    rng = np.random.default_rng(0)
    masks = [rng.integers(0, 2**63, 40, dtype=np.uint64) for _ in range(3)]
    keep = [m.copy() for m in masks]
    got = merge_limb_masks(masks)
    np.testing.assert_array_equal(got, ref.arrayops.merge_limb_masks(masks))
    np.testing.assert_array_equal(got, masks[0] | masks[1] | masks[2])
    for m, k in zip(masks, keep):
        np.testing.assert_array_equal(m, k)         # inputs untouched
    np.testing.assert_array_equal(merge_limb_masks(masks[:1]), masks[0])
    assert_same_raise(lambda: merge_limb_masks([]),
                      lambda: ref.arrayops.merge_limb_masks([]))
    for dtype in (np.float64, np.int64):
        snap = rng.integers(0, 50, 9).astype(dtype)
        locs = [snap + rng.integers(-3, 9, 9).astype(dtype)
                for _ in range(4)]
        got = merge_deltas(snap, locs)
        want = ref.arrayops.merge_deltas(snap, locs)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_shard_bounds_equal_reference(ref):
    for m in (0, 1, 2, 7, 10, 1000, 12345):
        for w in (1, 2, 3, 8, 16):
            assert shard_bounds(m, w) == ref.dist.shard_bounds(m, w)
    assert shard_bounds(2, 8) == [0, 1, 2]


def test_masks_to_replica_csr_matches_sort_based(graph):
    from concurrent.futures import ThreadPoolExecutor
    for p in (3, 64, 130):
        cut = T.vertex_cut(graph, p, method="wb_libra", backend="fast")
        limbs = (p + 63) // 64
        masks = np.zeros(graph.n * limbs, dtype=np.uint64)
        for arrs in (graph.src, graph.dst):
            idx = arrs.astype(np.int64) * limbs + cut.assignment // 64
            np.bitwise_or.at(masks, idx, np.uint64(1) << (
                cut.assignment % 64).astype(np.uint64))
        want = replica_csr(graph.n, p, graph.src, graph.dst, cut.assignment)
        got = masks_to_replica_csr(masks, graph.n, limbs, p)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        with ThreadPoolExecutor(max_workers=4) as ex:
            sharded = masks_to_replica_csr(masks, graph.n, limbs, p,
                                           executor=ex, shards=7)
        np.testing.assert_array_equal(sharded[0], want[0])
        np.testing.assert_array_equal(sharded[1], want[1])


def test_empty_graph_dist():
    g = T.IRGraph(n=3, src=np.zeros(0, np.int32), dst=np.zeros(0, np.int32),
                  w=np.zeros(0), name="empty")
    r = dist_vertex_cut(g, 4, workers=2)
    assert len(r.assignment) == 0 and r.replication_factor == 0.0


# ---------------------------------------------------------------------- #
# sharded parallel parse
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("pool", ("serial", "process"))
@pytest.mark.parametrize("workers", (1, 2, 5))
def test_sharded_parse_equals_reference(ref, trace_path, workers, pool):
    g0, s0 = ingest_trace_with_stats(trace_path)
    g, s = dist_ingest_with_stats(trace_path, workers=workers, pool=pool)
    g_ref, s_ref = ref.dist.dist_ingest_with_stats(trace_path,
                                                   workers=workers,
                                                   pool="serial")
    assert_same_graph(g, g0)
    assert_same_graph(g, g_ref)
    assert g.name == g_ref.name
    assert stats_no_peak(s) == stats_no_peak(s0)
    assert s.summary() == s_ref.summary()


def test_sharded_parse_compressed(ref, trace_path, tmp_path):
    g0, _ = ingest_trace_with_stats(trace_path)
    gz = tmp_path / "t.ndjson.gz"
    with open(trace_path) as f, gzip.open(gz, "wt", encoding="utf-8") as z:
        z.write(f.read())
    sources = [str(gz)]
    try:
        import zstandard
    except ImportError:
        zstandard = None
    if zstandard is not None:
        zst = tmp_path / "t.ndjson.zst"
        with open(trace_path, "rb") as f:
            zst.write_bytes(zstandard.ZstdCompressor().compress(f.read()))
        sources.append(str(zst))
    for source in sources:
        g, s = dist_ingest_with_stats(source, workers=3, pool="serial")
        g_ref, s_ref = ref.dist.dist_ingest_with_stats(source, workers=3,
                                                       pool="serial")
        assert_same_graph(g, g0)
        assert_same_graph(g, g_ref)
        assert s.summary() == s_ref.summary()


def test_sharded_parse_binary_trace(ref, tmp_path):
    """A `.rtb` source loads the conversion-time graph for any worker
    count, so `backend="dist"`, workers=1 is bit-identical to "fast"."""
    path = str(tmp_path / "t.ndjson")
    synthesize_trace(path, 700, seed=6)
    rtb = str(tmp_path / "t.rtb")
    g0, st0 = ingest_trace_with_stats(path)
    write_trace_bin(rtb, g0, st0)
    for workers in (1, 3):
        gd, sd = dist_ingest_with_stats(rtb, workers=workers)
        assert sd.engine == "binary"
        assert_same_graph(gd, g0)
        assert_same_graph(gd, ref.dist.dist_ingest(rtb, workers=workers))
    part_f, _, rep_f = T.run_pipeline(rtb, 8, "wb_libra", backend="fast")
    part_d, _, rep_d = T.run_pipeline(rtb, 8, "wb_libra", backend="dist",
                                      workers=1)
    assert_same_cut(part_d, part_f)
    assert rep_f.exec_time == rep_d.exec_time
    cfg = ['{"kind":"block","fn":"f","bb":"b0","succs":[]}']
    assert_same_raise(
        lambda: dist_ingest_with_stats(rtb, workers=2, cfg=cfg),
        lambda: ref.dist.dist_ingest_with_stats(rtb, workers=2, cfg=cfg))


def test_cross_shard_def_resolution(ref, tmp_path):
    """Defs in early shards bind later shards' uses, with the
    producer-bytes weight recompute, as the rolling tables do."""
    lines = [json.dumps({"fn": "f", "bb": "b0", "op": "load",
                         "def": f"v{i}", "def_ty": "i32", "uses": []})
             for i in range(40)]
    lines += [json.dumps({"fn": "f", "bb": "b1", "op": "add",
                          "def": f"x{i}", "def_ty": "<4 x float>",
                          "uses": [f"v{i % 40}",
                                   f"x{i - 1}" if i else "v0"]})
              for i in range(400)]
    path = tmp_path / "defs.ndjson"
    path.write_text("\n".join(lines) + "\n")
    g0, s0 = ingest_trace_with_stats(str(path))
    assert set(g0.w.tolist()) == {4.0, 16.0}    # recompute has teeth
    for workers in (2, 3, 9):
        g, s = dist_ingest_with_stats(str(path), workers=workers)
        assert_same_graph(g, g0)
        assert stats_no_peak(s) == stats_no_peak(s0)
        assert s.summary() == ref.dist.dist_ingest_with_stats(
            str(path), workers=workers)[1].summary()


def test_sharded_parse_keep_labels(ref, tmp_path):
    lines = [json.dumps({"fn": "f", "bb": "b", "op": f"op{i}",
                         "def": f"v{i}", "uses": [f"v{i-1}"] if i else []})
             for i in range(200)]
    path = tmp_path / "lab.ndjson"
    path.write_text("\n".join(lines) + "\n")
    g0, _ = ingest_trace_with_stats(str(path), keep_labels=True)
    g, _ = dist_ingest_with_stats(str(path), workers=3, keep_labels=True)
    g_ref, _ = ref.dist.dist_ingest_with_stats(str(path), workers=3,
                                               keep_labels=True)
    assert list(g.node_labels) == list(g0.node_labels)
    assert list(g.node_labels) == list(g_ref.node_labels)


def test_sharded_parse_on_error_skip(ref, tmp_path):
    lines = [json.dumps({"fn": "f", "bb": "b", "op": "add",
                         "def": f"v{i}", "uses": []}) for i in range(60)]
    lines[10] = "not json"
    lines[40] = json.dumps({"op": 3})            # non-string op
    path = tmp_path / "bad.ndjson"
    path.write_text("\n".join(lines) + "\n")
    g, s = dist_ingest_with_stats(str(path), workers=3, on_error="skip")
    assert s.skipped == 2 and g.n == 58
    g_ref, s_ref = ref.dist.dist_ingest_with_stats(str(path), workers=3,
                                                   on_error="skip")
    assert_same_graph(g, g_ref)
    assert s.summary() == s_ref.summary()
    assert_same_raise(
        lambda: dist_ingest_with_stats(str(path), workers=3, pool="serial"),
        lambda: ref.dist.dist_ingest_with_stats(str(path), workers=3,
                                                pool="serial"))


def test_shard_byte_ranges_equal_reference(ref, trace_path):
    size = os.path.getsize(trace_path)
    with open(trace_path, "rb") as f:
        data = f.read()
    for workers in (1, 2, 3, 8, 13):
        ranges = shard_byte_ranges(trace_path, workers)
        assert ranges == ref.dist.shard_byte_ranges(trace_path, workers)
        assert ranges[0][0] == 0 and ranges[-1][1] == size
        for (_a0, b0), (a1, _b1) in zip(ranges, ranges[1:]):
            assert b0 == a1
        for _a, b in ranges[:-1]:
            assert data[b - 1:b] == b"\n"


def test_unicode_line_separators_inside_strings(tmp_path):
    """U+2028/NEL/form-feed are legal raw inside JSON strings: only \\n
    breaks a line, on the byte-range and the in-memory block paths."""
    lines = [json.dumps({"fn": "f", "bb": "b", "op": f"op {i}\x85x\x0c",
                         "def": f"v{i}", "uses": [f"v{i-1}"] if i else []},
                        ensure_ascii=False)
             for i in range(30)]
    path = tmp_path / "u.ndjson"
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    g0, s0 = ingest_trace_with_stats(str(path))
    assert s0.records == 30
    gz = tmp_path / "u.ndjson.gz"
    with open(path, "rb") as f, gzip.open(gz, "wb") as z:
        z.write(f.read())
    for source, workers in ((path, 1), (path, 3), (gz, 3)):
        g, s = dist_ingest_with_stats(str(source), workers=workers)
        assert s.records == 30 and s.skipped == 0
        assert_same_graph(g, g0)


def test_more_workers_than_lines(tmp_path):
    path = tmp_path / "tiny.ndjson"
    path.write_text(json.dumps({"fn": "f", "bb": "b", "op": "add",
                                "def": "v0", "uses": []}) + "\n")
    g, s = dist_ingest_with_stats(str(path), workers=16)
    assert g.n == 1 and s.records == 1


def test_dist_ingest_rejects_like_reference(ref):
    assert_same_raise(lambda: dist_ingest_with_stats(["{}"], workers=2),
                      lambda: ref.dist.dist_ingest_with_stats(["{}"],
                                                              workers=2))
    assert_same_raise(
        lambda: dist_ingest_with_stats("x.ndjson", pool="threads"),
        lambda: ref.dist.dist_ingest_with_stats("x.ndjson", pool="threads"))


# ---------------------------------------------------------------------- #
# path inputs and the pipelined dataflow
# ---------------------------------------------------------------------- #
def test_dist_cut_from_trace_path_two_phase(trace_path):
    g = dist_ingest(trace_path, workers=2)
    a = dist_vertex_cut(trace_path, 16, workers=2, merge_period=4000,
                        pipeline=False)
    b = dist_vertex_cut(g, 16, workers=2, merge_period=4000)
    assert_same_cut(a, b)


def test_dist_cut_from_npz_path(tmp_path, graph):
    npz = tmp_path / "g.npz"
    graph.save_npz(str(npz))
    assert_same_cut(dist_vertex_cut(str(npz), 8, workers=1),
                    T.vertex_cut(graph, 8, backend="fast"))


@pytest.mark.parametrize("pool", ("serial", "thread", "process"))
def test_pipelined_equals_reference(ref, trace_path, pool):
    tl = {}
    got = dist_vertex_cut(trace_path, 16, workers=3, merge_period=700,
                          pool=pool, timeline=tl)
    want = ref.dist.dist_vertex_cut(trace_path, 16, workers=3,
                                    merge_period=700, pool="serial")
    assert_same_cut(got, want)
    assert tl["mode"] == "pipelined" and tl["pool"] == pool
    g = ingest_trace_with_stats(trace_path)[0]
    indptr, flat = replica_csr(g.n, 16, g.src, g.dst, got.assignment)
    np.testing.assert_array_equal(got.replica_indptr, indptr)
    np.testing.assert_array_equal(got.replica_flat, flat)


@pytest.mark.parametrize("merge_period", (97, 1500))
def test_pipelined_independent_of_parse_workers(ref, trace_path,
                                                merge_period):
    """Round boundaries are global edge offsets: the parse-shard count
    never changes the cut, and repeated runs are bit-identical."""
    want = ref.dist.dist_vertex_cut(trace_path, 8, workers=2,
                                    merge_period=merge_period)
    for pw in (None, 1, 3, 7):
        got = dist_vertex_cut(trace_path, 8, workers=2,
                              merge_period=merge_period, parse_workers=pw)
        assert_same_cut(got, want)


def test_pipelined_adaptive_merges_equal_reference(ref, trace_path):
    tl, tl_ref = {}, {}
    kw = dict(workers=3, merge_period=500, divergence=1.0)
    got = dist_vertex_cut(trace_path, 16, timeline=tl, **kw)
    want = ref.dist.dist_vertex_cut(trace_path, 16, timeline=tl_ref, **kw)
    assert_same_cut(got, want)
    assert (tl["full_merges"], tl["round_merges"]) == \
        (tl_ref["full_merges"], tl_ref["round_merges"])
    assert tl["full_merges"] < tl["round_merges"]
    assert [r["edges"] for r in tl["rounds"]] == \
        [r["edges"] for r in tl_ref["rounds"]]


def test_auto_pool_matches_engine(trace_path):
    tl = {}
    dist_vertex_cut(trace_path, 8, workers=2, merge_period=4000,
                    timeline=tl)
    if native_available():
        assert tl["engine"] == "native" and tl["pool"] == "thread"
    else:
        assert tl["engine"] == "python" and tl["pool"] == "process"


def _warnings_of(call, needle):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = call()
    return out, [w for w in rec if needle in str(w.message)]


def test_gil_warning_like_reference(ref, graph, ref_graph):
    """Same class and text as the reference's, pointing at the caller."""
    kw = dict(workers=2, backend="python", pool="thread", merge_period=4000)
    got, mine = _warnings_of(lambda: dist_vertex_cut(graph, 8, **kw), "GIL")
    _, theirs = _warnings_of(
        lambda: ref.dist.dist_vertex_cut(ref_graph, 8, **kw), "GIL")
    assert len(mine) == len(theirs) == 1
    assert mine[0].category is theirs[0].category is RuntimeWarning
    assert str(mine[0].message) == str(theirs[0].message)
    assert mine[0].filename == __file__
    assert_same_cut(got, dist_vertex_cut(graph, 8, workers=2,
                                         backend="python", pool="serial",
                                         merge_period=4000))


def test_process_fallback_warning_like_reference(ref, monkeypatch, graph,
                                                 ref_graph, trace_path):
    from repro_torch.dist import engine

    class Boom:
        def __init__(self, *a, **kw):
            raise ImportError("no pipes here")

    monkeypatch.setattr(engine, "_ProcessPool", Boom)
    monkeypatch.setattr(ref.dist.engine, "_ProcessPool", Boom)
    needle = "falling back to serial"
    kw = dict(workers=2, pool="process", merge_period=4000)
    for port_g, ref_g in ((graph, ref_graph), (trace_path, trace_path)):
        got, mine = _warnings_of(lambda: dist_vertex_cut(port_g, 8, **kw),
                                 needle)
        want, theirs = _warnings_of(
            lambda: ref.dist.dist_vertex_cut(ref_g, 8, **kw), needle)
        assert len(mine) == len(theirs) == 1
        assert mine[0].category is theirs[0].category is RuntimeWarning
        assert str(mine[0].message) == str(theirs[0].message)
        assert mine[0].filename == __file__     # the caller's line
        assert_same_cut(got, want)


def test_cli_partition_and_inspect_workers(ref, trace_path, capsys):
    """`--workers W` > 1 parses on the sharded parser and cuts with the
    dist backend, printing the reference CLI's plan; `--device` is
    ignored there, as the dist backend runs on the host."""
    from repro.trace.__main__ import main as ref_cli
    from repro_torch.trace.__main__ import main as port_cli
    for args in (["partition", trace_path, "-p", "4", "--workers", "2"],
                 ["partition", trace_path, "-p", "8", "--workers", "3",
                  "--divergence", "0.05"],
                 ["inspect", trace_path, "--workers", "3"]):
        assert port_cli(args + ["--device", "cuda"]
                        if args[0] == "partition" else args) == 0
        got = json.loads(capsys.readouterr().out)
        assert ref_cli(args) == 0
        assert got == json.loads(capsys.readouterr().out)


# ---------------------------------------------------------------------- #
# the property suite (tests/test_dist_property.py), against the reference
# ---------------------------------------------------------------------- #
def _hypothesis():
    pytest.importorskip("hypothesis",
                        reason="property tests need the hypothesis package")
    from hypothesis import given, settings, strategies as st
    return given, settings, st


def _small_graphs(st):
    @st.composite
    def small_graphs(draw):
        n = draw(st.integers(min_value=2, max_value=60))
        m = draw(st.integers(min_value=1, max_value=200))
        src = draw(st.lists(st.integers(0, n - 1), min_size=m, max_size=m))
        dst = draw(st.lists(st.integers(0, n - 1), min_size=m, max_size=m))
        w = draw(st.lists(st.floats(0.1, 100.0), min_size=m, max_size=m))
        return n, np.array(src), np.array(dst), np.array(w)
    return small_graphs()


def _small_traces(st):
    @st.composite
    def small_traces(draw):
        n_fns = draw(st.integers(1, 3))
        n_lines = draw(st.integers(1, 120))
        lines = []
        for _ in range(n_lines):
            fn = f"fn{draw(st.integers(0, n_fns - 1))}"
            uses = draw(st.lists(
                st.one_of(st.sampled_from([f"v{k}" for k in range(12)]),
                          st.sampled_from(["const:i32:1", "const:i32:7"])),
                min_size=0, max_size=3))
            rec = {"fn": fn, "bb": f"bb{draw(st.integers(0, 2))}",
                   "op": draw(st.sampled_from(["add", "load", "store",
                                               "mul"])),
                   "uses": uses,
                   "def": (f"v{draw(st.integers(0, 11))}"
                           if draw(st.booleans()) else None)}
            if draw(st.booleans()):
                rec["def_ty"] = draw(st.sampled_from(
                    ["i32", "i64", "double", "<4 x float>"]))
            lines.append(json.dumps(rec))
        return "\n".join(lines) + "\n"
    return small_traces()


def test_property_workers1_bit_identity():
    given, settings, st = _hypothesis()

    @given(g=_small_graphs(st), p=st.integers(2, 16),
           method=st.sampled_from(["pg", "libra", "w_pg", "wb_pg",
                                   "w_libra", "wb_libra"]),
           seed=st.integers(0, 5),
           merge_period=st.sampled_from([7, 64, 1 << 16]))
    @settings(max_examples=30, deadline=None)
    def check(g, p, method, seed, merge_period):
        gt = T.IRGraph(*g, name="hyp")
        want = T.vertex_cut(gt, p, method=method, seed=seed, backend="fast")
        got = dist_vertex_cut(gt, p, method=method, seed=seed, workers=1,
                              merge_period=merge_period)
        assert_same_cut(got, want)
    check()


def test_property_multi_worker_equals_reference(ref):
    given, settings, st = _hypothesis()

    @given(g=_small_graphs(st), p=st.integers(2, 12),
           workers=st.integers(2, 5), seed=st.integers(0, 5),
           merge_period=st.sampled_from([5, 33, 1024]),
           divergence=st.sampled_from([None, 0.0, 0.05, 0.5, 2.0]))
    @settings(max_examples=30, deadline=None)
    def check(g, p, workers, seed, merge_period, divergence):
        kw = dict(seed=seed, workers=workers, merge_period=merge_period,
                  divergence=divergence)
        got = dist_vertex_cut(T.IRGraph(*g, name="hyp"), p, **kw)
        want = ref.dist.dist_vertex_cut(ref.core.IRGraph(*g, name="hyp"),
                                        p, **kw)
        assert_same_cut(got, want)
        assert (got.assignment >= 0).all() and (got.assignment < p).all()
    check()


def test_property_sharded_parse_equals_reference(ref, tmp_path_factory):
    given, settings, st = _hypothesis()

    @given(text=_small_traces(st), workers=st.integers(1, 6),
           gz=st.booleans())
    @settings(max_examples=30, deadline=None)
    def check(text, workers, gz):
        d = tmp_path_factory.mktemp("hyp")
        path = d / ("t.ndjson.gz" if gz else "t.ndjson")
        if gz:
            with gzip.open(path, "wt", encoding="utf-8") as f:
                f.write(text)
        else:
            path.write_text(text)
        g0, s0 = ingest_trace_with_stats(str(path))
        g, s = dist_ingest_with_stats(str(path), workers=workers,
                                      pool="serial")
        g_ref, s_ref = ref.dist.dist_ingest_with_stats(
            str(path), workers=workers, pool="serial")
        assert_same_graph(g, g0)
        assert_same_graph(g, g_ref)
        d0, d1 = s0.summary(), s.summary()
        d0.pop("peak_chunk_edges")
        d1.pop("peak_chunk_edges")
        assert d0 == d1 and s.summary() == s_ref.summary()
    check()


def test_property_pipelined_trace_path_equals_reference(ref,
                                                        tmp_path_factory):
    given, settings, st = _hypothesis()

    @given(text=_small_traces(st), workers=st.integers(2, 4),
           p=st.integers(2, 8), merge_period=st.sampled_from([3, 17, 256]))
    @settings(max_examples=20, deadline=None)
    def check(text, workers, p, merge_period):
        path = tmp_path_factory.mktemp("hyp-pipe") / "t.ndjson"
        path.write_text(text)
        got = dist_vertex_cut(str(path), p, workers=workers,
                              merge_period=merge_period, pool="serial")
        want = ref.dist.dist_vertex_cut(str(path), p, workers=workers,
                                        merge_period=merge_period,
                                        pool="serial")
        assert_same_cut(got, want)
    check()


# ---------------------------------------------------------------------- #
# telemetry of the dist engine
# ---------------------------------------------------------------------- #
def _dist_histograms(trace_path, pool):
    with obs.scoped(merge=False) as col:
        dist_vertex_cut(trace_path, 8, workers=4, merge_period=2000,
                        pool=pool)
    return col.metrics.snapshot()["histograms"]


def test_dist_histograms_equal_across_pools_and_reference(ref, trace_path):
    """Worker durations ship home over the result channels: the merged
    histograms exist without shared memory, the deterministic one (round
    edge counts) is equal on every pool and to the reference's, and the
    duration sample counts are too."""
    snaps = {pool: _dist_histograms(trace_path, pool)
             for pool in ("serial", "thread", "process")}
    from repro import obs as robs
    with robs.scoped(merge=False) as col:
        ref.dist.dist_vertex_cut(trace_path, 8, workers=4,
                                 merge_period=2000, pool="serial")
    want = col.metrics.snapshot()["histograms"]
    for pool, snap in snaps.items():
        assert set(snap) == set(want), pool
        assert snap["dist.round_edges"] == want["dist.round_edges"], pool
        for name in want:
            assert snap[name]["count"] == want[name]["count"], (pool, name)
    assert snaps["serial"]["dist.cut_us"]["count"] > 0


def test_disabled_records_nothing(trace_path):
    cut = dist_vertex_cut(trace_path, 8, workers=2, merge_period=4000)
    assert cut.assignment is not None
    assert obs.current() is None


def test_process_pool_event_merge_deterministic(trace_path):
    """A W=4 pipelined run over process pools: the event structure
    (names, lanes, counts) is a pure function of the input."""
    shapes = []
    for _ in range(2):
        with obs.scoped(merge=False) as col:
            dist_vertex_cut(trace_path, 8, workers=4, merge_period=3000,
                            pool="process")
        shapes.append(sorted((e["name"], e["lane"]) for e in col.events))
    assert shapes[0] == shapes[1]
    lanes = {lane for _, lane in shapes[0]}
    names = {name for name, _ in shapes[0]}
    assert "coord" in lanes
    assert any(ln.startswith("cut/w") for ln in lanes)
    assert any(ln.startswith("parse/p") for ln in lanes)
    assert {"dist.cut", "parse.shard", "dist.parse_wait",
            "dist.finalize", "parse.merge"} <= names


def test_repro_profile_under_a_process_pool(tmp_path, trace_path):
    """REPRO_PROFILE with a process-pool run, in a process that imports
    only the port: the workers do not clobber the coordinator's profile,
    which carries the merged worker histograms."""
    out = tmp_path / "prof.json"
    code = ("import sys; from repro_torch.dist import dist_vertex_cut; "
            f"dist_vertex_cut({trace_path!r}, 8, workers=4, "
            "merge_period=2000, pool='process'); "
            "assert not any(m == 'repro' or m.startswith(('repro.', 'jax'))"
            " for m in sys.modules)")
    env = dict(os.environ, REPRO_PROFILE=str(out),
               PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    doc = json.loads(out.read_text())
    assert "dist.finalize" in {e.get("name") for e in doc["traceEvents"]}
    hists = doc["repro"]["metrics"]["histograms"]
    assert hists["dist.cut_us"]["count"] > 0
    assert hists["dist.round_edges"]["count"] > 0


def test_timeline_cli_from_a_real_engine_timeline(tmp_path, trace_path,
                                                   capsys):
    """A real engine timeline, in a bench-style JSON's meta, exports
    through `python -m repro_torch.obs timeline` to the reference CLI's
    Perfetto trace of the same file."""
    from repro.obs.__main__ import main as ref_main
    from repro_torch.obs.__main__ import main
    tl: dict = {}
    dist_vertex_cut(trace_path, 8, workers=2, merge_period=4000,
                    pool="serial", timeline=tl)
    assert tl["rounds"] and tl["mode"] == "pipelined"
    bench = tmp_path / "BENCH_fake.json"
    bench.write_text(json.dumps({"suite": "dist_scaling", "rows": [],
                                 "meta": {"timeline_w4": tl}}))
    ours, theirs = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    assert main(["timeline", str(bench), "-o", ours]) == 0
    assert ref_main(["timeline", str(bench), "-o", theirs]) == 0
    assert "perfetto" in capsys.readouterr().out
    with open(ours) as a, open(theirs) as b:
        doc = json.load(a)
        assert doc == json.load(b)
    lanes = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M"}
    assert "coord" in lanes and any(ln.startswith("cut/w") for ln in lanes)


# ---------------------------------------------------------------------- #
# on the card
# ---------------------------------------------------------------------- #
@pytest.mark.cuda
def test_dist_pipeline_forks_after_cuda_and_gives_the_fast_plan(tmp_path):
    """With a CUDA context in the parent, the process pools still fork
    (their workers run numpy and the port's C stream only), and W=1
    under the dist backend gives the fast plan; W=2 equals a serial
    pool's plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    torch.zeros(1, device="cuda").sum().item()      # a live CUDA context
    path = str(tmp_path / "t.ndjson")
    synthesize_trace(path, 20_000, seed=0)
    fast = T.run_pipeline(path, 16, "wb_libra", backend="fast")
    one = T.run_pipeline(path, 16, "wb_libra", backend="dist", workers=1)
    assert_same_cut(one[0], fast[0])
    np.testing.assert_array_equal(one[1].core_of, fast[1].core_of)
    np.testing.assert_array_equal(one[2].core_times, fast[2].core_times)
    two = T.run_pipeline(path, 16, "wb_libra", backend="dist", workers=2)
    g = dist_ingest(path, workers=2, pool="process")
    for pool in ("process", "serial"):
        cut = dist_vertex_cut(g, 16, workers=2, pool=pool)
        assert_same_cut(cut, two[0])
    piped = dist_vertex_cut(path, 16, workers=2, pool="process")
    assert_same_cut(piped, dist_vertex_cut(path, 16, workers=2,
                                           pool="serial"))
