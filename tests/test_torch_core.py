"""The port's core modules against the JAX package's, on the same inputs.

Graphs come from seeded numpy (the backend-equivalence graphs, the
power-law generator, the paper's benchmark tracer) and go to both
packages unchanged.  The port's host engines must be bit-identical to the
reference's engines of the same name, and its `cuda` backend (on the
host, with the kernels' plain versions) to the reference's numpy
engines: assignment, loads, edge counts, replica CSR and `core_of`
exactly, SimReports within rtol 1e-12 of the reference oracle and
core_times exactly against `fast`.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from test_backend_equivalence import GRAPHS  # noqa: E402

CPU = "cpu"
CUT_FIELDS = ("assignment", "loads", "edge_counts", "replica_indptr",
              "replica_flat")
HOST_BACKENDS = ("reference", "fast", "native", "python", "cuda")


def port_graph(g):
    return T.from_reference_arrays(g.n, g.src, g.dst, g.w, g.name)


PORT_GRAPHS = [port_graph(g) for g in GRAPHS]


def assert_cut_equal(got, want, msg=""):
    for field in CUT_FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, f"{msg} {field} dtype"
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {field}")
    assert got.replication_factor == want.replication_factor
    assert got.n_vertices == want.n_vertices
    assert got.total_weight == want.total_weight


@pytest.mark.parametrize("backend", HOST_BACKENDS)
@pytest.mark.parametrize("p", (8, 64))
@pytest.mark.parametrize("method", R.ALGORITHMS)
def test_vertex_cut_bit_identical(method, p, backend):
    # the port's "cuda" takes the place of the reference's "pallas", whose
    # cut equals "fast" (asserted by the reference's own tests)
    ref_backend = "fast" if backend == "cuda" else backend
    for g, gt in zip(GRAPHS, PORT_GRAPHS):
        for lam in (1.0, 1.25):
            want = R.vertex_cut(g, p, method=method, lam=lam, seed=3,
                                backend=ref_backend)
            got = T.vertex_cut(gt, p, method=method, lam=lam, seed=3,
                               backend=backend, device=CPU)
            assert_cut_equal(got, want, f"{g.name} lam={lam}")


def test_backend_names():
    assert T.BACKENDS == ("fast", "native", "python", "cuda", "reference")
    assert T.resolve_backend("cuda") == "cuda"
    assert T.resolve_backend("fast") == R.resolve_backend("fast")
    assert T.MAPPING_BACKENDS == ("fast", "reference", "cuda")
    assert T.resolve_mapping_backend("cuda") == "cuda"
    assert T.resolve_mapping_backend("native") == "fast"
    with pytest.raises(ValueError):
        T.resolve_backend("pallas")
    with pytest.raises(ValueError):
        T.resolve_backend("torch")


def test_shard_cut_state_chunks_match_reference():
    g, gt = GRAPHS[0], PORT_GRAPHS[0]
    deg = g.degrees()
    outs = []
    for mod in (R, T):
        st = mod.ShardCutState.create(g.n, 8, deg, float("inf"),
                                      libra_rule=True, backend="python")
        out = np.empty(g.num_edges, dtype=np.int32)
        su = np.ascontiguousarray(g.src, dtype=np.int32)
        sv = np.ascontiguousarray(g.dst, dtype=np.int32)
        w = np.ascontiguousarray(g.w)
        for a in range(0, g.num_edges, 97):
            b = min(a + 97, g.num_edges)
            st.stream_chunk(su[a:b], sv[a:b], w[a:b], out[a:b])
        outs.append((out, st.loads.copy(), st.masks.copy()))
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x, y)
    assert gt.num_edges == g.num_edges


@pytest.mark.parametrize("method", R.EDGE_CUT_METHODS)
def test_edge_cut_bit_identical(method):
    for g, gt in zip(GRAPHS, PORT_GRAPHS):
        want = R.edge_cut(g, 8, method=method, seed=2)
        got = T.edge_cut(gt, 8, method=method, seed=2)
        np.testing.assert_array_equal(got.parts, want.parts)
        assert got.summary() == want.summary()


@pytest.mark.parametrize("p", (8, 64))
def test_interaction_graphs_and_mapping_bit_identical(p):
    for g, gt in zip(GRAPHS, PORT_GRAPHS):
        cut = R.vertex_cut(g, p, method="wb_libra")
        cut_t = T.vertex_cut(gt, p, method="wb_libra", device=CPU)
        vb = R.vertex_bytes_model(g)
        comm, shared = R.cluster_interaction_graphs(cut, p, vb)
        for backend in ("cuda", "fast", "reference"):
            c, s = T.cluster_interaction_graphs(cut_t, p, vb,
                                                backend=backend, device=CPU)
            np.testing.assert_array_equal(c, comm, err_msg=backend)
            np.testing.assert_array_equal(s, shared, err_msg=backend)
        for backend in ("fast", "reference"):
            want = R.memory_centric_mapping(comm, shared, backend=backend)
            got = T.memory_centric_mapping(comm, shared, backend=backend)
            np.testing.assert_array_equal(got.core_of, want.core_of)
            assert got.machine == T.Machine(**vars(want.machine))


@pytest.mark.parametrize("p", (8, 64))
def test_simulate_matches_reference(p):
    for g, gt in zip(GRAPHS, PORT_GRAPHS):
        cut = R.vertex_cut(g, p, method="wb_libra")
        cut_t = T.vertex_cut(gt, p, method="wb_libra", device=CPU)
        comm, shared = R.cluster_interaction_graphs(
            cut, p, R.vertex_bytes_model(g))
        mapping = R.memory_centric_mapping(comm, shared)
        mapping_t = T.memory_centric_mapping(comm, shared)
        ref = R.simulate(g, cut, mapping, backend="reference")
        fast = R.simulate(g, cut, mapping, backend="fast")
        for backend in ("cuda", "fast", "reference"):
            got = T.simulate(gt, cut_t, mapping_t, backend=backend,
                             device=CPU)
            for field in ("exec_time", "data_comm_bytes", "sync_time",
                          "sync_bytes"):
                np.testing.assert_allclose(getattr(got, field),
                                           getattr(ref, field), rtol=1e-12)
            np.testing.assert_allclose(got.core_times, ref.core_times,
                                       rtol=1e-12)
            if backend != "reference":
                np.testing.assert_array_equal(got.core_times,
                                              fast.core_times)


def test_simulate_edge_cut_matches_reference():
    g, gt = GRAPHS[0], PORT_GRAPHS[0]
    for method in R.EDGE_CUT_METHODS:
        want = R.run_pipeline(g, 8, method, backend="fast")
        got = T.run_pipeline(gt, 8, method, backend="cuda", device=CPU)
        np.testing.assert_array_equal(got[0].parts, want[0].parts)
        np.testing.assert_array_equal(got[1].core_of, want[1].core_of)
        np.testing.assert_array_equal(got[2].core_times, want[2].core_times)
        assert got[2].exec_time == want[2].exec_time


def test_plan_graph_matches_reference():
    from repro.core.planner import plan_graph as ref_plan
    g = R.synthesize_powerlaw_graph(n=2000, alpha=2.2, seed=4)
    a = ref_plan(g, 16, backend="fast")
    b = T.plan_graph(port_graph(g), 16, device=CPU)
    assert_cut_equal(b.cut, a.cut)
    assert b.exec_time == pytest.approx(a.exec_time, rel=1e-12)
    assert b.comm_bytes == pytest.approx(a.comm_bytes, rel=1e-12)
    assert b.summary() == a.summary()


@pytest.mark.parametrize("name", R.all_benchmark_names())
def test_benchmark_graphs_identical(name):
    a = R.build_graph(name, cache_dir=None)
    b = T.build_graph(name, cache_dir=None)
    assert (a.n, a.name) == (b.n, b.name)
    for field in ("src", "dst", "w"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_powerlaw_and_theory_identical():
    a = R.synthesize_powerlaw_graph(n=5000, alpha=2.1, seed=9)
    b = T.synthesize_powerlaw_graph(n=5000, alpha=2.1, seed=9)
    for field in ("src", "dst", "w"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert a.stats() == b.stats()
    for p in (8, 64, 1024):
        assert (T.expected_replication_random(5000, 2.1, p)
                == R.expected_replication_random(5000, 2.1, p))
        assert (T.expected_replication_random_empirical(a.degrees(), p)
                == R.expected_replication_random_empirical(a.degrees(), p))


def test_npz_snapshots_move_both_ways(tmp_path):
    g = R.synthesize_powerlaw_graph(n=1500, alpha=2.2, seed=3)
    ref_path = os.path.join(tmp_path, "ref.npz")
    g.save_npz(ref_path)
    gt = T.IRGraph.load_npz(ref_path)
    port_path = os.path.join(tmp_path, "port.npz")
    gt.save_npz(port_path)
    back = R.IRGraph.load_npz(port_path)
    for field in ("src", "dst", "w"):
        np.testing.assert_array_equal(getattr(gt, field), getattr(g, field))
        np.testing.assert_array_equal(getattr(back, field),
                                      getattr(g, field))
        assert getattr(back, field).dtype == getattr(g, field).dtype
    assert (gt.n, gt.name) == (g.n, g.name) == (back.n, back.name)
    # a snapshot path goes through the whole pipeline
    a = R.run_pipeline(ref_path, 8, "wb_libra", backend="fast")
    b = T.run_pipeline(ref_path, 8, "wb_libra", device=CPU)
    np.testing.assert_array_equal(a[1].core_of, b[1].core_of)
    np.testing.assert_array_equal(a[2].core_times, b[2].core_times)
