"""End-to-end: the port's `run_pipeline(..., backend="cuda")` on the host
against the JAX package's `pallas`, `fast` and `reference` pipelines.

With `device="cpu"` the port's device half runs on the kernels' plain
versions.  Its observable outputs must be those of the reference: the
cut (assignment, loads, edge counts, replica CSR) and `core_of` exactly,
`core_times` exactly against `fast`, and the SimReport within rtol 1e-12
of the `reference` oracle.  The inputs are the backend-equivalence sweep
graphs, the paper's 10 benchmark graphs (traced by each package's own
tracer) and one real NDJSON trace, ingested by the JAX package and handed
over as an `.npz` snapshot (the port's trace front end is not ported yet).
The reference's `pallas` runs in interpret mode, as its own tests run
it; its jit compiles cost seconds per shape, so it joins the comparison
on three cases (one graph at each p and the trace) and `fast` and
`reference` on all of them.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from test_backend_equivalence import GRAPHS  # noqa: E402
from test_torch_segsum import ref_pallas  # noqa: E402,F401

TRACES = os.path.join(os.path.dirname(__file__), "..", "examples", "traces")
SWEEP_GRAPHS = GRAPHS + [R.synthesize_powerlaw_graph(n=3000, alpha=2.2,
                                                     seed=1)]


def _port(g):
    return T.from_reference_arrays(g.n, g.src, g.dst, g.w, g.name)


def _assert_pipeline_equivalent(g, p, method="wb_libra", lam=1.0,
                                gt=None, pallas=False):
    ref = R.run_pipeline(g, p, method, lam=lam, backend="reference")
    fast = R.run_pipeline(g, p, method, lam=lam, backend="fast")
    others = [ref, fast]
    if pallas:
        others.append(R.run_pipeline(g, p, method, lam=lam,
                                     backend="pallas"))
    part, mapping, rep = T.run_pipeline(
        gt if gt is not None else _port(g), p, method, lam=lam,
        backend="cuda", device="cpu")
    for other in others:
        for field in ("assignment", "loads", "edge_counts",
                      "replica_indptr", "replica_flat"):
            a, b = getattr(part, field), getattr(other[0], field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        np.testing.assert_array_equal(mapping.core_of, other[1].core_of)
    for field in ("exec_time", "data_comm_bytes", "sync_time", "sync_bytes"):
        np.testing.assert_allclose(getattr(rep, field),
                                   getattr(ref[2], field), rtol=1e-12,
                                   err_msg=field)
    np.testing.assert_allclose(rep.core_times, ref[2].core_times, rtol=1e-12)
    for other in others[1:]:
        np.testing.assert_array_equal(rep.core_times, other[2].core_times)


@pytest.mark.parametrize("gi", range(len(SWEEP_GRAPHS)))
def test_sweep_graphs_equivalent_p8(gi):
    _assert_pipeline_equivalent(SWEEP_GRAPHS[gi], 8)


@pytest.mark.parametrize("gi", (2, len(SWEEP_GRAPHS) - 1))
def test_sweep_graphs_equivalent_p64(gi):
    # the hub-heavy graph stresses big replica sets, the power-law graph
    # the realistic degree tail
    _assert_pipeline_equivalent(SWEEP_GRAPHS[gi], 64)


@pytest.mark.parametrize("p,gi", [(8, len(SWEEP_GRAPHS) - 1), (64, 2)])
def test_sweep_graphs_equivalent_to_pallas(p, gi, ref_pallas):
    _assert_pipeline_equivalent(SWEEP_GRAPHS[gi], p, pallas=True)


@pytest.mark.parametrize("method,lam", [("w_pg", 1.0), ("libra", 1.0),
                                        ("wb_libra", 1.25)])
def test_methods_and_lambda_equivalent(method, lam):
    _assert_pipeline_equivalent(SWEEP_GRAPHS[0], 8, method=method, lam=lam)


def test_ingested_trace_equivalent(tmp_path, ref_pallas):
    """One real NDJSON trace, ingested by the JAX package and handed over
    as an .npz snapshot that the port reads itself."""
    from repro.trace import load_graph
    g = load_graph(os.path.join(TRACES, "toy_loop.ndjson"))
    path = os.path.join(tmp_path, "toy_loop.npz")
    g.save_npz(path)
    gt = T.IRGraph.load_npz(path)
    _assert_pipeline_equivalent(g, 8, gt=gt, pallas=True)
    # the snapshot path runs the whole pipeline as well
    a = T.run_pipeline(path, 8, "wb_libra", device="cpu")
    b = T.run_pipeline(gt, 8, "wb_libra", device="cpu")
    np.testing.assert_array_equal(a[2].core_times, b[2].core_times)


@pytest.mark.parametrize("name", R.all_benchmark_names())
def test_benchmark_graphs_equivalent(name):
    """The paper's 10 traced benchmarks (Table 3, reduced scale), each
    traced by the port's own tracer and by the reference's."""
    _assert_pipeline_equivalent(R.build_graph(name, cache_dir=None), 8,
                                gt=T.build_graph(name))


def test_plan_graph_equivalent():
    from repro.core.planner import plan_graph as ref_plan
    g = SWEEP_GRAPHS[-1]
    a = ref_plan(g, 64, backend="reference")
    b = T.plan_graph(_port(g), 64, device="cpu")
    np.testing.assert_array_equal(b.cut.assignment, a.cut.assignment)
    assert b.exec_time == pytest.approx(a.exec_time, rel=1e-12)
    assert b.comm_bytes == pytest.approx(a.comm_bytes, rel=1e-12)


@pytest.mark.cuda
def test_pipeline_on_the_card_matches_fast():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    from repro_torch.core.cuda import segsum
    gt = _port(SWEEP_GRAPHS[-1])
    fast = T.run_pipeline(gt, 64, "wb_libra", backend="fast")
    segsum.launches = 0
    part, mapping, rep = T.run_pipeline(gt, 64, "wb_libra")
    assert segsum.launches > 0
    np.testing.assert_array_equal(part.loads, fast[0].loads)
    np.testing.assert_array_equal(part.replica_flat, fast[0].replica_flat)
    np.testing.assert_array_equal(mapping.core_of, fast[1].core_of)
    np.testing.assert_array_equal(rep.core_times, fast[2].core_times)


@pytest.mark.cuda
def test_default_calls_launch_the_kernel():
    """Each entry point, called with its defaults, runs on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    from repro_torch.core.cuda import segsum
    gt = _port(SWEEP_GRAPHS[-1])
    cut = T.vertex_cut(gt, 16, device="cpu")
    mapping = T.round_robin_mapping(16)
    calls = {
        "run_pipeline": lambda: T.run_pipeline(gt, 16, "wb_libra"),
        "plan_graph": lambda: T.plan_graph(gt, 16),
        "vertex_cut": lambda: T.vertex_cut(gt, 16),
        "cluster_interaction_graphs":
            lambda: T.cluster_interaction_graphs(cut, 16),
        "simulate": lambda: T.simulate(gt, cut, mapping),
    }
    for name, call in calls.items():
        segsum.launches = 0
        call()
        assert segsum.launches > 0, name
