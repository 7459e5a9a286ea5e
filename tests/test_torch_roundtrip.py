"""Round-trip oracle of the port: `repro_torch.trace.record` output
re-ingested by the port's `ingest_trace` must equal
`repro_torch.core.op_graph.trace_to_graph` **bit-identically** in vertex
count and `src`/`dst`, with `w` equal under the `bytes` weight model and
`src`/`dst` identical under every other weight model.

The cases mirror `tests/test_trace_roundtrip.py`, with its case names:
the demo programs (written in PyTorch), a nested-call program in place of
the jit-wrapped one, a Python-loop RNN at the scan's unroll depths, and
the seeded MLP and op-soup generators.  The port's `record_graph` also
writes the JAX package's bytes for the JAX package's own graphs.
"""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.op_graph import trace_to_graph  # noqa: E402
from repro_torch.trace import (DEMO_PROGRAMS, WEIGHT_MODELS,  # noqa: E402
                               demo_program, ingest_trace, record_graph)


def roundtrip(g):
    buf = io.StringIO()
    lines = record_graph(g, buf)
    assert lines >= 1
    buf.seek(0)
    return ingest_trace(buf, weight_model="bytes", keep_labels=True)


def assert_bit_identical(g, g2, check_w=True):
    assert g2.n == g.n
    assert np.array_equal(g.src, g2.src)
    assert np.array_equal(g.dst, g2.dst)
    if check_w:
        assert np.array_equal(g.w, g2.w)


def _ones(*shape):
    return torch.ones(shape, dtype=torch.float32)


@pytest.mark.parametrize("name", sorted(DEMO_PROGRAMS))
def test_demo_program_roundtrip(name):
    fn, args = demo_program(name, device="cpu")
    g = trace_to_graph(fn, *args, name=name)
    assert_bit_identical(g, roundtrip(g))


@pytest.mark.parametrize("name", sorted(DEMO_PROGRAMS))
@pytest.mark.parametrize("model", sorted(WEIGHT_MODELS))
def test_roundtrip_edges_identical_across_weight_models(name, model):
    fn, args = demo_program(name, device="cpu")
    g = trace_to_graph(fn, *args, name=name)
    buf = io.StringIO()
    record_graph(g, buf)
    buf.seek(0)
    g2 = ingest_trace(buf, weight_model=model)
    # src/dst are weight-model independent; w is exact for "bytes"
    assert_bit_identical(g, g2, check_w=(model == "bytes"))


def test_nested_call_roundtrip():
    """Nested Python calls inline into the caller's trace, and a
    parameter read inside them is a free vertex created in its first
    consumer's operand loop, shared by later uses — the trickiest
    creation-order case for the serializer."""
    bias = _ones(4)

    def inner(h):
        return torch.tanh(h + bias) * 2.0

    def f(x, w):
        h = inner(x @ w)
        return (inner(h) + bias).sum()

    g = trace_to_graph(f, _ones(4, 8), _ones(8, 4), name="nested")
    assert g.node_labels.count("free") == 1
    assert_bit_identical(g, roundtrip(g))


@pytest.mark.parametrize("steps", (1, 3, 8))
def test_loop_rnn_roundtrip_depths(steps):
    """The scan's counterpart: a Python loop runs every step."""
    def rnn(xs, w):
        h = torch.zeros(xs.shape[1], dtype=xs.dtype)
        ys = []
        for x in xs:
            h = torch.tanh(h @ w + x)
            ys.append(h)
        return torch.stack(ys).sum()

    g = trace_to_graph(rnn, _ones(steps, 4), _ones(4, 4), name="rnn")
    assert g.node_labels.count("tanh") == steps
    assert_bit_identical(g, roundtrip(g))


def _mlp_roundtrip(depth, width, batch, residual, reduce_op):
    def fwd(x, ws):
        for w in ws:
            h = torch.tanh(x @ w)
            x = x + h if residual else h
        return {"sum": torch.sum, "max": torch.max,
                "mean": torch.mean}[reduce_op](x)

    ws = [_ones(width, width) for _ in range(depth)]
    g = trace_to_graph(fwd, _ones(batch, width), ws, name="mlp_prop")
    assert g.node_labels.count("input") == depth + 1
    assert_bit_identical(g, roundtrip(g))


def _op_soup_roundtrip(seed, n_eqns):
    """Random elementwise/matmul op soups over a shared pool of values —
    stresses fan-out-heavy graphs."""
    rng = np.random.default_rng(seed)
    ops = rng.integers(0, 4, n_eqns)
    picks = rng.integers(0, 1 << 30, (n_eqns, 2))

    def soup(x, y):
        pool = [x, y]
        for k in range(n_eqns):
            a = pool[picks[k, 0] % len(pool)]
            b = pool[picks[k, 1] % len(pool)]
            if ops[k] == 0:
                r = a + b
            elif ops[k] == 1:
                r = a * 0.5 + b
            elif ops[k] == 2:
                r = torch.maximum(a, b) + 1.0
            else:
                r = torch.tanh(a) * b
            pool.append(r)
        return sum(p.sum() for p in pool[2:])

    g = trace_to_graph(soup, _ones(3, 3), _ones(3, 3), name="soup")
    assert_bit_identical(g, roundtrip(g))


# the seeded sweeps of the JAX package's oracle, with its case names
@pytest.mark.parametrize("depth,width,batch,residual,reduce_op", [
    (1, 2, 1, False, "sum"), (2, 5, 3, True, "max"), (3, 8, 4, True, "mean"),
])
def test_mlp_roundtrip_seeded(depth, width, batch, residual, reduce_op):
    _mlp_roundtrip(depth, width, batch, residual, reduce_op)


@pytest.mark.parametrize("seed,n_eqns", [(0, 2), (7, 12), (1234, 24)])
def test_op_soup_roundtrip_seeded(seed, n_eqns):
    _op_soup_roundtrip(seed, n_eqns)


@pytest.mark.parametrize("name", sorted(DEMO_PROGRAMS))
def test_record_graph_writes_the_jax_bytes(name):
    """The port's `record_graph` is the JAX package's, byte for byte, on
    the JAX package's graph of its own demo program."""
    pytest.importorskip("jax")
    from repro.core.jaxpr_graph import trace_to_graph as jax_trace
    from repro.trace import demo_program as jax_demo
    from repro.trace import record_graph as jax_record
    fn, args = jax_demo(name)
    g = jax_trace(fn, *args, name=name)
    ours, theirs = io.StringIO(), io.StringIO()
    assert record_graph(g, ours) == jax_record(g, theirs)
    assert ours.getvalue() == theirs.getvalue()
