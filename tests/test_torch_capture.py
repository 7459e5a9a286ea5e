"""Program capture (`repro_torch.core.op_graph`) and the planner's
`plan_step` / `optimal_parallelism` against the JAX package's jaxpr graph
builder and planner.

On the CPU the port captures with `device="cpu"`, and the JAX package
traces as its own tests do (`impl="pallas"` is only traced, never run):
- the mlp demo program's graph is the JAX graph: n, src, dst and w bit for
  bit, the labels equal under `JAX_LABEL`;
- the attention and scan_rnn programs' graphs are pinned, beside the JAX
  graph's sizes;
- a reduced model's `mm` vertices are the JAX graph's `dot_general`s and
  its kernel vertices the JAX graph's `pallas_call`s;
- `plan_step` equals the JAX `plan_step`, and a captured train step
  equals an uncaptured one.
The tests marked `cuda` capture on the card and hold the graphs to the
host's; they import no JAX.
"""
import collections
import gc
import os
import subprocess
import sys
import types
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import models  # noqa: E402
from repro_torch.configs import ARCHS, reduced_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.core import op_graph  # noqa: E402
from repro_torch.core.cuda import segsum  # noqa: E402
from repro_torch.core.op_graph import (capture, op_flops,  # noqa: E402
                                       trace_to_graph)
from repro_torch.core.planner import (optimal_parallelism,  # noqa: E402
                                      plan_graph, plan_step)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rglru, rwkv6  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.trace import demo_program, ingest_trace  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

# the port's operator -> the JAX primitive in the same place
JAX_LABEL = {"input": "input", "mm": "dot_general", "tanh": "tanh",
             "sum": "reduce_sum"}
# (vertices, edges, total weight) of the port's graph, then the JAX
# graph's: the JAX graph has literal vertices, a max-subtracted softmax
# of 8 primitives where ATen has one `_softmax`, and a scan whose stacked
# output is one unconnected vertex where the port stacks 5 step outputs
DEMO_SIZES = {"attention": ((7, 6, 1008.0), (19, 20, 1932.0)),
              "scan_rnn": ((20, 31, 800.0), (21, 27, 724.0))}
# the kernels' vertices and the matrix products: a reduced model's
# graph holds as many of each as the JAX graph's `pallas_call`s and
# `dot_general`s; neither package fuses a product the other does not
KERNELS = ("flash_attention", "rglru", "rwkv6")
PRODUCTS = ("mm", "bmm", "addmm", "baddbmm")
MODEL_COUNTS = {"smollm-360m": (15, 2), "recurrentgemma-9b": (47, 6)}
MODEL_B, MODEL_S = 2, 64


@pytest.fixture(scope="module")
def jx():
    """The JAX package's graph builder and planner.  Imported here, not at
    the top, so the tests marked `cuda` also run where JAX is not
    installed."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import models as jmodels
    from repro.configs import ARCHS as JARCHS
    from repro.configs import reduced_config as jreduced
    from repro.core import planner as jplanner
    from repro.core.jaxpr_graph import trace_to_graph as jtrace
    from repro.trace import demo_program as jdemo
    return types.SimpleNamespace(jax=jax, jnp=jnp, models=jmodels,
                                 ARCHS=JARCHS, reduced=jreduced,
                                 planner=jplanner, trace=jtrace, demo=jdemo)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _demo_graph(name, device="cpu"):
    fn, args = demo_program(name, device=device)
    return trace_to_graph(fn, *args, name=name)


def _same_arrays(a, b) -> bool:
    return (a.n == b.n and np.array_equal(a.src, b.src)
            and np.array_equal(a.dst, b.dst) and np.array_equal(a.w, b.w))


def _same(a, b) -> bool:
    """Bit for bit, labels included (an ingested trace labels a vertex
    written inline as "const", so it is held by `_same_arrays`)."""
    return _same_arrays(a, b) and list(a.node_labels) == list(b.node_labels)


def test_mlp_graph_is_the_jax_graph(jx):
    g = _demo_graph("mlp")
    fn, args = jx.demo("mlp")
    want = jx.trace(fn, *args, name="mlp")
    assert g.n == want.n == 7
    np.testing.assert_array_equal(g.src, want.src)
    np.testing.assert_array_equal(g.dst, want.dst)
    np.testing.assert_array_equal(g.w, want.w)
    assert [JAX_LABEL[x] for x in g.node_labels] == list(want.node_labels)
    assert g.w.sum() == 1472.0


@pytest.mark.parametrize("name", sorted(DEMO_SIZES))
def test_demo_graph_sizes(name, jx):
    g = _demo_graph(name)
    ours, theirs = DEMO_SIZES[name]
    assert (g.n, g.num_edges, float(g.w.sum())) == ours
    fn, args = jx.demo(name)
    want = jx.trace(fn, *args, name=name)
    assert (want.n, want.num_edges, float(want.w.sum())) == theirs
    # the same program: the graphs' sizes within a factor of 3
    assert 1 / 3 <= g.n / want.n <= 3
    assert 1 / 3 <= g.w.sum() / want.w.sum() <= 3


@pytest.fixture(scope="module")
def model_graphs(jx):
    """name -> (the port's graph, the JAX graph) of a reduced model's
    forward on the same weights and tokens."""
    out = {}
    for name in MODEL_COUNTS:
        jcfg = jx.reduced(jx.ARCHS[name])
        params = jx.models.init_params(jcfg, jx.jax.random.PRNGKey(0))
        toks = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                                 (MODEL_B, MODEL_S))
        want = jx.trace(
            lambda p, b: jx.models.forward(jcfg, p, b, impl="pallas"),
            params, {"tokens": jx.jnp.asarray(toks, jx.jnp.int32)},
            name=name)
        model = models.from_jax_params(
            reduced_config(ARCHS[name]),
            jx.jax.tree.map(np.asarray, params), device="cpu")
        with torch.no_grad():
            g = trace_to_graph(
                lambda m, b: models.forward(m, b, impl="cuda"), model,
                {"tokens": torch.as_tensor(toks)}, name=name)
        out[name] = (g, want)
    return out


@pytest.mark.parametrize("name", sorted(MODEL_COUNTS))
def test_reduced_model_products_and_kernels_match_jax(name, model_graphs):
    g, want = model_graphs[name]
    ours = collections.Counter(g.node_labels)
    theirs = collections.Counter(want.node_labels)
    n_mm, n_kernels = MODEL_COUNTS[name]
    assert ours["mm"] == theirs["dot_general"] == n_mm
    assert sum(ours[k] for k in PRODUCTS) == n_mm     # nothing fused
    assert sum(ours[k] for k in KERNELS) == theirs["pallas_call"] \
        == n_kernels
    assert ours["flash_attention"] == 2


def test_reduced_model_graph_roundtrips(model_graphs):
    """A model's captured graph is also an NDJSON trace."""
    import io

    from repro_torch.trace import record_graph
    for g, _ in model_graphs.values():
        buf = io.StringIO()
        record_graph(g, buf)
        buf.seek(0)
        g2 = ingest_trace(buf, weight_model="bytes", keep_labels=True)
        assert _same_arrays(g, g2)


def test_views_inputs_and_in_place_writes():
    """A view makes no vertex and resolves to its storage's producer; an
    in-place write makes a vertex with an edge from the previous
    producer; a parameter first used inside is a "free" vertex; an out=
    operand is written, not read."""
    w = torch.ones(3, 3)

    def prog(x):
        y = x.view(9).mul(2.0)           # view: no vertex
        y.add_(1.0)                      # in place: a new producer
        z = y[:3].sum()                  # reads the add_
        torch.mul(y, y, out=y)           # out=: one read of y per operand
        return z + (w @ y.view(3, 3)).sum()

    g = trace_to_graph(prog, torch.ones(3, 3))
    assert g.node_labels == ["input", "mul", "add_", "sum", "mul", "mm",
                             "free", "sum", "add"]
    edges = list(zip(g.src.tolist(), g.dst.tolist(), g.w.tolist()))
    assert edges == [(0, 1, 36.0), (1, 2, 36.0), (2, 3, 12.0),
                     (2, 4, 36.0), (2, 4, 36.0), (6, 5, 36.0),
                     (4, 5, 36.0), (5, 7, 36.0), (3, 8, 4.0), (7, 8, 4.0)]


def test_kernel_wrappers_are_one_vertex_each():
    """Each wrapper is one vertex named after its kernel, with the
    wrapper's tensor arguments as edges, producing its outputs; the plain
    versions' operators make none."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, 2, 16, generator=gen) for _ in range(3))
    x, a = torch.randn(1, 8, 16, generator=gen), torch.rand(1, 8, 16)
    r, kk, vv = (torch.randn(1, 8, 2, 4, generator=gen) for _ in range(3))
    ww, u = torch.rand(1, 8, 2, 4), torch.randn(2, 4, generator=gen)
    ids = torch.tensor([0, 0, 1, 3])

    def prog():
        o = fa.flash_attention(q, k, v)
        h, _ = rglru.rglru_scan(x, a)
        out, s = rwkv6.rwkv6_scan(r, kk, vv, ww, u)
        seg = segsum.segment_sum(torch.ones(4, dtype=torch.float64), ids, 4)
        return o.sum() + h.sum() + out.sum() + s.sum() + seg.sum()

    g = trace_to_graph(prog)
    labels = g.node_labels
    for name, n_in in (("flash_attention", 3), ("rglru", 2), ("rwkv6", 5),
                       ("segment_sum", 2)):
        assert labels.count(name) == 1
        vid = labels.index(name)
        assert int((g.dst == vid).sum()) == n_in
        assert int((g.src == vid).sum()) >= 1      # its output is read
    assert "bmm" not in labels and "exp" not in labels
    assert op_graph._active is None


def test_a_failing_kernel_propagates_and_closes_the_capture():
    q = torch.ones(1, 4, 3, 16)
    k = torch.ones(1, 4, 2, 16)      # 3 heads on 2: the wrapper raises

    def prog(x):
        return fa.flash_attention(x, k, k)

    with pytest.raises(ValueError, match="multiple of Hkv"):
        trace_to_graph(prog, q)
    assert op_graph._active is None
    assert trace_to_graph(lambda t: t * 2, q).node_labels == ["input", "mul"]


def test_capture_keeps_no_tensor_alive():
    refs = []

    def prog(x):
        y = torch.tanh(x @ x)
        refs.append(weakref.ref(y))
        return y.sum()

    g, out = capture(prog, torch.ones(64, 64))
    assert g.node_labels == ["input", "mm", "tanh", "sum"]
    assert out.item() == 64 * 64
    del out
    gc.collect()
    assert refs[0]() is None


def test_op_flops():
    a, b = torch.ones(4, 8), torch.ones(8, 5)
    A = torch.ops.aten
    assert op_flops(A.mm.default, (a, b), a @ b) == 2 * 4 * 5 * 8
    assert op_flops("addmm", (torch.ones(5), a, b), a @ b) == 2 * 4 * 5 * 8
    bb = torch.ones(3, 4, 8)
    assert op_flops("bmm", (bb, torch.ones(3, 8, 2)),
                    torch.ones(3, 4, 2)) == 2 * 24 * 8
    assert op_flops(A.tanh.default, (a,), torch.tanh(a)) == 32
    assert op_flops("split", (a, 2), list(a.split(2))) == 16


def test_plan_step_matches_jax(jx):
    fn, args = demo_program("mlp", device="cpu")
    jfn, jargs = jx.demo("mlp")
    for p in (2, 4):
        got = plan_step(fn, *args, p=p, backend="fast")
        want = jx.planner.plan_step(jfn, *jargs, p=p, backend="fast")
        assert got.summary() == want.summary()
        np.testing.assert_array_equal(got.cut.assignment,
                                      want.cut.assignment)
        assert (got.exec_time, got.comm_bytes) == (want.exec_time,
                                                   want.comm_bytes)
        dev = plan_step(fn, *args, p=p, backend="cuda", device="cpu")
        assert dev.summary() == got.summary()
        np.testing.assert_array_equal(dev.cut.assignment, got.cut.assignment)


def test_plan_step_passes_only_the_programs_keywords():
    seen = {}

    def prog(x, *, scale):
        seen["scale"] = scale
        return (x * scale).sum()

    rep = plan_step(prog, torch.ones(4, 4), p=2, backend="cuda",
                    device="cpu", scale=3.0)
    assert seen == {"scale": 3.0} and rep.p == 2


def test_optimal_parallelism_picks_the_argmin():
    fn, args = demo_program("scan_rnn", device="cpu")
    cands = (2, 3, 4)
    best, reports = optimal_parallelism(fn, *args, candidates=cands,
                                        device="cpu")
    times = [r.exec_time for r in reports]
    assert [r.p for r in reports] == list(cands)
    assert best == cands[int(np.argmin(times))]
    g = reports[0].graph      # captured once, planned at each candidate
    assert all(r.graph is g for r in reports)
    again = plan_graph(g, 3, backend="fast")
    assert again.exec_time == reports[1].exec_time


def _train(cfg, seed=0):
    model = models.Model(cfg, device="cpu", generator=torch.Generator()
                         .manual_seed(seed)).requires_grad_(True)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=4)
    step = make_train_step(cfg, opt_cfg, ParallelConfig(microbatches=2),
                           impl="cuda")
    return step, model, adamw_init(models.param_tree(model), opt_cfg)


def test_captured_train_step_is_unchanged():
    cfg = reduced_config(ARCHS["smollm-360m"])
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 2, 32)))
    step, model, opt = _train(cfg)
    _, _, want = step(model, opt, {"tokens": toks})
    step, model2, opt2 = _train(cfg)
    g, (_, _, got) = capture(step, model2, opt2, {"tokens": toks})
    assert got["loss"].item() == want["loss"].item()
    assert got["grad_norm"].item() == want["grad_norm"].item()
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)
    labels = collections.Counter(g.node_labels)
    # 2 microbatches x 2 layers; on the CPU the backward is the plain
    # version's autograd operators, not a kernel vertex
    assert labels["flash_attention"] == 4
    assert labels["flash_attention_bwd"] == 0
    assert labels["_softmax_backward_data"] == 4     # the plain attention's
    assert labels["silu_backward"] == 4 and labels["mm"] > 15
    assert labels["add_"] > 0        # the accumulators and AdamW in place


# ---------------------------------------------------------------------- #
# on the card
# ---------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("name", ["attention", "mlp", "scan_rnn"])
def test_record_on_the_card_matches_the_cpu(name, cuda_device, tmp_path):
    """`python -m repro_torch.trace record` on the card writes a trace
    that ingests to the in-process capture's graph on the card and on
    the host."""
    out = os.path.join(tmp_path, f"{name}.ndjson")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-m", "repro_torch.trace", "record", out,
                    "--program", name], check=True, env=env, timeout=300)
    g = ingest_trace(out, weight_model="bytes", keep_labels=True)
    on_card = _demo_graph(name, device="cuda")
    assert _same_arrays(g, on_card)
    assert _same(on_card, _demo_graph(name, device="cpu"))


@pytest.mark.cuda
def test_reduced_recurrentgemma_on_the_card_matches_the_cpu(cuda_device):
    """The forward through the kernels captures to the host's graph, bit
    for bit, and its kernel vertices are the launches."""
    cfg = reduced_config(ARCHS["recurrentgemma-9b"])
    cpu = models.Model(cfg, device="cpu")
    gpu = models.from_jax_params(cfg, models.to_jax_params(cpu))
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MODEL_B, MODEL_S)))

    def fwd(m, b):
        return models.forward(m, b, impl="cuda")

    with torch.no_grad():
        want = trace_to_graph(fwd, cpu, {"tokens": toks})
        fa.launches = rglru.launches = 0
        got = trace_to_graph(fwd, gpu, {"tokens": toks.cuda()})
        torch.cuda.synchronize()
    assert _same(got, want)
    labels = collections.Counter(got.node_labels)
    assert labels["flash_attention"] == fa.launches == 2
    assert labels["rglru"] == rglru.launches == 4


@pytest.mark.cuda
def test_captured_train_step_on_the_card(cuda_device):
    """On the card the backward kernels are vertices, counted as their
    launches, and the capture changes no bit of the step."""
    cfg = reduced_config(ARCHS["smollm-360m"])
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 2, 32))).cuda()
    cpu = models.Model(cfg, device="cpu")
    runs = []
    for captured in (False, True):
        model = models.from_jax_params(cfg, models.to_jax_params(cpu))
        model.requires_grad_(True)
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=4)
        step = make_train_step(cfg, opt_cfg, ParallelConfig(microbatches=2))
        opt = adamw_init(models.param_tree(model), opt_cfg)
        fa.launches = fa.launches_bwd = 0
        if captured:
            g, (_, _, m) = capture(step, model, opt, {"tokens": toks})
        else:
            _, _, m = step(model, opt, {"tokens": toks})
        torch.cuda.synchronize()
        runs.append((m["loss"].item(), [p.detach().clone()
                                        for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    labels = collections.Counter(g.node_labels)
    assert labels["flash_attention"] == fa.launches == 4
    assert labels["flash_attention_bwd"] == fa.launches_bwd == 4
