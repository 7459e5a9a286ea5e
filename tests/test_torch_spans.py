"""The port's program spans in `torch.profiler`'s trace.

While the profiler records, `obs.span` also spans a `record_function` of
its name, so the span lands in the profiler's Chrome trace as a
`user_annotation` on the trace's own clock, collector or not; with the
profiler off and no collector it stays the shared no-op.  The train and
prefill steps carry the spans that the benchmark's per-layer metrics read
(`launch.train_step`, `launch.forward`, `launch.backward`,
`launch.accumulate`, `optim.adamw`, `launch.prefill_step`,
`models.unembed`), each the number of times the step's docstring gives,
and the steps compute the same bits with the profiler on as off.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import models, obs  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_train_step)
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

PRODUCTS = ("aten::mm", "aten::matmul", "aten::linear", "aten::addmm",
            "aten::bmm", "aten::einsum")


@pytest.fixture(autouse=True)
def _obs_clean():
    obs.disable()
    yield
    obs.disable()


def _events(prof, tmp_path) -> list:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _named(events, name, cat="user_annotation") -> list:
    return [e for e in events if e.get("cat") == cat and e["name"] == name]


def _inside(e, outer) -> bool:
    return (e.get("tid") == outer.get("tid") and outer["ts"] <= e["ts"]
            and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])


def test_span_lands_in_the_profiler_trace_without_a_collector(tmp_path):
    x = torch.arange(8.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("x"):
            x.mul(2.0)
    assert obs.current() is None
    ev = _events(prof, tmp_path)
    (span,) = _named(ev, "x")
    assert any(_inside(e, span) for e in ev
               if e.get("cat") == "cpu_op" and e["name"] == "aten::mul")


def test_span_records_into_the_collector_and_the_trace(tmp_path):
    with obs.scoped(merge=False) as col:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with obs.span("outer", cat="section"):
                with obs.span("inner", n=1):
                    torch.ones(4).sum()
    assert [e["name"] for e in col.events] == ["inner", "outer"]
    assert col.events[1]["cat"] == "section"
    ev = _events(prof, tmp_path)
    (outer,) = _named(ev, "outer")
    (inner,) = _named(ev, "inner")
    assert _inside(inner, outer)


def test_span_is_the_shared_noop_when_the_profiler_is_off():
    assert obs.span("a") is obs.span("b", cat="section")
    with profile(activities=[ProfilerActivity.CPU]):
        assert obs.span("a") is not obs.span("b")
    assert obs.span("a") is obs.span("b")
    assert obs.current() is None


def _model(seed=0):
    cfg = reduced_config(get_config("smollm-360m"))
    model = models.Model(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    model.requires_grad_(True)
    return cfg, model


def _train_batch(cfg, n_micro, seed=1):
    g = torch.Generator().manual_seed(seed)
    shape = ((n_micro, 2) if n_micro > 1 else (2,)) + (16,)
    return {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=g,
                                    dtype=torch.int32)}


def _train(n_micro, traced, tmp_path=None):
    cfg, model = _model()
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    opt = adamw_init(models.param_tree(model), opt_cfg)
    step = make_train_step(cfg, opt_cfg, ParallelConfig(microbatches=n_micro))
    batch = _train_batch(cfg, n_micro)
    if not traced:
        model, opt, metrics = step(model, opt, batch)
        return model, opt, metrics, None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model, opt, metrics = step(model, opt, batch)
    return model, opt, metrics, _events(prof, tmp_path)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_spans(n_micro, tmp_path):
    model, _, _, ev = _train(n_micro, True, tmp_path)
    (step,) = _named(ev, "launch.train_step")
    assert len(_named(ev, "launch.forward")) == n_micro
    assert len(_named(ev, "launch.backward")) == n_micro
    assert len(_named(ev, "models.unembed")) == n_micro
    assert len(_named(ev, "launch.accumulate")) == (
        n_micro + 2 if n_micro > 1 else 0)
    for name in ("launch.forward", "launch.backward", "launch.accumulate"):
        assert all(_inside(e, step) for e in _named(ev, name))
    (adamw,) = _named(ev, "optim.adamw")
    assert _inside(adamw, step)
    # the global norm's square root and one a leaf, all inside the span
    sqrt = _named(ev, "aten::sqrt", cat="cpu_op")
    assert len(sqrt) == len(list(model.parameters())) + 1
    assert all(_inside(e, adamw) for e in sqrt)
    assert _named(ev, "launch.prefill_step") == []


def test_train_step_gives_the_same_bits_under_the_profiler(tmp_path):
    a = _train(2, False)
    b = _train(2, True, tmp_path)
    for key in ("loss", "grad_norm", "lr"):
        assert torch.equal(a[2][key], b[2][key])
    for x, y in zip(a[0].parameters(), b[0].parameters()):
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves(a[1]), tree_leaves(b[1])):
        assert torch.equal(x, y)


def test_prefill_step_spans_and_bits(tmp_path):
    cfg, model = _model()
    step = make_prefill_step(cfg)
    g = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=g, dtype=torch.int32)}
    plain = step(model, batch)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        for _ in range(2):
            traced = step(model, batch)
    assert torch.equal(plain, traced)
    ev = _events(prof, tmp_path)
    requests = _named(ev, "launch.prefill_step")
    unembeds = _named(ev, "models.unembed")
    assert len(requests) == len(unembeds) == 2
    for req, span in zip(requests, unembeds):
        assert _inside(span, req)
        # the unembedding's product: [B, S, d] by the tied table, [d, V]
        assert any(
            _inside(e, span) and e["name"] in PRODUCTS
            and e["args"]["Input Dims"][1] == [cfg.d_model, cfg.vocab_size]
            for e in ev if e.get("cat") == "cpu_op")
    assert _named(ev, "optim.adamw") == []

