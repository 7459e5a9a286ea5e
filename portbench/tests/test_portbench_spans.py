"""The readers of the program's spans (`portbench.spans`) on synthetic
Chrome trace events: their known values, the launches they tie to a
span, the failures of a span that is missing, miscounted or launches
nothing, a program without spans, and the other readers left unchanged
by spans in the trace."""
import pytest

from portbench import harness, spans, tracing, yardstick
from portbench.tests import test_portbench_tracing as base

SPAN_METRICS = ("optimizer_ms.train", "optimizer_launches.train",
                "optimizer_idle_ms.train", "unembed_ms.prefill")


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _launch(ts, corr, tid=1):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid,
              correlation=corr)


def _events():
    """Two train-step units, each with AdamW and the unembedding as
    program spans, and the device work the host launched in them."""
    return [
        _x("user_annotation", tracing.UNIT, 0, 100),
        _x("user_annotation", tracing.UNIT, 100, 100),
        _x("user_annotation", "launch.train_step", 0, 95),
        _x("user_annotation", "launch.train_step", 100, 95),
        _x("user_annotation", "optim.adamw", 20, 30),
        _x("user_annotation", "optim.adamw", 120, 30),
        _x("user_annotation", "models.unembed", 60, 10),
        _x("user_annotation", "models.unembed", 160, 10),
        _x("cpu_op", "aten::mul", 24, 3),
        _launch(10, 0),                   # before the span, runs inside it
        _launch(25, 1),
        _launch(30, 2, tid=2),            # another host thread
        _launch(125, 4),
        _launch(62, 5),
        _launch(162, 6),
        _x("kernel", "mul_kernel", 22, 6, tid=7, correlation=0),
        _x("kernel", "mul_kernel", 30, 10, tid=7, correlation=1),
        _x("kernel", "sqrt_kernel", 38, 7, tid=8, correlation=2),
        _x("gpu_memset", "Memset (Device)", 125, 10, tid=7, correlation=4),
        _x("kernel", "gemm", 62, 5, tid=7, correlation=5),
        _x("gpu_memcpy", "Memcpy DtoD", 163, 8, tid=7, correlation=6),
    ]


# AdamW: unit 1 ties launches 1 and 2 (30-45 on the device, union 15),
# unit 2 launch 4 (10); inside [20, 50] the device runs 22-28 and 30-45
# (idle 9), inside [120, 150] 125-135 (idle 20).  The unembedding ties
# launch 5 (5) and launch 6 (8).  Microseconds in, milliseconds a unit out.
KNOWN = {"optimizer_ms.train": (15 + 10) / 2e3,
         "optimizer_launches.train": 3 / 2,
         "optimizer_idle_ms.train": (9 + 20) / 2e3,
         "unembed_ms.prefill": (5 + 8) / 2e3}


def _window(events):
    work = yardstick.UnitWork(1e9, (), (), 0)
    return tracing.window_from_events(events, work, {})


def _read(metric, events):
    return harness._reader(metric).read(_window(events))


def _without(events, name, keep=0):
    """`events` with the `name` spans after the first `keep` left out."""
    out, seen = [], 0
    for e in events:
        if e["cat"] == "user_annotation" and e["name"] == name:
            seen += 1
            if seen > keep:
                continue
        out.append(e)
    return out


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_span_readers_give_their_known_values(metric):
    assert _read(metric, _events()) == pytest.approx(KNOWN[metric])


def test_an_op_launched_outside_the_span_is_not_counted():
    events = [_launch(15, 1) if e.get("args", {}).get("correlation") == 1
              and e["cat"] == "cuda_runtime" else e for e in _events()]
    assert _read("optimizer_launches.train", events) == 2 / 2
    # launch 2 alone, 38-45, in unit 1
    assert _read("optimizer_ms.train", events) == pytest.approx(
        (7 + 10) / 2e3)
    # the idle time counts every device interval, whoever launched it
    assert _read("optimizer_idle_ms.train", events) == pytest.approx(
        KNOWN["optimizer_idle_ms.train"])


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_a_missing_span_fails(metric):
    span = "models.unembed" if metric.startswith("unembed") else "optim.adamw"
    with pytest.raises(RuntimeError, match=span):
        _read(metric, _without(_events(), span))


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_a_span_count_other_than_the_units_fails(metric):
    span = "models.unembed" if metric.startswith("unembed") else "optim.adamw"
    with pytest.raises(RuntimeError, match="2 traced units"):
        _read(metric, _without(_events(), span, keep=1))
    extra = _x("user_annotation", span, 180, 5)
    with pytest.raises(RuntimeError, match="2 traced units"):
        _read(metric, _events() + [extra])


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_a_span_that_launches_nothing_fails(metric):
    events = [e for e in _events() if e["cat"] != "cuda_runtime"]
    with pytest.raises(RuntimeError, match="no device operation"):
        _read(metric, events)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_a_program_without_spans_reads_nothing(metric):
    """A program that predates the spans (none of them in the trace)
    leaves the metric out of the line; it does not fail the run."""
    events = [e for e in _events() if e["name"] not in spans.PROGRAM_SPANS]
    assert _read(metric, events) is None


def _with_program_spans(events):
    """The tracing tests' events with the program's spans of one step a
    unit around their operators, as the train step nests them."""
    return events + [
        _x("user_annotation", "launch.train_step", 100, 99),
        _x("user_annotation", "launch.train_step", 200, 94),
        _x("user_annotation", "launch.forward", 100, 45),
        _x("user_annotation", "models.unembed", 140, 4),
        _x("user_annotation", "optim.adamw", 146, 80),
        _x("user_annotation", "launch.backward", 201, 40),
        _x("user_annotation", "launch.accumulate", 282, 10),
    ]


def _base_window(events):
    """A window of the tracing tests' events, as their readers' test
    reads it: one unit, each FA kernel launched once."""
    w = tracing.window_from_events(events, base._window({}).work,
                                   {"fa_fwd": 1, "fa_bwd": 1})
    w.units = 1
    return w


@pytest.mark.parametrize("metric", ["idle_share.train", "idle_share.prefill",
                                    "mfu.train", "gemm_ms.train",
                                    "fa_fwd_roofline.train",
                                    "fa_bwd_roofline.train"])
def test_other_readers_are_unchanged_by_program_spans(metric):
    reader = harness._reader(metric)
    plain = reader.read(_base_window(base._events()))
    spanned = reader.read(_base_window(_with_program_spans(base._events())))
    assert plain is not None and spanned == plain


def test_the_breakdown_names_idle_gaps_by_program_span():
    """Gaps where no operator ran now carry the program phase's name:
    280-290 lies in `launch.accumulate`, 295-300 in no span still; the
    gaps inside an operator keep its name."""
    plain = dict(_window(base._events()).breakdown()["idle_gaps"])
    named = dict(_window(_with_program_spans(base._events()))
                 .breakdown()["idle_gaps"])
    assert plain["no operator"] == pytest.approx(15e-6)
    assert named["launch.accumulate"] == pytest.approx(10e-6)
    assert named["no operator"] == pytest.approx(5e-6)
    assert named["aten::copy_"] == plain["aten::copy_"]
