"""The port's telemetry layer (`repro_torch.obs`) against the JAX
package's (`repro.obs`).

The exporters and the summarizer are pure functions of an event list, so
each case feeds one fixed list (absolute timestamps, lanes, categories,
instants) to both packages and requires equal dicts and equal rendered
text; histograms and registries fed the same samples must give equal
snapshots and merges.  The collector's own contracts (zero cost when off,
scoped merging, the Perfetto schema, the `REPRO_PROFILE` hook and
`run_pipeline(profile=)`) are held as `tests/test_obs.py` and
`tests/test_metrics.py` hold the reference's.

The dist engine's telemetry (spans, process-pool event merging, worker
histograms, `REPRO_PROFILE` under a process pool, the warnings' origin,
a real engine timeline through the `timeline` CLI) is held in
`tests/test_torch_dist.py`, and the plan service's metrics and plan-cache
accounting in `tests/test_torch_serve.py`.

Left out:
- `benchmarks/check_regression.py --attribute` belongs to the JAX
  package's benchmarks, which are not ported.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("torch")
R = pytest.importorskip("repro.obs")

from repro.obs import export as rexport  # noqa: E402
from repro.obs import summarize as rsummarize  # noqa: E402
from repro.obs import metrics as rmetrics  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import export, metrics, summarize  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TRACES = os.path.join(ROOT, "examples", "traces")


@pytest.fixture(autouse=True)
def _obs_clean():
    """Every test starts and ends with telemetry disabled in both."""
    obs.disable()
    R.disable()
    yield
    obs.disable()
    R.disable()


def _ev(name, ts, dur=None, lane="main", cat="op", **args):
    ev = {"name": name, "ph": "X" if dur is not None else "i", "ts": ts,
          "lane": lane, "cat": cat if dur is not None else "instant"}
    if dur is not None:
        ev["dur"] = dur
    if args:
        ev["args"] = args
    return ev


# fixed event lists in the collector's layout (absolute µs timestamps)
EVENT_LISTS = {
    "empty": [],
    "two-lanes": [_ev("a", 1e6, 10_000, lane="a"),
                  _ev("b", 1e6 + 5_000, 10_000, lane="b")],
    "waits-and-sections": [
        _ev("env", 2e6, 10_000, lane="a", cat="section"),
        _ev("stall", 2e6, 10_000, lane="b", cat="wait"),
        _ev("real", 2e6, 2_000, lane="b")],
    "nested-with-instants": [
        _ev("outer", 5.0, 900.0, cat="section", k=1),
        _ev("work", 10.0, 300.5, n=3),
        _ev("work", 400.0, 100.25, n=4),
        _ev("remote", 50.0, 700.0, lane="w1"),
        _ev("blip", 60.0, reason="test"),
        _ev("blip", 70.0, reason="test"),
        _ev("plain", 80.0),
        _ev("late", 2000.0, 0.0, lane="w2")],
    "unsorted-many-lanes": [
        _ev(f"s{i}", float((i * 7919) % 1000), float(10 + i % 13),
            lane=f"cut/w{i % 4}", round=i)
        for i in range(40)],
}


def _collectors(events):
    """A collector of each package holding `events`, with the same
    counters, gauges and histogram samples."""
    cols = obs.Collector(), R.Collector()
    for col in cols:
        col.absorb_events([dict(e) for e in events])
        col.add("edges", 42)
        col.add("edges", 8)
        col.set_gauge("depth", 7)
        for v in (3.0, 30.0, 300.0):
            col.metrics.observe("lat_us", v)
    return cols


# ---------------------------------------------------------------------- #
# exporters and the summarizer: equal on one fixed event list
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(EVENT_LISTS))
def test_chrome_trace_matches_reference(name):
    port, ref = _collectors(EVENT_LISTS[name])
    doc = export.chrome_trace(port)
    assert doc == rexport.chrome_trace(ref)
    assert export.events_from_chrome(doc) == rexport.events_from_chrome(doc)


@pytest.mark.parametrize("name", sorted(EVENT_LISTS))
def test_summarize_matches_reference(name):
    events = EVENT_LISTS[name]
    got = summarize.summarize_events(events)
    assert got == rsummarize.summarize_events(events)
    counters = {"edges": 50.0, "hits": 3}
    assert summarize.render_summary(got, counters) == \
        rsummarize.render_summary(got, counters)
    # and on the events a profile file gives back
    doc = export.chrome_trace(_collectors(events)[0])
    back = export.events_from_chrome(doc)
    assert summarize.summarize_events(back) == \
        rsummarize.summarize_events(back)


def _sample_timeline():
    return {"workers": 2, "merge_period": 100, "full_merges": 1,
            "round_merges": 2, "finalize_us": 40.0,
            "rounds": [
                {"round": 0, "edges": 200, "parse_wait_us": 50.0,
                 "cut_us": [100.0, 120.0], "merge_us": 30.0,
                 "full_merge": True},
                {"round": 1, "edges": 150, "parse_wait_us": 10.0,
                 "cut_us": [90.0, 80.0], "merge_us": 0.0},
            ]}


@pytest.mark.parametrize("timeline", [
    _sample_timeline(), {"rounds": []}, {},
    {"rounds": [{"round": 3, "cut_us": [5.0]}], "workers": 1}])
def test_timeline_trace_matches_reference(timeline):
    doc = export.timeline_trace(timeline)
    assert doc == rexport.timeline_trace(timeline)


def test_timeline_trace_synthetic_tracks():
    doc = export.timeline_trace(_sample_timeline())
    events = export.events_from_chrome(doc)
    assert {e["lane"] for e in events} == {"coord", "cut/w0", "cut/w1"}
    by_name: dict = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    assert len(by_name["dist.parse_wait"]) == 2
    assert len(by_name["dist.cut"]) == 4
    assert len(by_name["dist.merge"]) == 1       # merge_us=0 is skipped
    assert len(by_name["dist.finalize"]) == 1
    cuts0 = [e for e in by_name["dist.cut"] if e["args"]["round"] == 0]
    assert all(e["ts"] == pytest.approx(50.0) for e in cuts0)
    assert by_name["dist.merge"][0]["ts"] == pytest.approx(50.0 + 120.0)
    assert by_name["dist.parse_wait"][0]["cat"] == "wait"
    assert doc["repro"]["gauges"]["timeline.workers"] == 2


def test_profiles_move_between_the_packages(tmp_path):
    port, ref = _collectors(EVENT_LISTS["nested-with-instants"])
    a, b = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    export.write_profile(a, port)
    rexport.write_profile(b, ref)
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()
    assert export.load_profile(b) == rexport.load_profile(a)


# ---------------------------------------------------------------------- #
# the collector (tests/test_obs.py)
# ---------------------------------------------------------------------- #
def test_disabled_is_noop_and_cheap():
    assert not obs.enabled() and obs.current() is None
    assert obs.span("a") is obs.span("b", lane="x", big=1)
    t0 = time.perf_counter()
    for _ in range(100_000):
        with obs.span("hot", lane="w", n=1) as sp:
            sp.set(k=2)
        obs.counter("c")
        obs.event("e")
        obs.observe("h", 1.0)
        obs.gauge("g", 1.0)
        obs.complete("x", 0.0, 1.0)
    dt = time.perf_counter() - t0
    assert dt < 2.0, f"100k disabled calls took {dt:.3f}s"
    assert obs.current() is None


def _collect_sample():
    with obs.scoped(merge=False) as col:
        with obs.span("outer", lane="main", cat="section"):
            with obs.span("work", lane="main", n=3) as sp:
                time.sleep(0.001)
                sp.set(full=True)
            t = time.perf_counter()
            obs.complete("remote", t - 0.002, t, lane="w1")
        obs.event("blip", lane="main", reason="test")
        obs.counter("edges", 42)
        obs.counter("edges", 8)
        obs.gauge("depth", 7)
    return col


def test_perfetto_export_schema():
    col = _collect_sample()
    doc = export.chrome_trace(col)
    evs = doc["traceEvents"]
    assert doc["displayTimeUnit"] == "ms"
    meta = [e for e in evs if e["ph"] == "M"]
    body = [e for e in evs if e["ph"] != "M"]
    assert {m["name"] for m in meta} == {"thread_name"}
    assert {m["args"]["name"] for m in meta} == {"main", "w1"}
    assert len({m["tid"] for m in meta}) == len(meta)
    for e in body:
        assert e["ph"] in ("X", "i")
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        assert e["ts"] >= 0
        if e["ph"] == "X":
            assert e["dur"] >= 0
        else:
            assert e["s"] == "t"
    by_tid: dict = {}
    for e in body:
        assert e["ts"] >= by_tid.get(e["tid"], 0)
        by_tid[e["tid"]] = e["ts"]
    assert doc["repro"]["counters"]["edges"] == 50
    assert doc["repro"]["gauges"]["depth"] == 7
    work = [e for e in body if e["name"] == "work"]
    assert work[0]["args"] == {"n": 3, "full": True}


def test_export_roundtrip_and_summary(tmp_path):
    col = _collect_sample()
    path = str(tmp_path / "prof.json")
    export.write_profile(path, col)
    doc = export.load_profile(path)
    events = export.events_from_chrome(doc)
    assert {e["lane"] for e in events} == {"main", "w1"}
    assert {"outer", "work", "remote", "blip"} <= {e["name"] for e in events}
    s = summarize.summarize_events(events)
    assert s["wall_us"] > 0 and s["instants"] == {"blip[test]": 1}
    assert summarize.render_summary(s, doc["repro"]["counters"])


def test_summary_decomposition_sums_to_wall():
    s = summarize.summarize_events(EVENT_LISTS["two-lanes"])
    assert s["wall_us"] == pytest.approx(15_000, rel=1e-6)
    assert s["parallel_us"] == pytest.approx(5_000, rel=1e-6)
    assert s["serial_us"] == pytest.approx(10_000, rel=1e-6)
    assert s["idle_us"] == pytest.approx(0, abs=1e-6)
    assert s["serial_fraction"] == pytest.approx(2 / 3, rel=1e-6)
    s2 = summarize.summarize_events(EVENT_LISTS["waits-and-sections"])
    assert s2["serial_us"] == pytest.approx(2_000, rel=1e-6)
    assert s2["parallel_us"] == pytest.approx(0, abs=1e-6)


def test_enable_disable_and_scoped_restore():
    col = obs.enable()
    assert obs.enabled() and obs.current() is col
    with obs.scoped() as inner:
        obs.counter("c", 2)
        obs.event("e", lane="x")
        assert obs.current() is inner
    assert obs.current() is col
    assert col.counters == {"c": 2.0}
    assert [e["name"] for e in col.events] == ["e"]
    mine = obs.Collector()
    assert obs.enable(mine) is mine and obs.disable() is mine
    assert obs.disable() is None and not obs.enabled()


def test_run_pipeline_profile_has_the_reference_span_names(tmp_path):
    """`run_pipeline(ndjson_path, ..., profile=)` writes a profile that
    `load_profile` reads, with the spans the reference's profile of the
    same call has (its `fast` backend; the port's `cuda` on the CPU)."""
    import repro.core as RC
    import repro_torch.core as TC
    trace = os.path.join(TRACES, "toy_loop.ndjson")
    ours, theirs = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    part, _, rep = TC.run_pipeline(trace, 4, "wb_libra", device="cpu",
                                   profile=ours)
    ref = RC.run_pipeline(trace, 4, "wb_libra", profile=theirs)
    np.testing.assert_array_equal(part.assignment, ref[0].assignment)
    assert rep.exec_time == ref[2].exec_time
    got, want = (export.events_from_chrome(export.load_profile(p))
                 for p in (ours, theirs))
    names = sorted({(e["name"], e["cat"], e["lane"]) for e in got})
    assert names == sorted({(e["name"], e["cat"], e["lane"]) for e in want})
    assert {"pipeline.ingest", "trace.ingest", "pipeline.partition",
            "pipeline.map", "pipeline.simulate"} <= {n for n, _, _ in names}
    assert obs.current() is None


def test_profile_is_written_when_the_run_raises(tmp_path):
    import repro_torch.core as TC
    out = str(tmp_path / "failed.json")
    with pytest.raises(ValueError, match="unknown method"):
        TC.run_pipeline(os.path.join(TRACES, "toy_loop.ndjson"), 4, "nope",
                        device="cpu", profile=out)
    names = {e["name"] for e in export.events_from_chrome(
        export.load_profile(out))}
    assert "pipeline.ingest" in names and obs.current() is None


def test_repro_profile_env_and_summarize_cli(tmp_path):
    """The `REPRO_PROFILE` hook, in a process that imports only the
    port, and `python -m repro_torch.obs summarize` on what it wrote."""
    out = tmp_path / "env.json"
    code = ("import sys, repro_torch.core as T; "
            "g = T.synthesize_powerlaw_graph(300, 2.0, seed=0); "
            "T.run_pipeline(g, 4, 'wb_libra', device='cpu'); "
            "assert not any(m == 'repro' or m.startswith(('repro.', 'jax'))"
            " for m in sys.modules)")
    env = dict(os.environ, REPRO_PROFILE=str(out),
               PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    doc = json.loads(out.read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"pipeline.partition", "cut.finalize", "sim.run"} <= names
    env.pop("REPRO_PROFILE")
    r = subprocess.run([sys.executable, "-m", "repro_torch.obs", "summarize",
                        str(out)], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert "serial fraction" in r.stdout and "pipeline.partition" in r.stdout


def test_obs_cli_matches_reference(tmp_path, capsys):
    from repro.obs.__main__ import main as ref_main
    from repro_torch.obs.__main__ import main
    port, _ = _collectors(EVENT_LISTS["nested-with-instants"])
    prof = str(tmp_path / "p.json")
    export.write_profile(prof, port)
    assert main(["summarize", prof]) == 0
    ours = capsys.readouterr().out
    assert ref_main(["summarize", prof]) == 0
    assert ours == capsys.readouterr().out and "edges" in ours
    bench = tmp_path / "BENCH_fake.json"
    bench.write_text(json.dumps({"suite": "dist_scaling", "rows": [],
                                 "meta": {"timeline_w4": _sample_timeline()}}))
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    assert main(["timeline", str(bench), "-o", a]) == 0
    assert ref_main(["timeline", str(bench), "-o", b]) == 0
    assert "perfetto" in capsys.readouterr().out
    with open(a) as fa, open(b) as fb:
        assert json.load(fa) == json.load(fb)
    raw = tmp_path / "raw.json"
    raw.write_text(json.dumps(_sample_timeline()))
    assert main(["timeline", str(raw), "-o", a, "--key", "x"]) == 0
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"rows": [], "meta": {}}))
    assert main(["timeline", str(empty), "-o", a]) == 1
    export.write_profile(prof, obs.Collector())
    assert main(["summarize", prof]) == 1


# ---------------------------------------------------------------------- #
# histograms and the registry (tests/test_metrics.py)
# ---------------------------------------------------------------------- #
SAMPLES = {
    "single": [3.7],
    "spread": [5.0, 15.0, 25.0, 28.0],
    "decades": [1.0, 10.0, 100.0, 1e3, 1e4, 1e5, 1e6, 1e7, 2e8],
    "seeded": list(np.random.default_rng(0).lognormal(5.0, 2.0, 500)),
    "zeros-and-negatives": [0.0, -1.0, 0.0, 2.5],
}


@pytest.mark.parametrize("bounds", [None, (10.0, 20.0, 30.0), (1.0, 2.0)])
@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_histogram_matches_reference(name, bounds):
    kw = {} if bounds is None else {"bounds": bounds}
    h, hr = metrics.Histogram(**kw), rmetrics.Histogram(**kw)
    for v in SAMPLES[name]:
        h.observe(v)
        hr.observe(v)
    assert h.snapshot() == hr.snapshot()
    for q in (0, 1, 10, 50, 90, 99, 99.9, 100):
        assert h.percentile(q) == hr.percentile(q)
    back = metrics.Histogram.from_snapshot(json.loads(json.dumps(
        h.snapshot())))
    assert back.snapshot() == h.snapshot()
    other, other_r = metrics.Histogram(**kw), rmetrics.Histogram(**kw)
    for v in (2.0, 20.0, 2e4):
        other.observe(v)
        other_r.observe(v)
    h.merge(other)
    hr.merge(other_r)
    assert h.snapshot() == hr.snapshot()


def test_histogram_contracts():
    assert metrics.DEFAULT_BUCKETS_US == rmetrics.DEFAULT_BUCKETS_US
    h = metrics.Histogram()
    h.observe(3.7)
    assert h.percentile(50) == h.percentile(99) == 3.7
    assert metrics.Histogram().percentile(50) == 0.0
    o = metrics.Histogram(bounds=(1.0, 2.0))
    o.observe(100.0)
    assert o.counts == [0, 0, 1] and o.percentile(99) == 100.0
    for bad, cls in ((lambda: h.merge(metrics.Histogram(bounds=(1.0,))),
                      "buckets"),
                     (lambda: metrics.Histogram(bounds=(2.0, 1.0)),
                      "sorted"),
                     (lambda: metrics.Histogram(bounds=()), "sorted")):
        with pytest.raises(ValueError, match=cls):
            bad()


def _fill(reg):
    reg.counter("hits")
    reg.counter("hits", 2)
    reg.gauge("depth", 7)
    for v in (12.0, 24.0, 5e5):
        reg.observe("lat_us", v)
    reg.histogram("custom", buckets=(1.0, 5.0)).observe(3.0)
    return reg


def test_registry_matches_reference():
    reg, ref = _fill(metrics.MetricsRegistry()), _fill(
        rmetrics.MetricsRegistry())
    assert reg.snapshot() == ref.snapshot() and len(reg) == len(ref) == 4
    for q in (50, 99):
        assert reg.percentile("lat_us", q) == ref.percentile("lat_us", q)
    assert reg.percentile("never", 50) == 0.0
    a, b = metrics.MetricsRegistry(), rmetrics.MetricsRegistry()
    for x in (a, b):
        x.counter("c", 1)
        x.observe("h", 10.0)
    a.merge(reg)
    a.merge(json.loads(json.dumps(ref.snapshot())))
    b.merge(ref)
    b.merge(json.loads(json.dumps(reg.snapshot())))
    assert a.snapshot() == b.snapshot()
    assert a.snapshot()["counters"]["hits"] == 6.0
    reg.reset()
    assert len(reg) == 0 and reg.snapshot() == {
        "counters": {}, "gauges": {}, "histograms": {}}


def test_module_observe_zero_cost_and_scoped_merge():
    assert not obs.enabled()
    obs.observe("lat", 1.0)
    with obs.scoped(merge=False) as outer:
        obs.observe("lat", 5.0)
        with obs.scoped() as inner:
            obs.observe("lat", 7.0)
            obs.observe("inner_only", 1.0)
        assert inner.metrics.snapshot()["histograms"]["lat"]["count"] == 1
    snap = outer.metrics.snapshot()["histograms"]
    assert snap["lat"]["count"] == 2
    assert snap["inner_only"]["count"] == 1
    assert obs.current() is None
