"""The port's trace front end (`repro_torch.trace`) against the JAX
package's (`repro.trace`) on the same inputs.

Every case feeds one input, made from a seed or committed under
`examples/traces/`, to both packages and holds the port to the
reference's own contracts: graphs array-identical (`n`, `src`, `dst`,
`w` with their dtypes, `node_labels`), `TraceStats` summaries equal,
synthetic traces byte-identical, malformed inputs raising the same
exception class with the same message, and `.rtb` containers that either
package writes read back by the other.  The cases mirror
`tests/test_trace_ingest.py` and `tests/test_trace_fastpaths.py`.

The sharded parser's cases (`--workers > 1`, `backend="dist"` on `.rtb`
and `.zst` paths, `.rtb` with a cfg) are held in `tests/test_torch_dist.py`.

Left out until their modules are ported (ROADMAP.md, queue 1):
- `record.py` and the jaxpr round trip of `mlp_jaxpr.ndjson` against the
  live tracer (`test_committed_example_traces`' last part): item 5; the
  port ingests the committed file and is held to the reference's graph;
- the wall-clock gate `test_binary_read_is_10x_faster_than_json`:
  `chip_smoke.py` logs that speed on the card's machine instead.
"""
import gzip
import json
import os
import struct
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
R = pytest.importorskip("repro.trace")

import repro.core as RC  # noqa: E402
from repro.core.planner import plan_graph as ref_plan_graph  # noqa: E402
import repro_torch.core as TC  # noqa: E402
import repro_torch.trace as T  # noqa: E402
from repro_torch.trace.__main__ import main as port_cli  # noqa: E402

TRACES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "examples", "traces")
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def rec(**kw) -> str:
    base = {"fn": "f", "bb": "b0", "op": "add", "def": None, "uses": []}
    base.update(kw)
    return json.dumps(base)


def assert_same_graph(a, b, labels=True):
    assert a.n == b.n
    for f in ("src", "dst", "w"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    if labels:
        la = None if a.node_labels is None else list(a.node_labels)
        lb = None if b.node_labels is None else list(b.node_labels)
        assert la == lb


def both(name: str, *args, **kw):
    """Call `name` of both packages on the same arguments: (port, ref)."""
    return getattr(T, name)(*args, **kw), getattr(R, name)(*args, **kw)


def assert_ingest_equal(source, **kw):
    (g, st), (g_ref, st_ref) = both("ingest_trace_with_stats", source, **kw)
    assert_same_graph(g, g_ref)
    assert st.summary() == st_ref.summary()
    assert g.name == g_ref.name
    return g, st


def assert_same_raise(fn: str, *args, **kw):
    """Both packages raise the same class with the same message: each
    package defines its own error classes, so the class is compared by
    its name and bases (`TraceFormatError` is a `ValueError` in both)."""
    with pytest.raises(Exception) as ref:
        getattr(R, fn)(*args, **kw)
    with pytest.raises(Exception) as port:
        getattr(T, fn)(*args, **kw)
    mro = [[c.__name__ for c in type(e.value).__mro__] for e in (port, ref)]
    assert mro[0] == mro[1]
    assert str(port.value) == str(ref.value)
    return port.value


@pytest.fixture
def scanner_off(monkeypatch):
    monkeypatch.setenv(T.SCANNER_ENV, "0")


@pytest.fixture
def scanner_on(monkeypatch):
    monkeypatch.setenv(T.SCANNER_ENV, "1")


def write_synth(tmp_path, lines, seed, name="t.ndjson", **kw):
    p = tmp_path / name
    T.synthesize_trace(str(p), lines, seed=seed, **kw)
    return str(p)


# ---------------------------------------------------------------------- #
# construction semantics on line lists (tests/test_trace_ingest.py)
# ---------------------------------------------------------------------- #
LINE_SETS = {
    "basic": [
        rec(op="load", **{"def": "v0"}, uses=["arg0"], use_tys=["ptr"]),
        rec(op="mul", **{"def": "v1"}, uses=["v0", "v0"],
            use_tys=["i32", "i32"]),
        rec(op="store", uses=["v1", "arg0"],
            use_tys=["<4 x float>", "ptr"])],
    "const-uses": [
        rec(op="add", **{"def": "v0"},
            uses=["const:i32:7", "const:i32:7"], use_tys=["i32", "i32"]),
        rec(op="add", pp=None, **{"def": "v1"},
            uses=["const:i32:7", "v0"])],
    "def-ty-fallback": [
        rec(op="load", **{"def": "v0"}, def_ty="i16", uses=[]),
        rec(op="add", **{"def": "v1"}, uses=["v0", "v9"])],
    "rolling-def": [
        rec(op="add", **{"def": "v0"}, uses=[]),
        rec(op="mul", **{"def": "v0"}, uses=["v0"]),
        rec(op="sub", **{"def": "v1"}, uses=["v0"])],
    "per-function": [
        rec(fn="a", op="add", **{"def": "v0"}, uses=[]),
        rec(fn="b", op="mul", **{"def": "v9"}, uses=["v0"])],
    "unknown-opcodes": [
        rec(op="frobnicate", **{"def": "v0"}, uses=[]),
        rec(op="quux", uses=["v0"], use_tys=["i64"])],
    "memop-classes": [
        rec(op="add", **{"def": "v0"}, uses=[]),
        rec(op="load", **{"def": "v1"}, uses=["v0"]),
        rec(op="store", uses=["v1"]),
        rec(op="call", **{"def": "v2"}, uses=["v1"])],
    "self-loop-reentry": [
        rec(bb="loop", pp="f:loop:i0", op="add", **{"def": "v0"}),
        rec(bb="loop", pp="f:loop:i1", op="icmp", **{"def": "v1"},
            uses=["v0"]),
        rec(bb="loop", pp="f:loop:i0", op="add", **{"def": "v0"},
            uses=["v0"]),
        rec(bb="loop", pp="f:loop:i1", op="icmp", **{"def": "v1"},
            uses=["v0"])],
    "block-change-resets-pp": [
        rec(pp="f:b0:i0", **{"def": "v0"}),
        rec(bb="b1", pp="f:b1:i0", **{"def": "v1"}),
        rec(pp="f:b0:i0", **{"def": "v2"})],
    "null-use-tys": [
        rec(op="add", **{"def": "v0"}, uses=["x", "y"],
            use_tys=[None, "i32"])],
    "blank-and-cfg-lines": [
        "", "   ", '{"kind":"block","fn":"f","bb":"b0","succs":["b1"]}',
        rec(**{"def": "v0"})],
}


@pytest.mark.parametrize("model", ["bytes", "memop-latency"])
@pytest.mark.parametrize("name", sorted(LINE_SETS))
def test_line_lists_match_reference(name, model):
    assert_ingest_equal(LINE_SETS[name], weight_model=model,
                        keep_labels=True)


def test_basic_graph_is_the_documented_one():
    g, st = T.ingest_trace_with_stats(LINE_SETS["basic"], keep_labels=True)
    assert list(g.node_labels) == ["load", "arg0", "mul", "store"]
    assert g.src.tolist() == [1, 0, 0, 2, 1]
    assert g.dst.tolist() == [0, 2, 2, 3, 3]
    assert g.w.tolist() == [8.0, 4.0, 4.0, 16.0, 8.0]
    assert st.records == 3 and st.livein_uses == 1 and st.void_defs == 1


# ---------------------------------------------------------------------- #
# malformed input: the same class and message, and the same atomic skip
# ---------------------------------------------------------------------- #
BAD_LINES = [
    '{"fn":"f","bb":"b0","op":"tru',
    '["not","an","object"]',
    '{"kind":"wat","fn":"f"}',
    '{"fn":"f","bb":"b0","uses":[]}',
    '{"fn":"f","bb":"b0","op":"a","uses":"v0"}',
    '{"fn":"f","bb":"b0","op":"a","uses":[1,2]}',
    '{"fn":"f","bb":"b0","op":"a","def":5,"uses":[]}',
    '{"fn":"f","bb":"b0","op":"a","uses":["v0"],"use_tys":[]}',
    '{"fn":"f","bb":"b0","op":"a","uses":[],"pp":"g:b9:i0"}',
    '{"fn":"f","bb":"b0","op":"a","uses":[],"pp":"f:b0:ix"}',
    '{"fn":"f","bb":"b0","op":"a","uses":["x"],"use_tys":[7]}',
    '{"fn":"f","bb":"b0","op":"a","uses":[],"pp":5}',
]


@pytest.mark.parametrize("bad", BAD_LINES)
def test_malformed_lines_raise_and_skip_like_reference(bad):
    ok = [rec(op="load", **{"def": "v0"}, uses=[]),
          rec(op="add", pp=None, **{"def": "v1"}, uses=["v0"])]
    lines = [ok[0], bad, ok[1]]
    err = assert_same_raise("ingest_trace", lines)
    assert isinstance(err, T.TraceFormatError) and err.lineno == 2
    g, st = assert_ingest_equal(lines, on_error="skip")
    assert st.skipped == 1 and st.records == 2


@pytest.mark.parametrize("lines,cfg", [
    ([rec(pp="f:b0:i0", **{"def": "v0"}), rec(pp="f:b0:i5", **{"def": "v1"}),
      rec(pp="f:b0:i3", **{"def": "v2"}), rec(pp="f:b0:i6", **{"def": "v3"})],
     None),
    (LINE_SETS["self-loop-reentry"][:2]
     + [rec(bb="loop", pp="f:loop:i1", op="x", uses=[])], None),
    (LINE_SETS["self-loop-reentry"],
     ['{"kind":"block","fn":"f","bb":"loop","succs":["exit"]}']),
    ([rec(bb="b0", pp="f:b0:i0", **{"def": "v0"}),
      rec(bb="b2", pp="f:b2:i0", **{"def": "v1"})],
     ['{"kind":"block","fn":"f","bb":"b0","succs":["b1"]}',
      '{"kind":"block","fn":"f","bb":"b1","succs":["b0","b2"]}']),
], ids=["out-of-order-pp", "rewind-not-reentry", "no-self-edge",
        "not-a-cfg-edge"])
def test_ordering_and_cfg_violations_like_reference(lines, cfg):
    assert_same_raise("ingest_trace", lines, cfg=cfg)
    assert_ingest_equal(lines, cfg=cfg, on_error="skip")


def test_cfg_checks_pass_like_reference():
    cfg = ['{"kind":"block","fn":"f","bb":"loop","succs":["loop","exit"]}']
    assert_ingest_equal(LINE_SETS["self-loop-reentry"], cfg=cfg)
    cfg = ['{"kind":"block","fn":"f","bb":"b0","succs":["b1"]}',
           '{"kind":"block","fn":"f","bb":"b1","succs":["b0","b2"]}']
    assert_ingest_equal(LINE_SETS["block-change-resets-pp"], cfg=cfg)


@pytest.mark.parametrize("cfg_lines", [
    ['{"kind":"block","fn":"f","bb":"b0","succs":[]}',
     '{"kind":"edge","fn":"f","to":"b1"}'],
    ['{"kind":"path","bbs":["b0"]}'],
    ["not json"],
    ["[1, 2]"],
])
def test_load_cfg_errors_like_reference(cfg_lines):
    assert_same_raise("load_cfg", cfg_lines)


def test_bad_on_error_and_weight_model_like_reference():
    assert_same_raise("ingest_trace", LINE_SETS["basic"], on_error="bogus")
    assert_same_raise("ingest_trace", LINE_SETS["basic"],
                      weight_model="bogus")


# ---------------------------------------------------------------------- #
# replay, chunking, sessions
# ---------------------------------------------------------------------- #
STATIC = [
    rec(bb="entry", pp="f:entry:i0", op="load", **{"def": "v0"},
        uses=["arg0"], use_tys=["ptr"]),
    rec(bb="loop", pp="f:loop:i0", op="add", **{"def": "v1"},
        uses=["v0", "v1"], use_tys=["i32", "i32"]),
    rec(bb="exit", pp="f:exit:i0", op="ret", uses=["v1"], use_tys=["i32"]),
]
CFG_LINES = [
    '{"kind":"block","fn":"f","bb":"entry","succs":["loop"]}',
    '{"kind":"block","fn":"f","bb":"loop","succs":["loop","exit"]}',
    '{"kind":"path","fn":"f","path_id":0,'
    '"bbs":["entry","loop","loop","loop","exit"]}',
]


@pytest.mark.parametrize("kw", [{}, {"repeat": 3}, {"fn": "other"},
                                {"path_ids": [99]}, {"path_ids": [0]},
                                {"weight_model": "memop-latency"}])
def test_replay_matches_reference(kw):
    (g, st), (g_ref, st_ref) = both("replay_trace", STATIC, CFG_LINES,
                                    keep_labels=True, **kw)
    assert_same_graph(g, g_ref)
    assert st.summary() == st_ref.summary()


@pytest.mark.parametrize("chunk", [1, 64, 1023, 1 << 30])
def test_chunking_never_changes_the_graph(chunk):
    lines = list(T.iter_synthetic_trace(3000, seed=7))
    g, st = assert_ingest_equal(lines, chunk_edges=chunk)
    assert st.peak_chunk_edges <= chunk + 8


def test_session_windows_equal_one_parse():
    from repro.trace.ingest import TraceSession as RefSession
    from repro_torch.trace.ingest import TraceSession
    lines = list(T.iter_synthetic_trace(4000, seed=3))
    windows = [lines[:1000], lines[1000:1001], lines[1001:2500],
               [], lines[2500:]]
    port, ref = TraceSession(chunk_edges=500), RefSession(chunk_edges=500)
    for win in windows:
        a, b = port.feed(win), ref.feed(win)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert port.n == ref.n
    assert port.windows == ref.windows == len(windows)
    assert_same_graph(port.graph(), ref.graph())
    assert_same_graph(port.graph(), T.ingest_trace(lines), labels=False)


# ---------------------------------------------------------------------- #
# synthetic traces: byte-identical, and the same graph through every
# engine and both weight models
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n,seed,kw", [
    (0, 0, {}), (1, 3, {}), (2000, 1, {}), (5000, 7, {"n_fns": 1}),
    (7000, 11, {"n_fns": 9, "bbs_per_fn": 3, "block_len": 5}),
    (3000, 2, {"max_uses": 2}), (3000, 5, {"max_uses": 5})])
def test_synthetic_trace_is_byte_identical(n, seed, kw):
    a = list(T.iter_synthetic_trace(n, seed=seed, **kw))
    b = list(R.iter_synthetic_trace(n, seed=seed, **kw))
    assert a == b and len(a) == n


def test_synthesize_trace_files_are_byte_identical(tmp_path):
    a, b = str(tmp_path / "a.ndjson"), str(tmp_path / "b.ndjson")
    assert T.synthesize_trace(a, 20_000, seed=0, n_fns=4) == 20_000
    assert R.synthesize_trace(b, 20_000, seed=0, n_fns=4) == 20_000
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("model", ["bytes", "memop-latency"])
@pytest.mark.parametrize("lines,seed", [(2500, 3), (20_000, 0)])
def test_synthetic_trace_stream_engine(tmp_path, scanner_off, lines, seed,
                                       model):
    path = write_synth(tmp_path, lines, seed)
    g, st = assert_ingest_equal(path, weight_model=model, keep_labels=True)
    assert st.engine == "stream"


@pytest.mark.parametrize("model", ["bytes", "memop-latency"])
@pytest.mark.parametrize("lines,seed", [(2500, 3), (20_000, 0)])
def test_synthetic_trace_forced_scanner(tmp_path, scanner_on, lines, seed,
                                        model):
    path = write_synth(tmp_path, lines, seed)
    g, st = assert_ingest_equal(path, weight_model=model, keep_labels=True)
    assert st.engine == "scan"


def test_scanner_equals_stream_at_100k_lines(tmp_path, monkeypatch):
    """The one 100,000-line case: the port's scanner (forced on) against
    its own streaming engine and the reference's graph."""
    path = write_synth(tmp_path, 100_000, 0)
    monkeypatch.setenv(T.SCANNER_ENV, "1")
    g_scan, st_scan = T.ingest_trace_with_stats(path)
    g_ref, st_ref = R.ingest_trace_with_stats(path)
    monkeypatch.setenv(T.SCANNER_ENV, "0")
    g_seq, st_seq = T.ingest_trace_with_stats(path)
    assert (st_scan.engine, st_ref.engine, st_seq.engine) == (
        "scan", "scan", "stream")
    assert_same_graph(g_scan, g_ref)
    assert_same_graph(g_seq, g_ref)
    sa, sb = st_scan.summary(), st_seq.summary()
    for k in ("engine", "peak_chunk_edges"):
        sa.pop(k), sb.pop(k)
    assert sa == sb


@pytest.mark.parametrize("model", ["bytes", "memop-latency"])
def test_synthetic_trace_rtb_round_trip(tmp_path, model):
    path = write_synth(tmp_path, 5000, 1)
    g, st = T.ingest_trace_with_stats(path, weight_model=model,
                                      keep_labels=True)
    rtb = str(tmp_path / "t.rtb")
    assert T.write_trace_bin(rtb, g, st, chunk_edges=700) > 1
    (gb, sb), (gr, sr) = both("ingest_trace_with_stats", rtb,
                              keep_labels=True)
    assert sb.engine == sr.engine == "binary"
    assert sb.summary() == sr.summary()
    assert_same_graph(gb, g)
    assert_same_graph(gr, g)


# ---------------------------------------------------------------------- #
# committed example traces
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("scanner", ["0", "1"])
@pytest.mark.parametrize("fixture", ["toy_loop.ndjson", "mlp_jaxpr.ndjson"])
def test_committed_example_traces(fixture, scanner, monkeypatch):
    monkeypatch.setenv(T.SCANNER_ENV, scanner)
    g, st = assert_ingest_equal(os.path.join(TRACES, fixture),
                                keep_labels=True)
    assert st.engine == ("scan" if scanner == "1" else "stream")


def test_toy_loop_cfg_and_replay():
    trace = os.path.join(TRACES, "toy_loop.ndjson")
    cfg = os.path.join(TRACES, "toy_loop.cfg.ndjson")
    g, st = assert_ingest_equal(trace, cfg=cfg, keep_labels=True)
    assert st.records == 10 and st.cfg_violations == 0
    (g2, st2), (g2r, st2r) = both("replay_trace", trace, cfg,
                                  keep_labels=True)
    assert st2.records == 31 and st2.summary() == st2r.summary()
    assert_same_graph(g2, g2r)
    c, c_ref = both("load_cfg", cfg)
    assert c.succs == c_ref.succs and c.paths == c_ref.paths


# ---------------------------------------------------------------------- #
# compressed sources
# ---------------------------------------------------------------------- #
def test_gzip_source(tmp_path, monkeypatch):
    text = "\n".join(T.iter_synthetic_trace(800, seed=5)) + "\n"
    gz = tmp_path / "t.ndjson.gz"
    with gzip.open(gz, "wt", encoding="utf-8") as f:
        f.write(text)
    g, st = assert_ingest_equal(str(gz))
    assert st.engine == "scan"
    monkeypatch.setenv(T.SCANNER_ENV, "0")
    g2, st2 = assert_ingest_equal(str(gz))
    assert st2.engine == "stream"
    assert_same_graph(g, g2)


def test_zstd_source(tmp_path, monkeypatch):
    zstandard = pytest.importorskip(
        "zstandard", reason="zstd line source needs the zstandard package")
    text = "\n".join(T.iter_synthetic_trace(800, seed=5)) + "\n"
    zst = tmp_path / "t.ndjson.zst"
    zst.write_bytes(zstandard.ZstdCompressor().compress(text.encode()))
    g, st = assert_ingest_equal(str(zst))
    assert st.engine == "scan"
    monkeypatch.setenv(T.SCANNER_ENV, "0")
    assert_ingest_equal(str(zst))
    rtb = str(tmp_path / "t.rtb.zst")
    T.write_trace_bin(rtb, g, st)
    assert_same_graph(R.read_trace_bin(rtb)[0], g)


def test_zstd_missing_dependency_error(tmp_path, monkeypatch):
    """Without `zstandard` a .zst path fails with the reference's
    actionable message (the import is blocked for both packages)."""
    monkeypatch.setitem(sys.modules, "zstandard", None)
    monkeypatch.setenv(T.SCANNER_ENV, "0")
    path = tmp_path / "t.ndjson.zst"
    path.write_bytes(b"")
    err = assert_same_raise("ingest_trace_with_stats", str(path))
    assert isinstance(err, ImportError) and "zstandard" in str(err)


# ---------------------------------------------------------------------- #
# scanner policy
# ---------------------------------------------------------------------- #
def test_scanner_env_and_size_budget(tmp_path, monkeypatch):
    path = write_synth(tmp_path, 400, 11)
    size_mb = os.path.getsize(path) / (1 << 20)
    for env, budget, engine in [
            ("0", None, "stream"), ("off", None, "stream"),
            ("FALSE", None, "stream"), ("no", None, "stream"),
            ("1", size_mb / 2, "scan"), ("force", size_mb / 2, "scan"),
            ("", size_mb * 2, "scan"), ("", size_mb / 2, "stream"),
            ("", "not-a-number", "scan")]:
        monkeypatch.setenv(T.SCANNER_ENV, env)
        if budget is None:
            monkeypatch.delenv(T.SCAN_MAX_MB_ENV, raising=False)
        else:
            monkeypatch.setenv(T.SCAN_MAX_MB_ENV, str(budget))
        assert T.scanner_mode() == R.scanner_mode()
        assert T.scanner_enabled() == R.scanner_enabled()
        g, st = assert_ingest_equal(path)
        assert st.engine == engine, (env, budget)
        if engine == "stream" and T.scanner_mode() == "off":
            assert T.try_scan_ingest(path) is None


def test_scanner_fallback_cases(tmp_path):
    path = write_synth(tmp_path, 300, 9)
    with open(path) as f:
        lines = f.read().splitlines()
    assert assert_ingest_equal(lines)[1].engine == "stream"
    assert assert_ingest_equal(path, on_error="skip")[1].engine == "stream"
    g, st = T.ingest_trace_with_stats(path, weight_model=lambda o, t, b: 1.0)
    assert st.engine == "stream" and (g.w == 1.0).all()
    pretty = tmp_path / "pretty.ndjson"
    pretty.write_text('{"fn": "f", "bb": "b0", "op": "add", '
                      '"def": "v0", "uses": []}\n')
    g, st = assert_ingest_equal(str(pretty))
    assert st.engine == "stream" and g.n == 1
    bad = tmp_path / "bad.ndjson"
    bad.write_text(lines[0] + "\n" + '{"fn":"f","bb":"b0","uses":[]}\n')
    assert_same_raise("ingest_trace_with_stats", str(bad))


def test_scanner_fallback_events_are_the_reference_ones(tmp_path):
    from repro import obs as robs
    from repro_torch import obs
    path = write_synth(tmp_path, 300, 9)
    with obs.scoped(merge=False) as col:
        T.ingest_trace_with_stats(path, on_error="skip")
    with robs.scoped(merge=False) as rcol:
        R.ingest_trace_with_stats(path, on_error="skip")
    got = [(e["name"], e.get("args")) for e in col.events if e["ph"] == "i"]
    want = [(e["name"], e.get("args")) for e in rcol.events
            if e["ph"] == "i"]
    assert got == want == [("trace.scan_fallback",
                            {"reason": "cfg_or_on_error"})]


# ---------------------------------------------------------------------- #
# .rtb: both directions, and malformed containers
# ---------------------------------------------------------------------- #
def test_rtb_moves_both_ways(tmp_path):
    path = write_synth(tmp_path, 3000, 2)
    g, st = T.ingest_trace_with_stats(path, keep_labels=True)
    for writer, reader in ((T, R), (R, T)):
        rtb = str(tmp_path / f"{writer.__name__}.rtb.gz")
        writer.write_trace_bin(rtb, g, st, chunk_edges=999)
        assert reader.read_trace_bin_header(rtb) == \
            writer.read_trace_bin_header(rtb)
        gr, sr = reader.read_trace_bin(rtb, keep_labels=True)
        assert_same_graph(gr, g)
        assert sr.summary() == writer.read_trace_bin(rtb)[1].summary()
        ca = list(reader.iter_trace_bin_chunks(rtb))
        cb = list(writer.iter_trace_bin_chunks(rtb))
        assert len(ca) == len(cb) == -(-g.num_edges // 999) > 1
        for x, y in zip(ca, cb):
            for u, v in zip(x[1:], y[1:]):
                np.testing.assert_array_equal(u, v)


def test_rtb_empty_graph(tmp_path):
    g0 = TC.IRGraph(n=0, src=[], dst=[], w=[], name="empty")
    rtb = tmp_path / "e.rtb"
    assert T.write_trace_bin(rtb, g0) == 0
    (g, st), (gr, sr) = both("read_trace_bin", rtb)
    assert_same_graph(g, gr)
    assert st.summary() == sr.summary()
    (hdr, s, d, w), = T.iter_trace_bin_chunks(rtb)
    assert hdr["edges"] == 0 and len(s) == len(d) == len(w) == 0


def test_binary_path_predicate():
    for p in ("t.rtb", "t.rtb.gz", "x.rtb.zst", "x.rtb.zstd", "x.ndjson.gz",
              "x.npz", "x.ndjson", 123):
        assert T.is_binary_trace_path(p) == R.is_binary_trace_path(p)


def _make_rtb(tmp_path, labels=False):
    g = TC.IRGraph(n=3, src=[0, 1, 2, 0], dst=[1, 2, 0, 2],
                   w=[1.0, 2.5, 3.0, 0.5],
                   node_labels=["a", "b", "a"] if labels else None)
    p = tmp_path / "m.rtb"
    T.write_trace_bin(p, g, chunk_edges=3)
    return p, p.read_bytes()


def _rewrite_header(raw: bytes, mutate) -> bytes:
    version, hlen = struct.unpack("<HI", raw[8:14])
    header = json.loads(raw[14:14 + hlen])
    mutate(header)
    hdr = json.dumps(header, separators=(",", ":")).encode()
    return raw[:8] + struct.pack("<HI", version, len(hdr)) + hdr \
        + raw[14 + hlen:]


def _set(key, value):
    def mutate(h):
        h[key] = value
    return mutate


def _corruptions():
    def lie(h):
        h["chunks"][0]["edges"] += 1

    def dtype(h):
        h["dtypes"]["w"] = "<f4"

    def drop(h):
        del h["edges"]

    def bad_json(raw):
        _, hlen = struct.unpack("<HI", raw[8:14])
        return raw[:14] + b"x" * hlen + raw[14 + hlen:]
    return {
        "bad-magic": lambda raw: b"NOTMAGIC" + raw[8:],
        "empty-file": lambda raw: b"",
        "version": lambda raw: raw[:8] + struct.pack(
            "<H", T.BINARY_VERSION + 1) + raw[10:],
        "truncated-chunk": lambda raw: raw[:-5],
        "truncated-header": lambda raw: raw[:20],
        "dtype-mismatch": lambda raw: _rewrite_header(raw, dtype),
        "chunk-table": lambda raw: _rewrite_header(raw, lie),
        "missing-field": lambda raw: _rewrite_header(raw, drop),
        "header-not-json": bad_json,
        "header-not-object": lambda raw: raw[:8] + struct.pack(
            "<HI", 1, 2) + b"[]" + raw[14 + struct.unpack(
                "<HI", raw[8:14])[1]:],
        "endpoint": lambda raw: _rewrite_header(raw, _set("n", 1)),
    }


@pytest.mark.parametrize("case", sorted(_corruptions()))
def test_malformed_rtb_raises_like_reference(tmp_path, case):
    p, raw = _make_rtb(tmp_path)
    p.write_bytes(_corruptions()[case](raw))
    err = assert_same_raise("read_trace_bin", p)
    assert isinstance(err, T.BinaryFormatError)
    if case in ("bad-magic", "empty-file", "version", "truncated-header",
                "missing-field", "dtype-mismatch", "chunk-table"):
        assert_same_raise("read_trace_bin_header", p)


def test_malformed_rtb_label_id(tmp_path):
    p, raw = _make_rtb(tmp_path, labels=True)
    p.write_bytes(raw[:-4] + struct.pack("<i", 999))
    err = assert_same_raise("read_trace_bin", p, keep_labels=True)
    assert "label id 999 outside" in str(err)


def test_rtb_rejects_cfg_like_reference(tmp_path):
    p, _ = _make_rtb(tmp_path)
    cfg = ['{"kind":"block","fn":"f","bb":"b0","succs":[]}']
    assert_same_raise("ingest_trace_with_stats", str(p), cfg=cfg)


def test_binary_round_trip_property(tmp_path):
    """The reference's hypothesis round trip, with its settings; each
    container the port writes is also read by the reference."""
    pytest.importorskip(
        "hypothesis", reason="property test needs the hypothesis package")
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    @settings(max_examples=40, deadline=None,
              suppress_health_check=[HealthCheck.function_scoped_fixture])
    @given(data=st.data())
    def round_trip(data):
        n = data.draw(st.integers(min_value=1, max_value=50))
        m = data.draw(st.integers(min_value=0, max_value=200))
        ids = st.integers(min_value=0, max_value=n - 1)
        src = data.draw(st.lists(ids, min_size=m, max_size=m))
        dst = data.draw(st.lists(ids, min_size=m, max_size=m))
        w = data.draw(st.lists(
            st.floats(allow_nan=False, allow_infinity=False, width=64),
            min_size=m, max_size=m))
        labels = data.draw(st.one_of(st.none(), st.lists(
            st.text(max_size=6), min_size=n, max_size=n)))
        chunk = data.draw(st.integers(min_value=1, max_value=64))
        g0 = TC.IRGraph(n=n, src=src, dst=dst, w=w, name="prop",
                        node_labels=list(labels) if labels else None)
        p = tmp_path / "prop.rtb"
        T.write_trace_bin(p, g0, chunk_edges=chunk)
        for reader in (T, R):
            g1, st1 = reader.read_trace_bin(p, keep_labels=True)
            assert st1.engine == "binary"
            assert g1.n == n and g1.name == "prop"
            assert np.array_equal(g1.src, g0.src)
            assert np.array_equal(g1.dst, g0.dst)
            assert np.array_equal(g1.w, g0.w)
            assert g1.node_labels == (list(labels) if labels else None)

    round_trip()


# ---------------------------------------------------------------------- #
# schema helpers and weight models
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("ty", ["i1", "i32", "i64", "i7", "double", "float",
                                "half", "ptr", "i8*", "<4 x float>",
                                "[16 x i8]", "[2 x <4 x i32>]",
                                "%struct.opaque", "void", " i16 ", None])
def test_type_bytes_matches_reference(ty):
    assert T.type_bytes(ty) == R.type_bytes(ty)
    assert T.type_bytes(ty, default=3.0) == R.type_bytes(ty, default=3.0)


def test_schema_constants_and_encode_bytes_type():
    from repro.trace import schema as rs
    from repro_torch.trace import schema as ts
    assert ts.SCHEMA_VERSION == rs.SCHEMA_VERSION == 0
    assert ts.CFG_KINDS == rs.CFG_KINDS
    for nb in (0, 1, 1.4, 2, 16, 4096):
        assert ts.encode_bytes_type(nb) == rs.encode_bytes_type(nb)
        assert T.type_bytes(ts.encode_bytes_type(nb)) == R.type_bytes(
            rs.encode_bytes_type(nb))
    assert str(ts.TraceFormatError(7, "x")) == str(rs.TraceFormatError(7, "x"))


def test_weight_models_match_reference():
    from repro.trace import weights as rw
    from repro_torch.trace import weights as tw
    assert sorted(T.WEIGHT_MODELS) == sorted(R.WEIGHT_MODELS)
    assert tw.MEMOP_LATENCY_CYCLES == rw.MEMOP_LATENCY_CYCLES
    for name in T.WEIGHT_MODELS:
        a, b = T.resolve_weight_model(name), R.resolve_weight_model(name)
        for op in ("load", "store", "add", "call", "getelementptr"):
            for ty in (None, "i32", "[16 x i8]", "i1"):
                for pb in (None, 0.5, 2.0, 16.0):
                    assert a(op, ty, pb) == b(op, ty, pb)
    assert_same_raise("resolve_weight_model", "nope")
    fn = T.resolve_weight_model(lambda o, t, b: 2.0)
    assert fn("x", None, None) == 2.0


def test_register_weight_model():
    from repro_torch.trace import weights as tw
    try:
        T.register_weight_model("unit", lambda o, t, b: 1.0)
        g = T.ingest_trace(LINE_SETS["basic"], weight_model="unit")
        assert (g.w == 1.0).all() and g.num_edges == 5
    finally:
        tw.WEIGHT_MODELS.pop("unit", None)


# ---------------------------------------------------------------------- #
# the pipeline takes trace paths, and the CLI
# ---------------------------------------------------------------------- #
def test_pipeline_and_planner_take_every_path(tmp_path):
    path = write_synth(tmp_path, 1500, 2)
    g = T.load_graph(path)
    rtb, npz = str(tmp_path / "t.rtb"), str(tmp_path / "t.npz")
    T.write_trace_bin(rtb, g)
    g.save_npz(npz)
    gz = str(tmp_path / "t.ndjson.gz")
    with open(path, "rb") as f, gzip.open(gz, "wb") as z:
        z.write(f.read())
    ref = RC.run_pipeline(path, 8, "wb_libra", backend="fast")
    for source in (path, rtb, npz, gz):
        assert_same_graph(T.load_graph(source), R.load_graph(source),
                          labels=False)
        assert_same_graph(TC.coerce_graph(source), g, labels=False)
        part, mapping, rep = TC.run_pipeline(source, 8, "wb_libra",
                                             device="cpu")
        np.testing.assert_array_equal(part.assignment, ref[0].assignment)
        np.testing.assert_array_equal(mapping.core_of, ref[1].core_of)
        assert rep.exec_time == ref[2].exec_time
        plan = TC.plan_graph(source, 8, device="cpu")
        assert plan.exec_time == rep.exec_time
        assert plan.summary() == ref_plan_graph(source, 8).summary()
    with pytest.raises(TypeError):
        TC.run_pipeline(123, 4, "wb_libra", device="cpu")


def test_cli_matches_reference(tmp_path, capsys):
    from repro.trace.__main__ import main as ref_cli
    port_trace, ref_trace = tmp_path / "p.ndjson", tmp_path / "r.ndjson"
    assert port_cli(["synth", str(port_trace), "--lines", "400"]) == 0
    assert ref_cli(["synth", str(ref_trace), "--lines", "400"]) == 0
    capsys.readouterr()
    assert port_trace.read_bytes() == ref_trace.read_bytes()
    for args in (["inspect", str(port_trace)],
                 ["inspect", os.path.join(TRACES, "toy_loop.ndjson"),
                  "--cfg", os.path.join(TRACES, "toy_loop.cfg.ndjson"),
                  "--replay", "--repeat", "2"],
                 ["inspect", str(port_trace), "--weight-model",
                  "memop-latency", "--chunk-edges", "100"]):
        assert port_cli(args) == 0
        port_out = json.loads(capsys.readouterr().out)
        assert ref_cli(args) == 0
        assert port_out == json.loads(capsys.readouterr().out)
    for suffix in (".rtb", ".npz"):
        out = str(tmp_path / f"t{suffix}")
        assert port_cli(["convert", str(port_trace), out]) == 0
        assert_same_graph(R.load_graph(out), T.ingest_trace(str(port_trace)),
                          labels=False)
    capsys.readouterr()
    prof = str(tmp_path / "prof.json")
    for source in (str(port_trace), str(tmp_path / "t.rtb")):
        assert port_cli(["partition", source, "-p", "4", "--device", "cpu",
                         "--profile", prof]) == 0
        port_plan = json.loads(capsys.readouterr().out)
        assert ref_cli(["partition", source, "-p", "4"]) == 0
        assert port_plan == json.loads(capsys.readouterr().out)
    from repro_torch.obs.export import events_from_chrome, load_profile
    names = {e["name"] for e in events_from_chrome(load_profile(prof))}
    assert {"trace.ingest", "plan.cut", "plan.map", "plan.simulate"} <= names


def test_cli_partition_asks_for_the_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    path = write_synth(tmp_path, 200, 1)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_cli(["partition", path, "-p", "4"])
    assert port_cli(["partition", path, "-p", "4", "--backend", "fast"]) == 0


def test_cli_replay_needs_cfg(tmp_path):
    path = write_synth(tmp_path, 50, 1)
    with pytest.raises(SystemExit, match="--replay needs --cfg"):
        port_cli(["inspect", path, "--replay"])


def test_cli_runs_as_a_module(tmp_path):
    import subprocess
    out = str(tmp_path / "m.ndjson")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.trace", "synth",
                        out, "--lines", "300", "--seed", "4"],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert list(R.iter_synthetic_trace(300, seed=4)) == \
        open(out).read().splitlines()
