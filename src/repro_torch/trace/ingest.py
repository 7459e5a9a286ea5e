"""Streaming NDJSON trace -> IRGraph (the paper's §3 graph constructor).

The ingester reconstructs the weighted dynamic dependence graph from a
TRACE_SCHEMA v0 stream while holding only O(chunk) Python state:

  * one vertex per instruction record, ids assigned in stream order —
    trace order *is* program order, which the streaming partitioner's
    greedy quality depends on (DESIGN §2 edge-order finding);
  * SSA value ids are interned through **rolling def-tables** (one plain
    dict per function: id -> (vertex, def bytes)); a re-executed block
    overwrites its defs, so loop-carried uses bind to the previous
    iteration, and a use of a never-defined id materialises a live-in
    vertex;
  * every use of a `const:*` id materialises a fresh vertex (constants
    are per-use in an SSA trace, like jaxpr literals);
  * edges are buffered in flat Python lists only up to `chunk_edges`,
    then frozen into numpy batches and concatenated once at the end —
    million-line traces never hold per-edge Python objects.

`replay_trace` expands a *static* per-block listing into a dynamic trace
by walking CFG `path` records (basic-block execution order), which is
how the paper's instrumentation-side traces are serialized compactly.

The record loop is deliberately hand-tuned (local bindings, a
``"".join`` type probe, a cached program-point prefix): `json.loads` is
the unavoidable floor, and everything else is kept within its budget so
million-line traces ingest in seconds — see the `trace_ingest` bench.
"""
from __future__ import annotations

import dataclasses
import json
import os
from time import perf_counter

import numpy as np

from .. import obs
from ..core.graph import IRGraph
from .schema import CFG_KINDS, TraceFormatError, type_bytes
from .weights import resolve_weight_model

try:                                    # optional accelerator, never required
    from orjson import loads as _json_loads    # pragma: no cover
except ImportError:
    _json_loads = json.loads

__all__ = ["TraceStats", "CFG", "TraceSession", "ingest_trace",
           "ingest_trace_with_stats", "replay_trace", "load_cfg",
           "load_graph"]

DEFAULT_CHUNK_EDGES = 1 << 16


@dataclasses.dataclass
class TraceStats:
    """Counters from one ingestion pass (CLI `inspect`, tests, benches)."""

    lines: int = 0              # lines read (blank lines included)
    records: int = 0            # instruction records turned into vertices
    cfg_records: int = 0        # kind-tagged records (skipped or routed)
    skipped: int = 0            # malformed records dropped (on_error=skip)
    const_uses: int = 0         # fresh vertices from const:* uses
    livein_uses: int = 0        # fresh vertices from never-defined ids
    void_defs: int = 0          # instructions with def: null
    cfg_violations: int = 0     # bb transitions absent from the CFG
    peak_chunk_edges: int = 0   # high-water mark of the Python edge buffer
    functions: int = 0
    blocks: int = 0
    # which ingestion engine produced the graph: "stream" (the Python
    # record loop below), "scan" (the vectorized scanner, trace.scan),
    # or "binary" (a .rtb container, trace.binfmt)
    engine: str = "stream"

    def summary(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CFG:
    """Static control-flow side-channel (CFG_SCHEMA v0 block/edge/path)."""

    succs: dict                 # (fn, bb) -> set of successor bb labels
    paths: list                 # dicts: {fn, path_id, bbs}

    @property
    def has_blocks(self) -> bool:
        return bool(self.succs)


def _open_lines(source):
    """(line iterable, closer) for a path, file-like, or iterable of lines.

    A `.gz` path is decompressed transparently (instrumentation runs
    usually gzip their NDJSON streams on the fly; text-mode `gzip.open`
    streams line-by-line, so the O(chunk) memory bound still holds), and
    a `.zst`/`.zstd` path likewise through the optional `zstandard`
    package (`pip install repro[zstd]`) — zstd is what long-running
    instrumentation favours for its compression speed.  Lines are passed
    through raw — `json.loads` tolerates surrounding whitespace, and
    blank lines are dropped in `parse_line`'s error path, so the hot
    loop never strips."""
    if isinstance(source, (str, os.PathLike)):
        path = os.fspath(source)
        if path.endswith(".gz"):
            import gzip
            f = gzip.open(source, "rt", encoding="utf-8")
        elif path.endswith((".zst", ".zstd")):
            f = _open_zstd(source)
        else:
            f = open(source, "r", encoding="utf-8")
        return f, f.close
    return source, (lambda: None)


def _open_zstd(source):
    """Text-mode streaming reader over a zstd-compressed path.

    Soft dependency: `zstandard` is only imported when a `.zst` path is
    actually opened, so the core package stays dependency-free."""
    try:
        import zstandard
    except ImportError as e:                # pragma: no cover - soft dep
        raise ImportError(
            "reading .zst/.zstd traces needs the optional 'zstandard' "
            "package (pip install zstandard, or repro[zstd])") from e
    import io
    fh = open(source, "rb")
    reader = zstandard.ZstdDecompressor().stream_reader(fh)
    # closefd semantics: closing the text wrapper closes the stream
    # reader, which closes the underlying file handle
    return io.TextIOWrapper(reader, encoding="utf-8")


def _source_name(source, name):
    if name is not None:
        return name
    if isinstance(source, (str, os.PathLike)):
        base = os.path.basename(os.fspath(source))
        return base.rsplit(".", 1)[0] if "." in base else base
    return "trace"


# ---------------------------------------------------------------------- #
# the streaming builder
# ---------------------------------------------------------------------- #
class _StreamBuilder:
    def __init__(self, weight_fn, chunk_edges: int, keep_labels: bool,
                 cfg: "CFG | None", on_error: str):
        if on_error not in ("raise", "skip"):
            raise ValueError("on_error must be 'raise' or 'skip'")
        self.weight_fn = weight_fn
        self.chunk_edges = max(int(chunk_edges), 1)
        self.keep_labels = keep_labels
        self.cfg = cfg
        self.on_error = on_error

        # rolling def-tables, one per function (SSA ids are stable only
        # within a function): id -> (vertex, def bytes)
        self._defs_by_fn: dict = {}
        self._cur_fn = None
        self.defs: dict = {}            # the current function's table
        self.n = 0
        self.labels: list = [] if keep_labels else None
        self._batches: list = []
        self._src: list = []
        self._dst: list = []
        self._w: list = []
        # current (fn, bb, pp-index) run for ordering validation;
        # _run_first is the run's starting index (block re-entry detector)
        self._run = (None, None, -1)
        self._run_first = -1
        self._run_prefix = ""
        self._bbs: set = set()
        # counters (folded into TraceStats at finalize)
        self._lines = 0
        self._records = 0
        self._cfg_records = 0
        self._skipped = 0
        self._const_uses = 0
        self._livein_uses = 0
        self._void_defs = 0
        self._cfg_violations = 0
        self._peak = 0

    # -- node/edge plumbing -------------------------------------------- #
    def _flush(self) -> None:
        buffered = len(self._src)
        if buffered > self._peak:
            self._peak = buffered
        if buffered:
            self._batches.append((np.asarray(self._src, np.int32),
                                  np.asarray(self._dst, np.int32),
                                  np.asarray(self._w, np.float64)))
            self._src, self._dst, self._w = [], [], []

    def new_block_run(self) -> None:
        """Reset pp-ordering state at a replayed block boundary."""
        self._run = (None, None, -1)
        self._run_first = -1

    def _fail(self, lineno: int, msg: str) -> bool:
        if self.on_error == "raise":
            raise TraceFormatError(lineno, msg)
        self._skipped += 1
        return False

    # -- record processing --------------------------------------------- #
    def parse_line(self, lineno: int, line: str) -> "dict | None":
        """json-decode one line; returns the record dict, or None when it
        was blank/malformed/CFG and consumed (counted) instead."""
        self._lines += 1
        try:
            rec = _json_loads(line)
        except ValueError:
            if line.strip():
                self._fail(lineno, f"not valid JSON: {line.strip()[:60]!r}")
            return None                 # blank line
        if type(rec) is not dict:
            self._fail(lineno, "record is not a JSON object")
            return None
        kind = rec.get("kind")
        if kind is not None:
            if kind in CFG_KINDS:
                self._cfg_records += 1
                return None             # CFG side-channel, not an instruction
            self._fail(lineno, f"unknown record kind {kind!r}")
            return None
        return rec

    def add_record(self, lineno: int, rec: dict) -> bool:
        """Validate + apply one instruction record (atomically: a record
        rejected under on_error='skip' leaves no vertices, edges, or
        def-table entries behind).

        The validation/ordering prologue and the def registration are
        shared with the JAX package's sharded parser (`dist`, ROADMAP.md
        queue 1 item 7), which subclasses this builder and overrides only
        `_add_use_edges`, keeping the dist-vs-sequential equality
        contract mechanical rather than a matter of two hand-synced
        copies of this hot loop.
        """
        op = rec.get("op")
        if type(op) is not str:
            return self._fail(lineno, "missing/non-string 'op'")
        uses = rec.get("uses")
        if uses is None:
            uses = ()
        elif type(uses) is not list:
            return self._fail(lineno, "'uses' must be a list of value ids")
        else:
            try:                        # C-speed all-strings probe
                "".join(uses)
            except TypeError:
                return self._fail(lineno,
                                  "'uses' must be a list of value ids")
        def_id = rec.get("def")
        if def_id is not None and type(def_id) is not str:
            return self._fail(lineno, "'def' must be a value id or null")
        use_tys = rec.get("use_tys")
        if use_tys is not None:
            if type(use_tys) is not list or len(use_tys) != len(uses):
                return self._fail(lineno, "'use_tys' not parallel to 'uses'")
            try:                        # elements: type strings (or null)
                "".join(t for t in use_tys if t is not None)
            except TypeError:
                return self._fail(lineno,
                                  "'use_tys' must be type strings or null")
        fn = rec.get("fn", "?")
        bb = rec.get("bb", "?")

        # program-point ordering: inside one contiguous (fn, bb) run the
        # instruction index must strictly increase; block changes reset
        # it, and a rewind to the run's *first* index is block re-entry
        # (a self-looping block executed back-to-back), not disorder
        run_fn, run_bb, run_idx = self._run
        same_run = fn == run_fn and bb == run_bb
        pp = rec.get("pp")
        idx = None
        reentry = False
        if pp is not None:
            if type(pp) is not str:
                return self._fail(lineno, "'pp' must be a string")
            prefix = self._run_prefix if same_run else f"{fn}:{bb}:i"
            tail = pp[len(prefix):]
            if not pp.startswith(prefix) or not tail.isdigit():
                return self._fail(
                    lineno, f"pp {pp!r} does not match fn={fn!r} bb={bb!r}")
            idx = int(tail)
            if same_run and idx <= run_idx:
                if idx <= self._run_first:
                    reentry = True
                else:
                    return self._fail(
                        lineno,
                        f"out-of-order pp {pp!r} (last index {run_idx})")

        if not same_run or reentry:
            # CFG check: a same-function block transition (including a
            # self-loop re-entry) must follow a known successor edge
            # when block records were supplied
            cfg = self.cfg
            if cfg is not None and fn == run_fn and cfg.has_blocks:
                succs = cfg.succs.get((fn, run_bb))
                if succs is not None and bb not in succs:
                    self._cfg_violations += 1
                    return self._fail(
                        lineno, f"bb transition {run_bb!r} -> {bb!r} "
                                f"not a CFG edge in {fn!r}")

        # ---- validation done; mutate ---------------------------------- #
        if not same_run or reentry:
            self._run_prefix = f"{fn}:{bb}:i"
            self._bbs.add((fn, bb))
            self._run_first = idx if idx is not None else -1
            if fn != self._cur_fn:
                self._cur_fn = fn
                self.defs = self._defs_by_fn.setdefault(fn, {})
        if idx is None:
            idx = run_idx if same_run else -1
        self._run = (fn, bb, idx)
        self._records += 1

        nid = self.n
        n = nid + 1
        if self.labels is not None:
            self.labels.append(op)
        if uses:
            n = self._add_use_edges(nid, n, op, uses, use_tys)
        self.n = n
        if len(self._src) >= self.chunk_edges:
            self._flush()

        if def_id is None:
            self._void_defs += 1
        else:
            def_ty = rec.get("def_ty")
            self.defs[def_id] = (
                nid, type_bytes(def_ty) if type(def_ty) is str else None)
        return True

    def _add_use_edges(self, nid: int, n: int, op: str, uses,
                       use_tys) -> int:
        """Operand scan: intern each use, append its edge, return the
        next fresh vertex id.  The single override point of the sharded
        parser (`dist.parse._ShardBuilder` in the JAX package)."""
        defs_get = self.defs.get
        weight_fn = self.weight_fn
        src_append = self._src.append
        dst_append = self._dst.append
        w_append = self._w.append
        labels = self.labels
        for i, u in enumerate(uses):
            entry = defs_get(u)
            if entry is not None:
                pid, pbytes = entry
            elif u.startswith("const:"):
                pid, pbytes = n, None
                n += 1
                self._const_uses += 1
                if labels is not None:
                    labels.append("const")
            else:
                pid, pbytes = n, None
                n += 1
                self.defs[u] = (pid, None)
                self._livein_uses += 1
                if labels is not None:
                    labels.append(u)
            src_append(pid)
            dst_append(nid)
            w_append(weight_fn(
                op, use_tys[i] if use_tys is not None else None, pbytes))
        return n

    def finalize(self, name: str):
        self._flush()
        stats = TraceStats(
            lines=self._lines, records=self._records,
            cfg_records=self._cfg_records, skipped=self._skipped,
            const_uses=self._const_uses, livein_uses=self._livein_uses,
            void_defs=self._void_defs, cfg_violations=self._cfg_violations,
            peak_chunk_edges=self._peak,
            functions=len(self._defs_by_fn), blocks=len(self._bbs))
        if self._batches:
            src = np.concatenate([b[0] for b in self._batches])
            dst = np.concatenate([b[1] for b in self._batches])
            w = np.concatenate([b[2] for b in self._batches])
        else:
            src = np.zeros(0, np.int32)
            dst = np.zeros(0, np.int32)
            w = np.zeros(0, np.float64)
        g = IRGraph(n=self.n, src=src, dst=dst, w=w, name=name,
                    node_labels=self.labels)
        return g, stats


# ---------------------------------------------------------------------- #
# incremental multi-window sessions
# ---------------------------------------------------------------------- #
class TraceSession:
    """Incremental NDJSON parsing: feed trace *windows*, keep one graph.

    Each `feed(source)` call streams another window of the same logical
    trace through the rolling def-tables of a single `_StreamBuilder`,
    so vertex ids, loop-carried bindings, and edge order are exactly
    those of one uninterrupted parse of the concatenated windows —
    window boundaries never change the graph (the invariant the
    incremental repartitioner's bit-identity contract rests on).

    `feed` returns only the edges the window added (trace order), which
    is what the incremental planner (`serve.IncrementalPlanner`)
    streams into its resumable cut state; `graph()` materialises the
    full concatenated graph.
    """

    def __init__(self, *, weight_model="bytes",
                 chunk_edges: int = DEFAULT_CHUNK_EDGES,
                 on_error: str = "raise", keep_labels: bool = False):
        self._b = _StreamBuilder(resolve_weight_model(weight_model),
                                 chunk_edges, keep_labels, None, on_error)
        self._cursor = 0            # batches already handed out by feed()
        self.windows = 0

    @property
    def n(self) -> int:
        """Vertices discovered so far."""
        return self._b.n

    def feed(self, source) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Parse one window; returns its (src, dst, w) edge arrays."""
        b = self._b
        lines, close = _open_lines(source)
        try:
            parse_line, add_record = b.parse_line, b.add_record
            for lineno, line in enumerate(lines, start=1):
                rec = parse_line(lineno, line)
                if rec is not None:
                    add_record(lineno, rec)
        finally:
            close()
        b._flush()
        new = b._batches[self._cursor:]
        self._cursor = len(b._batches)
        self.windows += 1
        if not new:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(0, np.float64))
        if len(new) == 1:
            return new[0]
        return (np.concatenate([x[0] for x in new]),
                np.concatenate([x[1] for x in new]),
                np.concatenate([x[2] for x in new]))

    def graph(self, name: str = "session") -> IRGraph:
        """The concatenated graph over every window fed so far."""
        b = self._b
        b._flush()
        if b._batches:
            src = np.concatenate([x[0] for x in b._batches])
            dst = np.concatenate([x[1] for x in b._batches])
            w = np.concatenate([x[2] for x in b._batches])
        else:
            src = np.zeros(0, np.int32)
            dst = np.zeros(0, np.int32)
            w = np.zeros(0, np.float64)
        return IRGraph(n=b.n, src=src, dst=dst, w=w, name=name,
                       node_labels=b.labels)


# ---------------------------------------------------------------------- #
# public entry points
# ---------------------------------------------------------------------- #
def ingest_trace_with_stats(source, *, weight_model="bytes",
                            chunk_edges: int = DEFAULT_CHUNK_EDGES,
                            on_error: str = "raise",
                            cfg=None, name: str | None = None,
                            keep_labels: bool = False):
    """Stream a TRACE_SCHEMA v0 NDJSON source into an `IRGraph`.

    Args:
      source: path, file-like object, or iterable of NDJSON lines.
      weight_model: name in `WEIGHT_MODELS` ("bytes", "memop-latency") or
        a callable `(op, use_ty, producer_def_bytes) -> float`.
      chunk_edges: Python edge-buffer bound; memory per chunk is
        O(chunk_edges), independent of trace length.
      on_error: "raise" — abort with `TraceFormatError` (line number
        included); "skip" — drop the malformed record atomically and
        count it in `stats.skipped`.
      cfg: optional CFG (object or path) used to validate basic-block
        ordering against `block` records.
      keep_labels: retain per-vertex opcode labels (O(n) strings; off by
        default so huge traces stay array-only).

    Two transparent fast paths sit in front of the streaming
    interpreter (the JAX package's docs/trace-format.md documents both):

    * Binary `.rtb` paths (see `repro_torch.trace.binfmt`) load directly —
      `weight_model` is baked in at conversion time and ignored here,
      and `cfg` validation is not applicable (the trace is already a
      validated graph).
    * Eligible NDJSON path sources run through the vectorized scanner
      (`repro_torch.trace.scan`), bit-identical to the interpreter; anything
      outside its strict subset — or past the size budget where its
      batch passes stop beating the streaming interpreter
      (`REPRO_TRACE_SCAN_MAX_MB`, default 24) — falls back whole-file,
      so results and diagnostics never change.  `REPRO_TRACE_SCANNER=0`
      disables the scanner; `=1` forces it at any size.

    `stats.engine` records which engine produced the graph ("stream",
    "scan", or "binary").

    Returns:
      (IRGraph, TraceStats)
    """
    from .binfmt import is_binary_trace_path, read_trace_bin
    if is_binary_trace_path(source):
        if cfg is not None:
            raise ValueError(
                "cfg validation applies to NDJSON traces; a .rtb binary "
                "trace is already a validated graph")
        g, stats = read_trace_bin(source, keep_labels=keep_labels)
        if name is not None:
            g = dataclasses.replace(g, name=name)
        return g, stats
    if cfg is not None and not isinstance(cfg, CFG):
        cfg = load_cfg(cfg)
    from .scan import try_scan_ingest
    scanned = try_scan_ingest(source, weight_model=weight_model,
                              on_error=on_error, cfg=cfg, name=name,
                              keep_labels=keep_labels)
    if scanned is not None:
        return scanned
    b = _StreamBuilder(resolve_weight_model(weight_model), chunk_edges,
                       keep_labels, cfg, on_error)
    t0 = perf_counter()
    lines, close = _open_lines(source)
    try:
        parse_line, add_record = b.parse_line, b.add_record
        for lineno, line in enumerate(lines, start=1):
            rec = parse_line(lineno, line)
            if rec is not None:
                add_record(lineno, rec)
    finally:
        close()
    out = b.finalize(_source_name(source, name))
    if obs.enabled():
        t1 = perf_counter()
        m = int(out[0].num_edges)
        try:
            nbytes = (os.path.getsize(source)
                      if isinstance(source, (str, os.PathLike)) else 0)
        except OSError:
            nbytes = 0
        obs.complete("trace.ingest", t0, t1, engine="stream",
                     bytes=int(nbytes), edges=m,
                     edges_per_s=round(m / max(t1 - t0, 1e-9)))
    return out


def ingest_trace(source, **kw) -> IRGraph:
    """`ingest_trace_with_stats` without the stats (the common call)."""
    return ingest_trace_with_stats(source, **kw)[0]


def replay_trace(source, cfg, *, fn: str | None = None,
                 path_ids=None, repeat: int = 1,
                 weight_model="bytes",
                 chunk_edges: int = DEFAULT_CHUNK_EDGES,
                 on_error: str = "raise", name: str | None = None,
                 keep_labels: bool = False):
    """Expand a *static* per-block listing into a dynamic graph.

    The trace source holds each block's instructions once (static order);
    the CFG's `path` records give the executed basic-block sequence.
    Each visited block re-emits its instructions as fresh vertices and
    overwrites its defs in the rolling def-table, so loop-carried
    dependencies resolve to the previous iteration — the paper's dynamic
    trace reconstructed from (static listing, path) pairs.

    Args:
      fn: restrict to one function's paths (default: all).
      path_ids: iterable of path_id values to replay (default: all).
      repeat: replay each selected path this many times (load scaling).

    Returns:
      (IRGraph, TraceStats)
    """
    if not isinstance(cfg, CFG):
        cfg = load_cfg(cfg)
    b = _StreamBuilder(resolve_weight_model(weight_model), chunk_edges,
                       keep_labels, None, on_error)
    # static listing: (fn, bb) -> [(lineno, record), ...] in block order
    blocks: dict = {}
    lines, close = _open_lines(source)
    try:
        for lineno, line in enumerate(lines, start=1):
            rec = b.parse_line(lineno, line)
            if rec is not None:
                key = (rec.get("fn", "?"), rec.get("bb", "?"))
                blocks.setdefault(key, []).append((lineno, rec))
    finally:
        close()
    wanted = set(path_ids) if path_ids is not None else None
    for path in cfg.paths:
        if fn is not None and path["fn"] != fn:
            continue
        if wanted is not None and path["path_id"] not in wanted:
            continue
        for _ in range(max(1, repeat)):
            for bb in path["bbs"]:
                b.new_block_run()
                for lineno, rec in blocks.get((path["fn"], bb), ()):
                    b.add_record(lineno, rec)
    return b.finalize(_source_name(source, name))


def load_cfg(source) -> CFG:
    """Parse CFG_SCHEMA v0 `block`/`edge`/`path` records from NDJSON."""
    succs: dict = {}
    paths: list = []
    lines, close = _open_lines(source)
    try:
        for lineno, line in enumerate(lines, start=1):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                raise TraceFormatError(lineno,
                                       f"not valid JSON: {line[:60]!r}")
            if not isinstance(rec, dict):
                raise TraceFormatError(lineno, "record is not a JSON object")
            kind = rec.get("kind")
            try:
                if kind == "block":
                    succs.setdefault((rec["fn"], rec["bb"]),
                                     set()).update(rec.get("succs", []))
                elif kind == "edge":
                    succs.setdefault((rec["fn"], rec["from"]),
                                     set()).add(rec["to"])
                elif kind == "path":
                    paths.append({"fn": rec["fn"],
                                  "path_id": rec.get("path_id", len(paths)),
                                  "bbs": list(rec.get("bbs", []))})
                # other kinds (summaries, coverage, trace records) ignored
            except KeyError as e:
                raise TraceFormatError(
                    lineno, f"{kind!r} record missing field {e}") from None
    finally:
        close()
    return CFG(succs=succs, paths=paths)


def load_graph(source, **kw) -> IRGraph:
    """Load an `IRGraph` from a path, whatever the serialization.

    Dispatches on suffix: `.npz` snapshots load via `IRGraph.load_npz`,
    `.rtb` (+ `.gz`/`.zst`) binary traces via `repro_torch.trace.binfmt`, and
    everything else ingests as a TRACE_SCHEMA v0 NDJSON trace (any
    keyword accepted by `ingest_trace` passes through).  This is the
    dispatch behind `coerce_graph` / `run_pipeline(path, ...)`.
    """
    path = os.fspath(source)
    if path.endswith(".npz"):
        return IRGraph.load_npz(path)
    return ingest_trace(path, **kw)
