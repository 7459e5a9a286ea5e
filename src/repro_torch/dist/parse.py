"""Parallel (sharded) NDJSON trace parse front end.

The sequential ingester (`repro_torch.trace.ingest`) is a single pass with two
kinds of cross-record state: vertex ids assigned in stream order, and
rolling per-function def-tables binding SSA uses to their producers.
This module parallelizes that pass over W byte-range shards with a
cheap sequential merge — the "per-shard def-table seeding" of the
distributed front end:

  1. **Shard** the file into W byte ranges aligned to line boundaries
     (`shard_byte_ranges`); compressed sources (.gz / .zst) are not
     seekable-splittable, so they are decompressed once and cut into W
     in-memory line blocks instead.
  2. **Parse** each shard independently (`_ShardBuilder`, one per
     worker process).  Vertex ids are shard-local; a use of a value id
     with no local def creates a *provisional live-in* vertex and is
     recorded as **pending** — it may actually be produced by an
     earlier shard.
  3. **Merge** sequentially (cheap — dict updates and vectorized id
     remaps, no JSON): walk shards in stream order, resolve each
     shard's pending symbols against the accumulated def-tables of the
     shards before it, drop the resolved placeholder vertices
     (compacting ids), rewrite their edges to the true producers,
     recompute those edges' weights with the producer's def bytes, and
     fold the shard's def exports into the global tables (later defs
     overwrite earlier ones, exactly like the rolling tables).

Because pending uses bind to the def-table state at shard start — the
same state the sequential pass would have had — the merged graph is
**bit-identical to the sequential ingester for any W** on well-formed
traces (asserted in tests; `workers=1` is the degenerate single-shard
case).  The only divergence is bookkeeping at shard boundaries on
*malformed* traces: program-point/CFG ordering validation resets at a
boundary, so a record the sequential pass would reject as out-of-order
can be accepted by the shard that starts on it, and error line numbers
are shard-relative.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from time import perf_counter

import numpy as np

from .. import obs
from ..core.graph import IRGraph
from ..trace.ingest import (DEFAULT_CHUNK_EDGES, TraceStats, _open_lines,
                            _source_name, _StreamBuilder, CFG, load_cfg)
from ..trace.weights import resolve_weight_model

__all__ = ["shard_byte_ranges", "dist_ingest", "dist_ingest_with_stats",
           "ShardParse", "ShardMerger", "open_shard_parses"]

POOLS = ("auto", "process", "serial")


# ---------------------------------------------------------------------- #
# sharding
# ---------------------------------------------------------------------- #
def shard_byte_ranges(path, workers: int) -> "list[tuple[int, int]]":
    """Split a plain NDJSON file into <= `workers` byte ranges.

    Cut points target `size * s / workers` and advance to the next line
    boundary, so every line belongs to exactly one range; ranges are a
    pure function of (file bytes, workers) — the determinism anchor of
    the whole front end.
    """
    size = os.path.getsize(path)
    if workers <= 1 or size == 0:
        return [(0, size)]
    cuts = [0]
    with open(path, "rb") as f:
        for s in range(1, workers):
            tgt = size * s // workers
            if tgt <= cuts[-1]:
                continue
            f.seek(tgt)
            f.readline()                 # finish the line containing tgt
            pos = f.tell()
            if cuts[-1] < pos < size:
                cuts.append(pos)
    cuts.append(size)
    return list(zip(cuts[:-1], cuts[1:]))


def _text_line_blocks(text: str, workers: int) -> "list[str]":
    """Cut decompressed text into <= `workers` blocks at line boundaries."""
    if workers <= 1 or not text:
        return [text] if text else []
    cuts = [0]
    for s in range(1, workers):
        tgt = len(text) * s // workers
        if tgt <= cuts[-1]:
            continue
        nl = text.find("\n", tgt)
        pos = len(text) if nl < 0 else nl + 1
        if cuts[-1] < pos < len(text):
            cuts.append(pos)
    cuts.append(len(text))
    return [text[a:b] for a, b in zip(cuts[:-1], cuts[1:]) if a < b]


# ---------------------------------------------------------------------- #
# per-shard builder
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class ShardParse:
    """One shard's parse output, in shard-local vertex ids."""

    n: int                        # local vertex count
    src: np.ndarray               # int64[|E_s|] local producer ids
    dst: np.ndarray               # int64[|E_s|] local consumer ids
    w: np.ndarray                 # float64[|E_s|]
    labels: "list | None"
    defs_by_fn: dict              # fn -> {sym: (local vid, def bytes)}
    pend_syms: list               # [(fn, sym, placeholder vid)] first-use order
    pend_edges: list              # [(edge idx, placeholder vid, op, use_ty)]
    counters: dict                # TraceStats fields to sum/max
    fns: set                      # function names seen
    bbs: set                      # (fn, bb) pairs seen
    # telemetry spans timed inside the (possibly remote) parse worker;
    # the merging coordinator absorbs them into the active collector,
    # rewriting the lane to the shard's stream position
    events: list = dataclasses.field(default_factory=list)


class _ShardBuilder(_StreamBuilder):
    """`_StreamBuilder` variant that records cross-shard pending uses.

    Only the operand scan (`_add_use_edges`) is overridden, with three
    changes: an unresolved non-const use registers its placeholder in
    the pending tables; a later use that binds to a pending placeholder
    is appended to the pending-edge list (so the merge can rewrite it
    too); and the edge counter tracks flat edge indices for those
    rewrites.  The validation/ordering prologue, the def-table
    rollover, and the def registration are the parent's — the parent
    remains the oracle the W=1 equality tests hold this class to, and
    future changes there apply to both parsers by construction.
    """

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._pend_vids: set = set()     # unresolved placeholder local vids
        self._pend_syms: list = []       # (fn, sym, vid) in first-use order
        self._pend_edges: list = []      # (edge idx, vid, op, use_ty)
        self._edges = 0                  # flat edge index within the shard

    def _add_use_edges(self, nid: int, n: int, op: str, uses,
                       use_tys) -> int:
        defs_get = self.defs.get
        weight_fn = self.weight_fn
        src_append = self._src.append
        dst_append = self._dst.append
        w_append = self._w.append
        labels = self.labels
        pend_vids = self._pend_vids
        pend_edges = self._pend_edges
        edge_idx = self._edges
        fn = self._cur_fn               # the prologue switched tables
        for i, u in enumerate(uses):
            ty = use_tys[i] if use_tys is not None else None
            entry = defs_get(u)
            if entry is not None:
                pid, pbytes = entry
                if pbytes is None and pid in pend_vids:
                    # re-use of a provisional live-in: the merge may
                    # rebind this edge to an earlier shard's def
                    pend_edges.append((edge_idx, pid, op, ty))
            elif u.startswith("const:"):
                pid, pbytes = n, None
                n += 1
                self._const_uses += 1
                if labels is not None:
                    labels.append("const")
            else:
                # provisional live-in: pending until the merge knows
                # whether an earlier shard defined `u`
                pid, pbytes = n, None
                n += 1
                self.defs[u] = (pid, None)
                pend_vids.add(pid)
                self._pend_syms.append((fn, u, pid))
                pend_edges.append((edge_idx, pid, op, ty))
                self._livein_uses += 1
                if labels is not None:
                    labels.append(u)
            src_append(pid)
            dst_append(nid)
            w_append(weight_fn(op, ty, pbytes))
            edge_idx += 1
        self._edges = edge_idx
        return n

    def finalize_shard(self) -> ShardParse:
        self._flush()
        if self._batches:
            src = np.concatenate([b[0] for b in self._batches]).astype(
                np.int64)
            dst = np.concatenate([b[1] for b in self._batches]).astype(
                np.int64)
            w = np.concatenate([b[2] for b in self._batches])
        else:
            src = np.zeros(0, np.int64)
            dst = np.zeros(0, np.int64)
            w = np.zeros(0, np.float64)
        counters = {
            "lines": self._lines, "records": self._records,
            "cfg_records": self._cfg_records, "skipped": self._skipped,
            "const_uses": self._const_uses, "livein_uses": self._livein_uses,
            "void_defs": self._void_defs,
            "cfg_violations": self._cfg_violations,
            "peak_chunk_edges": self._peak,
        }
        return ShardParse(
            n=self.n, src=src, dst=dst, w=w, labels=self.labels,
            defs_by_fn=self._defs_by_fn, pend_syms=self._pend_syms,
            pend_edges=self._pend_edges, counters=counters,
            fns=set(self._defs_by_fn), bbs=self._bbs)


_RANGE_READ_BLOCK = 1 << 20


def _iter_range_lines(path, start: int, end: int):
    """Stream the lines of a byte range, splitting ONLY on b"\\n".

    Two properties matter here: memory stays O(read block), preserving
    the sequential ingester's bounded-buffer discipline for plain
    files; and lines are cut exactly where the byte-range sharder cuts
    them — at 0x0A bytes.  `str.splitlines()` would also break on
    U+2028/NEL/form-feed, which are legal *raw inside JSON strings*,
    tearing well-formed records apart.  Splitting the raw bytes is
    UTF-8-safe (0x0A never occurs in a continuation byte) and each
    line decodes whole.
    """
    with open(path, "rb") as f:
        f.seek(start)
        carry = b""
        left = end - start
        while left > 0:
            data = f.read(min(_RANGE_READ_BLOCK, left))
            if not data:
                break
            left -= len(data)
            pieces = (carry + data).split(b"\n")
            carry = pieces.pop()
            for piece in pieces:
                yield piece.decode("utf-8")
        if carry:
            yield carry.decode("utf-8")


def _iter_block_lines(text: str):
    """Lines of an in-memory decompressed block, splitting only on \\n
    (same contract as `_iter_range_lines`; the trailing newline does
    not produce a phantom empty line)."""
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    return lines


def _parse_shard(task) -> ShardParse:
    """Worker entry: parse one shard (path byte-range or text block)."""
    (path, start, end, text, weight_model, chunk_edges, keep_labels, cfg,
     on_error) = task
    b = _ShardBuilder(resolve_weight_model(weight_model), chunk_edges,
                      keep_labels, cfg, on_error)
    lines = (_iter_range_lines(path, start, end) if text is None
             else _iter_block_lines(text))
    parse_line, add_record = b.parse_line, b.add_record
    t0 = perf_counter()
    for lineno, line in enumerate(lines, start=1):
        rec = parse_line(lineno, line)
        if rec is not None:
            add_record(lineno, rec)
    sp = b.finalize_shard()
    # one span per shard, recorded unconditionally (a dict per shard is
    # noise-free): perf_counter is system-wide, so the coordinator can
    # splice worker-process spans into its own profile
    sp.events.append({
        "name": "parse.shard", "ph": "X", "ts": t0 * 1e6,
        "dur": (perf_counter() - t0) * 1e6, "lane": "parse", "cat": "op",
        "args": {"lines": sp.counters["lines"], "edges": int(len(sp.src))}})
    return sp


# ---------------------------------------------------------------------- #
# incremental merge
# ---------------------------------------------------------------------- #
class ShardMerger:
    """Incremental cross-shard def-table resolution, in stream order.

    One `add(shard)` per parse shard, strictly in shard order: it
    resolves the shard's pending live-ins against the def tables
    accumulated from earlier shards, remaps the shard's edges to global
    vertex ids, and returns them — so a consumer (the pipelined cut
    engine) can start streaming a shard's edges the moment it is merged,
    without waiting for the rest of the parse.  `finish()` assembles the
    full `(IRGraph, TraceStats)`; feeding every shard through `add` and
    calling `finish` is exactly the old one-shot merge (the sequential
    ingester equivalence contract is unchanged).
    """

    def __init__(self, weight_fn, keep_labels: bool):
        self._weight_fn = weight_fn
        self._global_defs: dict = {}   # fn -> {sym: (global vid, bytes)}
        self.n = 0                     # global vertex count so far
        self.edges = 0                 # global edge count so far
        self._srcs: list = []
        self._dsts: list = []
        self._ws: list = []
        self._labels: "list | None" = [] if keep_labels else None
        self._sums = dict.fromkeys(
            ("lines", "records", "cfg_records", "skipped", "const_uses",
             "livein_uses", "void_defs", "cfg_violations"), 0)
        self._peak = 0
        self._fns: set = set()
        self._bbs: set = set()

    def add(self, sh: ShardParse
            ) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
        """Merge the next shard; return its (src, dst, w) in global ids."""
        weight_fn = self._weight_fn
        resolved: dict = {}            # placeholder local vid -> (gvid, b)
        for fn, sym, vid in sh.pend_syms:
            entry = self._global_defs.get(fn, {}).get(sym)
            if entry is not None:
                resolved[vid] = entry
        keep = np.ones(sh.n, dtype=bool)
        if resolved:
            keep[np.fromiter(resolved, dtype=np.int64,
                             count=len(resolved))] = False
        l2g = np.cumsum(keep) - 1 + self.n
        for vid, (gvid, _b) in resolved.items():
            l2g[vid] = gvid

        w = sh.w
        for edge_idx, vid, op, ty in sh.pend_edges:
            entry = resolved.get(vid)
            if entry is not None:
                # the true producer's def bytes were unknown at parse
                # time; recompute exactly what the sequential pass paid
                w[edge_idx] = weight_fn(op, ty, entry[1])
        src = l2g[sh.src] if sh.n else sh.src
        dst = l2g[sh.dst] if sh.n else sh.dst
        self._srcs.append(src)
        self._dsts.append(dst)
        self._ws.append(w)
        self.edges += len(src)

        for fn, table in sh.defs_by_fn.items():
            gt = self._global_defs.setdefault(fn, {})
            for sym, (vid, b) in table.items():
                if vid in resolved and b is None:
                    # entry is a resolved placeholder: the earlier
                    # shard's def already owns this symbol
                    continue
                gt[sym] = (int(l2g[vid]), b)

        if self._labels is not None and sh.labels is not None:
            if resolved:
                self._labels.extend(lab for i, lab in enumerate(sh.labels)
                                    if keep[i])
            else:
                self._labels.extend(sh.labels)
        self.n += int(keep.sum())

        c = sh.counters
        for k in self._sums:
            self._sums[k] += c[k]
        self._sums["livein_uses"] -= len(resolved)  # provisional, not real
        self._peak = max(self._peak, c["peak_chunk_edges"])
        self._fns |= sh.fns
        self._bbs |= sh.bbs
        return src, dst, w

    def finish(self, name: str) -> "tuple[IRGraph, TraceStats]":
        if self._srcs:
            src = np.concatenate(self._srcs).astype(np.int32)
            dst = np.concatenate(self._dsts).astype(np.int32)
            w = np.concatenate(self._ws)
        else:
            src = np.zeros(0, np.int32)
            dst = np.zeros(0, np.int32)
            w = np.zeros(0, np.float64)
        stats = TraceStats(peak_chunk_edges=self._peak,
                           functions=len(self._fns),
                           blocks=len(self._bbs), **self._sums)
        g = IRGraph(n=self.n, src=src, dst=dst, w=w, name=name,
                    node_labels=self._labels)
        return g, stats


def _merge_shards(shards: "list[ShardParse]", weight_fn, name: str,
                  keep_labels: bool) -> "tuple[IRGraph, TraceStats]":
    mg = ShardMerger(weight_fn, keep_labels)
    for sh in shards:
        mg.add(sh)
    return mg.finish(name)


# ---------------------------------------------------------------------- #
# public entry points
# ---------------------------------------------------------------------- #
def dist_ingest_with_stats(source, *, workers: int = 1,
                           weight_model="bytes",
                           chunk_edges: int = DEFAULT_CHUNK_EDGES,
                           on_error: str = "raise", cfg=None,
                           name: "str | None" = None,
                           keep_labels: bool = False,
                           pool: str = "auto"):
    """Parallel `ingest_trace_with_stats` over byte-sharded NDJSON.

    Args:
      source: path to an NDJSON trace (`.gz` / `.zst` decompress
        transparently but shard over in-memory line blocks — compressed
        streams have no seekable line boundaries, so the O(chunk)
        memory bound is traded for parallelism there).
      workers: shard count W.  The merged graph is bit-identical to the
        sequential ingester for any W on well-formed traces; `workers=1`
        is the degenerate single-shard case.
      pool: "process" (fork/spawn worker pool), "serial" (parse shards
        in-process — determinism oracle and small-input path), or
        "auto": processes when `workers > 1` and the weight model is a
        registered name (a bare callable may not pickle).
      Everything else matches `ingest_trace_with_stats`; `on_error`
        line numbers are shard-relative in dist mode.

    Returns:
      (IRGraph, TraceStats)
    """
    if not isinstance(source, (str, os.PathLike)):
        raise TypeError("dist ingestion shards a file path; got "
                        f"{type(source).__name__} (use ingest_trace for "
                        "file-like or iterable sources)")
    from ..trace.binfmt import is_binary_trace_path, read_trace_bin
    if is_binary_trace_path(source):
        # .rtb containers are pre-chunked columnar arrays: there is no
        # line splitting to parallelise, and the loaded graph is the
        # conversion-time graph for any worker count by construction
        if cfg is not None:
            raise ValueError(
                "cfg validation applies to NDJSON traces; a .rtb binary "
                "trace is already a validated graph")
        g, stats = read_trace_bin(source, keep_labels=keep_labels)
        if name is not None:
            g = dataclasses.replace(g, name=name)
        return g, stats
    tasks = _shard_tasks(source, workers, weight_model, chunk_edges,
                         keep_labels, cfg, on_error, pool)
    mg = ShardMerger(resolve_weight_model(weight_model), keep_labels)
    col = obs.current()
    with open_shard_parses(tasks, pool, weight_model) as shards:
        for i, sh in enumerate(shards):
            if col is not None and sh.events:
                for ev in sh.events:
                    ev["lane"] = f"parse/p{i}"
                col.absorb_events(sh.events)
            with obs.span("parse.merge", lane="coord"):
                mg.add(sh)
    return mg.finish(_source_name(source, name))


def _shard_tasks(source, workers: int, weight_model, chunk_edges: int,
                 keep_labels: bool, cfg, on_error: str,
                 pool: str) -> list:
    """Build the per-shard parse task tuples for an NDJSON source."""
    if pool not in POOLS:
        raise ValueError(f"unknown pool {pool!r}; choose from {POOLS}")
    workers = max(1, int(workers))
    if cfg is not None and not isinstance(cfg, CFG):
        cfg = load_cfg(cfg)
    path = os.fspath(source)
    compressed = path.endswith((".gz", ".zst", ".zstd"))
    if compressed:
        f, close = _open_lines(path)
        try:
            blocks = _text_line_blocks(f.read(), workers)
        finally:
            close()
        tasks = [(None, 0, 0, blk, weight_model, chunk_edges, keep_labels,
                  cfg, on_error) for blk in blocks]
    else:
        tasks = [(path, a, b, None, weight_model, chunk_edges, keep_labels,
                  cfg, on_error)
                 for a, b in shard_byte_ranges(path, workers)]
    if not tasks:
        tasks = [(None, 0, 0, "", weight_model, chunk_edges, keep_labels,
                  cfg, on_error)]
    return tasks


@contextlib.contextmanager
def open_shard_parses(tasks: list, pool: str, weight_model):
    """Yield an iterator of `ShardParse` results, strictly in task order.

    With a process pool the shards parse concurrently and stream back
    through an ordered `imap` — the consumer can merge (and cut) shard
    k while shards k+1..W are still parsing, which is the parse side of
    the pipelined dataflow.  `pool` semantics match
    `dist_ingest_with_stats`; the serial path is the determinism oracle
    and the degenerate 1-task path.
    """
    if pool not in POOLS:
        raise ValueError(f"unknown pool {pool!r}; choose from {POOLS}")
    use_processes = (pool == "process"
                     or (pool == "auto" and len(tasks) > 1
                         and isinstance(weight_model, str)))
    if use_processes and len(tasks) > 1:
        import multiprocessing as mp
        method = "fork" if "fork" in mp.get_all_start_methods() else None
        ctx = mp.get_context(method)
        with ctx.Pool(processes=len(tasks)) as p:
            yield p.imap(_parse_shard, tasks)
    else:
        yield (_parse_shard(t) for t in tasks)


def dist_ingest(source, **kw) -> IRGraph:
    """`dist_ingest_with_stats` without the stats (the common call)."""
    return dist_ingest_with_stats(source, **kw)[0]
