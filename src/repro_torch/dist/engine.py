"""Sharded streaming vertex-cut engine (pipelined parse→cut dataflow).

The greedy streaming cut is inherently sequential *within* a stream,
but PowerGraph-style oblivious placement is shard-local by
construction: each worker places a slice of the edge stream against
its own replica/load view, and views are periodically reconciled so
placement happens against near-global state.  Two dataflow modes share
the worker/merge machinery:

**Two-phase** (in-memory graphs, `.npz`/`.rtb` inputs, `workers=1`,
shuffled streams, PG-rule methods): the (possibly permuted) edge
stream is split into W contiguous shards; each worker owns a
`ShardCutState` and streams `merge_period` edges per round; round
barriers reconcile the states.  `workers=1` runs the single shard
through the identical chunked engine path and is bit-identical to
`vertex_cut(..., backend="fast")`.

**Pipelined** (NDJSON trace paths, `workers>1`, Libra-rule methods in
trace order — the `wb_libra` default): byte-range parse shards stream
through an ordered process-pool `imap` into the incremental shard
merger, and merged edge chunks feed resident cut workers round-robin —
cutting starts as soon as the first shard is merged, while later
shards are still parsing, instead of behind a whole-file parse
barrier.  Round r covers global edge offsets [r·W·q, (r+1)·W·q)
(q = `merge_period`), worker s takes the r·W+s-th chunk, and the
Libra degree swap and the λ load bound use *prefix* snapshots taken at
the round's end offset (degrees and Σw over the edges streamed so
far).  Those snapshots are pure functions of the trace's edge stream
and the round quantum — independent of parse shard boundaries, pool
choice, and thread/process timing — so the pipelined output is
deterministic, but it legitimately differs from the two-phase output,
whose swap/bound see the *final* degrees and total weight (pass
`pipeline=False` to force two-phase parity on paths).

**Merges** are either fixed-period (every round, `divergence=None` —
the legacy schedule) or adaptive: every round the O(p) load vectors
are delta-reduced and re-adopted (cheap, keeps the λ bound and the
least-loaded argmins near-global), but the O(n·limbs) replica-mask /
remaining-degree merge runs only when the max per-cluster load drift
since the last full merge exceeds `divergence` × the mean cluster
load.  The drift test reads only merged loads, so the schedule — and
therefore the output — stays a pure function of the inputs.

**Worker pools**: rounds run on resident workers in one of three
interchangeable pools — `thread` (the C kernel streams GIL-released),
`process` (resident `multiprocessing` workers fed chunks over pipes,
so the pure-Python engine scales on no-compiler hosts instead of
serializing on the GIL), or `serial` (in-process loop, the scheduling
oracle).  Workers see the identical call sequence in every pool, so
the pool choice never affects the result.

**Finalize** decodes the replica CSR straight from the merged bitmask
limb rows (`_arrayops.masks_to_replica_csr`, sharded over vertex
ranges on the thread pool) instead of re-sorting all 2|E| endpoints —
bit-identical to `_finalize` because the merged worker masks *are* the
assignment-derived replica sets.

Determinism contract: the output is a pure function of (graph, p,
method, lam, seed, edge_order, workers, merge_period, divergence) —
rounds cover fixed edge offsets in fixed shard order and merges are
load-triggered off deterministic merged values, so pool choice, parse
sharding, and scheduling cannot influence the result.  `workers=1` is
bit-identical to `vertex_cut(..., backend="fast")` (asserted in tests
and checked on the card's machine by `chip_smoke.py`).
"""
from __future__ import annotations

import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from time import perf_counter

import numpy as np

from .. import obs
from ..core.vertex_cut import (ALGORITHMS, ShardCutState, VertexCutResult,
                               resolve_backend, vertex_cut)
from ..core._arrayops import (masks_to_replica_csr, merge_deltas,
                              merge_limb_masks)

__all__ = ["dist_vertex_cut", "DEFAULT_MERGE_PERIOD", "shard_bounds",
           "WORKER_POOLS"]

DEFAULT_MERGE_PERIOD = 1 << 16
WORKER_POOLS = ("auto", "thread", "process", "serial")
_FINALIZE_SHARDS = 8


def shard_bounds(m: int, workers: int) -> "list[int]":
    """Contiguous stream slice boundaries: W+1 offsets over m edges."""
    workers = max(1, min(int(workers), max(1, m)))
    return [m * s // workers for s in range(workers + 1)]


# ---------------------------------------------------------------------- #
# resident worker pools
# ---------------------------------------------------------------------- #
class _SerialPool:
    """All shard states in-process; rounds run as a plain loop.

    The scheduling oracle: thread and process pools must produce the
    identical result because workers see the identical call sequence.
    """

    kind = "serial"

    def __init__(self, nshards: int, n: int, p: int, deg: np.ndarray,
                 bound: float, libra_rule: bool, engine: str):
        self.states = [ShardCutState.create(n, p, deg, bound, libra_rule,
                                            engine)
                       for _ in range(nshards)]

    def run_round(self, jobs) -> "list[tuple[float, float]]":
        """Returns one (t0, us) pair per job: the absolute perf_counter
        start (seconds) and duration (µs) of the worker's stream_chunk —
        the coordinator turns them into per-lane telemetry spans."""
        us = []
        for s, su, sv, w, out in jobs:
            t0 = perf_counter()
            self.states[s].stream_chunk(su, sv, w, out)
            us.append((t0, (perf_counter() - t0) * 1e6))
        return us

    def local_loads(self) -> "list[np.ndarray]":
        return [st.loads for st in self.states]

    def collect_rm(self):
        return ([st.rem for st in self.states],
                [st.masks for st in self.states])

    def adopt(self, loads, rem, masks) -> None:
        for st in self.states:
            st.adopt(loads, rem, masks)

    def adopt_loads(self, loads) -> None:
        for st in self.states:
            st.adopt_loads(loads)

    def set_bound(self, bound: float) -> None:
        for st in self.states:
            st.bound = bound

    def grow(self, n: int) -> None:
        for st in self.states:
            st.grow(n)

    def close(self) -> None:
        pass


class _ThreadPool(_SerialPool):
    """Rounds fan out over a thread pool (the C kernel streams with the
    GIL released, so shard chunks execute in parallel)."""

    kind = "thread"

    def __init__(self, *args):
        super().__init__(*args)
        self._ex = ThreadPoolExecutor(max_workers=len(self.states))

    def run_round(self, jobs) -> "list[tuple[float, float]]":
        def go(job):
            s, su, sv, w, out = job
            t0 = perf_counter()
            self.states[s].stream_chunk(su, sv, w, out)
            return (t0, (perf_counter() - t0) * 1e6)

        return list(self._ex.map(go, jobs))

    def map_blocks(self, fn, blocks):
        """Fan arbitrary block work (the sharded finalize) over the pool."""
        return list(self._ex.map(fn, blocks))

    def close(self) -> None:
        self._ex.shutdown(wait=False)


def _cut_worker_main(conn, n: int, p: int, deg, bound: float,
                     libra_rule: bool, engine: str) -> None:
    """Resident process-pool worker: owns one ShardCutState, executes
    the coordinator's message stream until "stop"."""
    try:
        st = ShardCutState.create(n, p, deg, bound, libra_rule, engine)
        while True:
            msg = conn.recv()
            tag = msg[0]
            if tag == "chunk":
                su, sv, w = msg[1], msg[2], msg[3]
                # t0 rides home with the result: perf_counter is
                # CLOCK_MONOTONIC (system-wide), so the coordinator can
                # place this span on the worker's telemetry lane
                out = np.empty(len(su), dtype=np.int32)
                t0 = perf_counter()
                st.stream_chunk(su, sv, w, out)
                us = (perf_counter() - t0) * 1e6
                conn.send(("out", out, st.loads.copy(), t0, us))
            elif tag == "adopt":
                st.adopt(msg[1], msg[2], msg[3])
            elif tag == "adopt_loads":
                st.adopt_loads(msg[1])
            elif tag == "bound":
                st.bound = msg[1]
            elif tag == "grow":
                st.grow(msg[1])
            elif tag == "collect":
                conn.send(("rm", st.rem.copy(), st.masks.copy()))
            elif tag == "stop":
                return
    except (EOFError, KeyboardInterrupt):
        return
    except Exception as exc:  # surface worker failures to the coordinator
        try:
            conn.send(("error", f"{type(exc).__name__}: {exc}"))
        except (OSError, BrokenPipeError):
            pass
    finally:
        conn.close()


class _ProcessPool:
    """Resident multiprocessing workers, one ShardCutState each.

    The coordinator ships edge chunks and merge snapshots over pipes;
    workers stream with their own interpreter/GIL, which is what makes
    the pure-Python engine scale on hosts without a C compiler.  The
    message sequence per worker is identical to the other pools', so
    the output is too.
    """

    kind = "process"

    def __init__(self, nshards: int, n: int, p: int, deg: np.ndarray,
                 bound: float, libra_rule: bool, engine: str):
        import multiprocessing as mp
        method = "fork" if "fork" in mp.get_all_start_methods() else None
        ctx = mp.get_context(method)
        self._procs = []
        self._conns = []
        self._loads = [np.zeros(p, dtype=np.float64)
                       for _ in range(nshards)]
        for _ in range(nshards):
            here, there = ctx.Pipe()
            proc = ctx.Process(target=_cut_worker_main,
                               args=(there, n, p, deg, bound, libra_rule,
                                     engine), daemon=True)
            proc.start()
            there.close()
            self._procs.append(proc)
            self._conns.append(here)

    def _recv(self, s: int):
        msg = self._conns[s].recv()
        if msg[0] == "error":
            raise RuntimeError(f"dist cut worker {s} failed: {msg[1]}")
        return msg

    def run_round(self, jobs) -> "list[tuple[float, float]]":
        for s, su, sv, w, _out in jobs:
            self._conns[s].send(("chunk", su, sv, w))
        us = []
        for s, _su, _sv, _w, out in jobs:
            _tag, chunk_out, loads, chunk_t0, chunk_us = self._recv(s)
            out[:] = chunk_out
            self._loads[s] = loads
            us.append((chunk_t0, chunk_us))
        return us

    def local_loads(self) -> "list[np.ndarray]":
        # workers report loads with every chunk result; a worker with no
        # job this round hasn't streamed, so its cached copy is current
        return self._loads

    def collect_rm(self):
        for conn in self._conns:
            conn.send(("collect",))
        rems, masks = [], []
        for s in range(len(self._conns)):
            _tag, rem, mk = self._recv(s)
            rems.append(rem)
            masks.append(mk)
        return rems, masks

    def _broadcast(self, msg) -> None:
        for conn in self._conns:
            conn.send(msg)

    def adopt(self, loads, rem, masks) -> None:
        self._broadcast(("adopt", loads, rem, masks))
        for i in range(len(self._loads)):
            self._loads[i] = loads.copy()

    def adopt_loads(self, loads) -> None:
        self._broadcast(("adopt_loads", loads))
        for i in range(len(self._loads)):
            self._loads[i] = loads.copy()

    def set_bound(self, bound: float) -> None:
        self._broadcast(("bound", bound))

    def grow(self, n: int) -> None:
        self._broadcast(("grow", n))

    def close(self) -> None:
        for conn in self._conns:
            try:
                conn.send(("stop",))
            except (OSError, BrokenPipeError):
                pass
        for proc in self._procs:
            proc.join(timeout=5)
            if proc.is_alive():
                proc.terminate()
        for conn in self._conns:
            conn.close()


def _resolve_worker_pool(pool: str, engine: str, nshards: int) -> str:
    """Concrete pool kind for this (engine, shard count) combination."""
    if pool not in WORKER_POOLS:
        raise ValueError(f"unknown pool {pool!r}; choose from {WORKER_POOLS}")
    if nshards <= 1:
        return "serial"
    if pool == "auto":
        if engine == "native":
            return "thread"          # the kernel releases the GIL
        # pure-Python engine: threads would serialize on the GIL and run
        # W>1 strictly slower than W=1 — resident processes instead
        return "process"
    if pool == "thread" and engine == "python":
        warnings.warn(
            "dist pool='thread' with the pure-Python engine holds the GIL: "
            "W>1 will not run faster than W=1; use pool='process' (or "
            "'auto')", RuntimeWarning, stacklevel=3)
    return pool


def _make_pool(kind: str, nshards: int, n: int, p: int, deg: np.ndarray,
               bound: float, libra_rule: bool, engine: str,
               stacklevel: int = 3):
    cls = {"serial": _SerialPool, "thread": _ThreadPool,
           "process": _ProcessPool}[kind]
    try:
        return cls(nshards, n, p, deg, bound, libra_rule, engine)
    except (ImportError, OSError) as exc:
        if kind == "process":
            # stacklevel points past dist_vertex_cut (and _pipelined_cut
            # when routed through it) at the user's call site
            warnings.warn(f"dist process pool unavailable ({exc}); "
                          "falling back to serial rounds", RuntimeWarning,
                          stacklevel=stacklevel)
            return _SerialPool(nshards, n, p, deg, bound, libra_rule, engine)
        raise


# ---------------------------------------------------------------------- #
# merge scheduling
# ---------------------------------------------------------------------- #
class _MergeController:
    """Round-barrier merge schedule: fixed-period or load-divergence.

    Every round the per-shard load vectors are delta-reduced against
    the last snapshot and re-adopted (O(W·p)).  A *full* merge — the
    O(n·limbs) replica-mask OR plus the remaining-degree reduction —
    runs every round when `divergence` is None (the legacy fixed
    schedule) or when the max per-cluster drift since the last full
    merge exceeds `divergence` × the mean cluster load.  All decisions
    read merged (deterministic) values only.
    """

    def __init__(self, p: int, rem0: "np.ndarray | None",
                 divergence: "float | None"):
        self.p = p
        self.divergence = divergence
        self.snapshot_loads = np.zeros(p, dtype=np.float64)
        self.last_full_loads = np.zeros(p, dtype=np.float64)
        self.snapshot_rem = rem0       # None => rem is not merged (Libra)
        self.full_merges = 0
        self.round_merges = 0

    def round_merge(self, pool) -> bool:
        """Reconcile after a round barrier; returns True on full merge."""
        est = merge_deltas(self.snapshot_loads, pool.local_loads())
        self.round_merges += 1
        full = self.divergence is None
        if not full:
            mean = est.sum() / self.p
            if mean > 0:
                drift = float(np.abs(est - self.last_full_loads).max())
                full = drift > self.divergence * mean
            else:
                full = True
        if full:
            rems, masks_list = pool.collect_rm()
            rem = (merge_deltas(self.snapshot_rem, rems)
                   if self.snapshot_rem is not None else None)
            masks = merge_limb_masks(masks_list)
            pool.adopt(est, rem, masks)
            if rem is not None:
                self.snapshot_rem = rem
            self.last_full_loads = est.copy()
            self.full_merges += 1
        else:
            pool.adopt_loads(est)
        self.snapshot_loads = est
        return full


# ---------------------------------------------------------------------- #
# finalize (sharded, masks-based)
# ---------------------------------------------------------------------- #
def _finalize_from_masks(g, method: str, p: int, lam: float,
                         assignment: np.ndarray, masks: np.ndarray,
                         executor=None) -> VertexCutResult:
    """Build the VertexCutResult from the merged worker bitmasks.

    The union of the worker masks is exactly the assignment-derived
    replica sets (every placement sets both endpoints' bits in the
    placing worker's rows), so the CSR decode is bit-identical to the
    sort-based `_finalize` — without touching the 2|E| endpoint arrays.
    The decode is sharded over vertex ranges; loads/counts stay serial
    `np.bincount` for float bit-identity.
    """
    limbs = (p + 63) // 64
    indptr, flat = masks_to_replica_csr(masks, g.n, limbs, p,
                                        executor=executor,
                                        shards=_FINALIZE_SHARDS)
    loads = np.bincount(assignment, weights=g.w,
                        minlength=p).astype(np.float64)
    counts = np.bincount(assignment, minlength=p).astype(np.int64)
    return VertexCutResult(
        graph_name=g.name, method=method, p=p, lam=lam,
        assignment=assignment, loads=loads, edge_counts=counts,
        n_vertices=g.n, total_weight=g.total_weight,
        replica_indptr=indptr, replica_flat=flat)


# ---------------------------------------------------------------------- #
# pipelined dataflow (parse shards stream into resident cut workers)
# ---------------------------------------------------------------------- #
class _EdgeBacklog:
    """FIFO of merged edge arrays; pops exact round-sized slices."""

    def __init__(self):
        self._parts: list = []
        self._head = 0
        self.size = 0

    def push(self, src, dst, w) -> None:
        if len(src):
            self._parts.append((src, dst, w))
            self.size += len(src)

    def pop(self, k: int):
        k = min(k, self.size)
        take_s, take_d, take_w = [], [], []
        got = 0
        while got < k:
            src, dst, w = self._parts[0]
            avail = len(src) - self._head
            t = min(avail, k - got)
            sl = slice(self._head, self._head + t)
            take_s.append(src[sl])
            take_d.append(dst[sl])
            take_w.append(w[sl])
            got += t
            if t == avail:
                self._parts.pop(0)
                self._head = 0
            else:
                self._head += t
        self.size -= got
        if len(take_s) == 1:
            return take_s[0], take_d[0], take_w[0]
        return (np.concatenate(take_s), np.concatenate(take_d),
                np.concatenate(take_w))


def _pipelined_cut(path: str, p: int, method: str, lam: float,
                   workers: int, merge_period: int,
                   divergence: "float | None", engine: str,
                   pool_kind: str, parse_workers: int,
                   timeline: "dict | None") -> VertexCutResult:
    """Stream parse shards through the merger into resident cut workers.

    Round r covers edges [r·W·q, (r+1)·W·q) of the merged trace stream;
    the Libra swap and λ bound snapshot prefix degrees / prefix Σw at
    the round's end offset.  Deterministic for fixed (trace, p, method,
    lam, W, merge_period, divergence) — see the module docstring.
    """
    from ..trace.ingest import DEFAULT_CHUNK_EDGES, _source_name
    from ..trace.weights import resolve_weight_model
    from .parse import ShardMerger, _shard_tasks, open_shard_parses

    weighted = method in ("w_pg", "wb_pg", "w_libra", "wb_libra")
    balanced = method in ("wb_pg", "wb_libra")
    q = merge_period
    round_edges = workers * q

    tasks = _shard_tasks(path, parse_workers, "bytes", DEFAULT_CHUNK_EDGES,
                         False, None, "raise", "auto")
    merger = ShardMerger(resolve_weight_model("bytes"), False)
    backlog = _EdgeBacklog()
    deg = np.zeros(0, dtype=np.int64)
    wsum = 0.0
    outs: list = []
    rounds_tl: "list | None" = [] if timeline is not None else None

    pool = _make_pool(pool_kind, workers, 0, p, np.zeros(0, np.int64),
                      float("inf"), True, engine, stacklevel=4)
    ctrl = _MergeController(p, None, divergence)
    col = obs.current()
    shard_i = 0
    try:
        t_parse0 = perf_counter()
        with open_shard_parses(tasks, "auto", "bytes") as shard_iter:
            it = iter(shard_iter)
            exhausted = False
            while True:
                t0 = perf_counter()
                while backlog.size < round_edges and not exhausted:
                    sh = next(it, None)
                    if sh is None:
                        exhausted = True
                    else:
                        if col is not None and sh.events:
                            # parse spans were timed inside the (possibly
                            # remote) parse worker; land them on a lane
                            # keyed by shard order, which the worker
                            # itself does not know
                            for ev in sh.events:
                                ev["lane"] = f"parse/p{shard_i}"
                            col.absorb_events(sh.events)
                        shard_i += 1
                        with obs.span("parse.merge", lane="coord"):
                            backlog.push(*merger.add(sh))
                parse_wait_us = (perf_counter() - t0) * 1e6
                obs.complete("dist.parse_wait", t0,
                             t0 + parse_wait_us / 1e6, lane="coord",
                             cat="wait", round=len(outs))
                obs.observe("dist.parse_wait_us", parse_wait_us)
                if backlog.size == 0:
                    break
                src_r, dst_r, w_r = backlog.pop(round_edges)
                k = len(src_r)
                n_now = merger.n
                if len(deg) < n_now:
                    grown = np.zeros(n_now, dtype=np.int64)
                    grown[:len(deg)] = deg
                    deg = grown
                deg += np.bincount(src_r, minlength=len(deg))
                deg += np.bincount(dst_r, minlength=len(deg))
                if weighted:
                    if k and float(w_r.min()) < 0:
                        raise ValueError(
                            "edge weights must be >= 0 for the greedy cuts")
                    wl = np.ascontiguousarray(w_r, dtype=np.float64)
                else:
                    wl = np.ones(k)
                wsum += float(wl.sum())
                bound = lam * wsum / p if balanced else float("inf")
                # Libra endpoint swap against the prefix-degree snapshot
                swap = deg[src_r] > deg[dst_r]
                su = np.ascontiguousarray(np.where(swap, dst_r, src_r),
                                          dtype=np.int32)
                sv = np.ascontiguousarray(np.where(swap, src_r, dst_r),
                                          dtype=np.int32)
                pool.grow(n_now)
                pool.set_bound(bound)
                out_r = np.empty(k, dtype=np.int32)
                jobs = []
                for s in range(workers):
                    a, b = s * q, min((s + 1) * q, k)
                    if a < b:
                        jobs.append((s, su[a:b], sv[a:b], wl[a:b],
                                     out_r[a:b]))
                cut_us = pool.run_round(jobs)
                r = len(outs)
                # worker durations arrive over the pool's result channel
                # (a pipe for process pools), so the coordinator merges
                # every worker's samples into one histogram here — no
                # shared memory, identical distribution to a serial run
                for (s, _su, _sv, _w, _out), (ct0, cus) in zip(jobs, cut_us):
                    obs.complete("dist.cut", ct0, ct0 + cus / 1e6,
                                 lane=f"cut/w{s}", round=r)
                    obs.observe("dist.cut_us", cus)
                obs.counter("dist.edges", k)
                obs.observe("dist.round_edges", k)
                outs.append(out_r)
                t1 = perf_counter()
                more = backlog.size > 0 or not exhausted
                full = ctrl.round_merge(pool) if more else False
                merge_us = (perf_counter() - t1) * 1e6
                if more:
                    obs.complete("dist.merge", t1, t1 + merge_us / 1e6,
                                 lane="coord", round=r, full=bool(full))
                    obs.observe("dist.merge_us", merge_us)
                if rounds_tl is not None:
                    rounds_tl.append({
                        "round": r, "edges": k,
                        "parse_wait_us": round(parse_wait_us, 1),
                        "cut_us": [round(u, 1) for _t, u in cut_us],
                        "merge_us": round(merge_us, 1),
                        "full_merge": bool(full)})
        parse_us = (perf_counter() - t_parse0) * 1e6
        g, _stats = merger.finish(_source_name(path, None))
        t2 = perf_counter()
        _rems, masks_list = pool.collect_rm()
        masks = merge_limb_masks(masks_list)
    finally:
        pool.close()

    assignment = (np.concatenate(outs) if outs
                  else np.empty(0, dtype=np.int32))
    with ThreadPoolExecutor(max_workers=_FINALIZE_SHARDS) as ex:
        result = _finalize_from_masks(g, method, p, lam, assignment, masks,
                                      executor=ex)
    finalize_us = (perf_counter() - t2) * 1e6
    obs.complete("dist.finalize", t2, t2 + finalize_us / 1e6, lane="coord")
    obs.observe("dist.finalize_us", finalize_us)
    obs.counter("dist.full_merges", ctrl.full_merges)
    obs.counter("dist.round_merges", ctrl.round_merges)
    if timeline is not None:
        timeline.update({
            "mode": "pipelined", "pool": pool.kind, "engine": engine,
            "workers": workers, "merge_period": merge_period,
            "divergence": divergence, "rounds": rounds_tl,
            "full_merges": ctrl.full_merges,
            "round_merges": ctrl.round_merges,
            "parse_and_cut_us": round(parse_us, 1),
            "finalize_us": round(finalize_us, 1)})
    return result


# ---------------------------------------------------------------------- #
# public entry point
# ---------------------------------------------------------------------- #
def dist_vertex_cut(g, p: int, method: str = "wb_libra", lam: float = 1.0,
                    seed: int = 0, edge_order: str = "auto",
                    workers: int = 1,
                    merge_period: "int | None" = None,
                    divergence: "float | None" = None,
                    backend: str = "fast",
                    pool: str = "auto",
                    pipeline: "bool | str" = "auto",
                    parse_workers: "int | None" = None,
                    timeline: "dict | None" = None) -> VertexCutResult:
    """Partition `g`'s edges into `p` clusters on W sharded workers.

    Args:
      g: `IRGraph`, or a path (`.npz` snapshot / `.rtb` container /
        NDJSON trace).  NDJSON paths are eligible for the pipelined
        parse→cut dataflow; everything else two-phases (parse/load,
        then cut).
      workers: shard count W.  1 reproduces `backend="fast"` bit for
        bit; W > 1 is deterministic for fixed (W, seed, merge_period,
        divergence).
      merge_period: edges each worker streams between round barriers
        (default `DEFAULT_MERGE_PERIOD`); smaller tracks global state
        more closely (better quality, more merge overhead).
      divergence: None (default) runs a full state merge at every
        round barrier — the fixed legacy schedule.  A float d >= 0
        merges loads every round but defers the expensive replica-mask
        merge until the max per-cluster load drift since the last full
        merge exceeds d × the mean cluster load (d ~ 0.05 keeps
        quality close to the fixed schedule at a fraction of the merge
        traffic; d = 0 is the fixed schedule again).
      backend: fast-engine selector for the workers ("fast", "native",
        "python").  The greedy stream never runs on "reference"/"cuda"
        — use `vertex_cut` for those.
      pool: "thread" / "process" / "serial" worker pool, or "auto":
        threads when the C kernel is available (it streams
        GIL-released), resident processes for the pure-Python engine
        (threads would serialize on the GIL).  The pool never affects
        the result.
      pipeline: "auto" (default) streams parse shards directly into
        the cut workers for NDJSON paths with W > 1 Libra-rule
        trace-order cuts; True forces it (raises when ineligible);
        False always two-phases.  Pipelined output uses prefix
        degree/bound snapshots and differs (deterministically) from
        the two-phase output — see the module docstring.
      parse_workers: byte-range parse shard count for the pipelined
        dataflow (default: `workers`).  Parse sharding never affects
        the output — rounds cover global edge offsets.
      timeline: legacy back-compat shim — an optional dict the engine
        fills with per-round, per-worker phase timings
        (parse/cut/merge/finalize), built from the same measurements
        the engine now emits as `repro_torch.obs` telemetry spans.  New code
        should activate a collector (`REPRO_PROFILE=out.json` or
        `obs.scoped()`) and read the profile instead.

    Everything else matches `vertex_cut`.
    """
    if method not in ALGORITHMS:
        raise ValueError(f"unknown method {method!r}; choose from {ALGORITHMS}")
    if p < 1:
        raise ValueError("p must be >= 1")
    if lam < 1.0:
        raise ValueError("lambda must be >= 1 (paper Eq. 3)")
    if merge_period is None:
        merge_period = DEFAULT_MERGE_PERIOD
    if merge_period < 1:
        raise ValueError("merge_period must be >= 1")
    if divergence is not None and divergence < 0:
        raise ValueError("divergence must be >= 0 (or None for the fixed "
                         "merge schedule)")
    if pipeline not in (True, False, "auto"):
        raise ValueError("pipeline must be True, False or 'auto'")
    workers = max(1, int(workers))
    engine = resolve_backend(backend)
    if engine not in ("native", "python"):
        raise ValueError(
            f"shard streaming runs on the fast engines only, not "
            f"{backend!r} (the greedy stream is inherently sequential)")

    balanced = method in ("wb_pg", "wb_libra")
    libra_rule = method in ("libra", "w_libra", "wb_libra")
    eff_order = edge_order
    if eff_order == "auto":
        eff_order = "trace" if balanced else "shuffled"

    path = os.fspath(g) if isinstance(g, (str, os.PathLike)) else None
    ndjson_path = (path is not None and not path.endswith(".npz")
                   and not _is_binary(path))
    pipe_ok = (ndjson_path and workers > 1 and libra_rule
               and eff_order == "trace" and method != "random")
    if pipeline is True and not pipe_ok:
        raise ValueError(
            "pipeline=True needs an NDJSON trace path, workers >= 2, a "
            "Libra-rule method and edge_order='trace' (the prefix-snapshot "
            "semantics only exist for streamed trace-order Libra cuts); "
            f"got path={path!r}, workers={workers}, method={method!r}, "
            f"edge_order={eff_order!r}")
    if pipeline in (True, "auto") and pipe_ok:
        pool_kind = _resolve_worker_pool(pool, engine, workers)
        return _pipelined_cut(path, p, method, lam, workers, merge_period,
                              divergence, engine, pool_kind,
                              parse_workers or workers, timeline)

    t_ingest0 = perf_counter()
    if path is not None:
        if path.endswith(".npz"):
            from ..core.graph import IRGraph
            g = IRGraph.load_npz(path)
        else:
            from .parse import dist_ingest
            g = dist_ingest(path, workers=workers)
        obs.complete("dist.ingest", t_ingest0, perf_counter(), lane="coord",
                     cat="section", source=os.path.basename(path))
    ingest_us = (perf_counter() - t_ingest0) * 1e6

    if method == "random":
        # no streaming state to shard; identical to the fast engine
        return vertex_cut(g, p, method=method, lam=lam, seed=seed,
                          edge_order=edge_order, backend="fast")

    m = g.num_edges
    weighted = method in ("w_pg", "wb_pg", "w_libra", "wb_libra")
    if weighted and m and float(g.w.min()) < 0:
        raise ValueError("edge weights must be >= 0 for the greedy cuts")

    # stream-order selection: must mirror vertex_cut exactly (same rng
    # construction) so workers=1 sees the identical stream
    rng = np.random.default_rng(seed)
    if eff_order == "shuffled":
        perm = rng.permutation(m)
    elif eff_order == "trace":
        perm = np.arange(m)
    else:
        raise ValueError("edge_order must be 'shuffled', 'trace' or 'auto'")

    src = g.src[perm]
    dst = g.dst[perm]
    w = g.w[perm] if weighted else np.ones(m)
    w = np.ascontiguousarray(w, dtype=np.float64)
    deg = g.degrees()
    total_load = float(w.sum())
    bound = lam * total_load / p if balanced else float("inf")

    if libra_rule:
        swap = deg[src] > deg[dst]
        su = np.ascontiguousarray(np.where(swap, dst, src), dtype=np.int32)
        sv = np.ascontiguousarray(np.where(swap, src, dst), dtype=np.int32)
    else:
        su = np.ascontiguousarray(src, dtype=np.int32)
        sv = np.ascontiguousarray(dst, dtype=np.int32)

    bounds = shard_bounds(m, workers)
    nshards = len(bounds) - 1
    out = np.empty(m, dtype=np.int32)
    pool_kind = _resolve_worker_pool(pool, engine, nshards)
    wpool = _make_pool(pool_kind, nshards, g.n, p, deg, bound, libra_rule,
                       engine)
    rounds_tl: "list | None" = [] if timeline is not None else None
    ctrl = _MergeController(
        p, deg.astype(np.int64, copy=True) if not libra_rule else None,
        divergence)
    try:
        if nshards == 1:
            # single shard: the chunked resumable path is bit-identical
            # to one uninterrupted _stream_fast pass (no merges to run)
            st = wpool.states[0]
            with obs.span("dist.cut", lane="cut/w0", rounds=1):
                for a in range(0, m, merge_period):
                    b = min(a + merge_period, m)
                    st.stream_chunk(su[a:b], sv[a:b], w[a:b], out[a:b])
        else:
            shard_len = max(bounds[s + 1] - bounds[s]
                            for s in range(nshards))
            rounds = -(-shard_len // merge_period)
            for r in range(rounds):
                jobs = []
                for s in range(nshards):
                    a = bounds[s] + r * merge_period
                    b = min(a + merge_period, bounds[s + 1])
                    if a < b:
                        jobs.append((s, su[a:b], sv[a:b], w[a:b],
                                     out[a:b]))
                cut_us = wpool.run_round(jobs)
                for (s, _su, _sv, _w, _o), (ct0, cus) in zip(jobs, cut_us):
                    obs.complete("dist.cut", ct0, ct0 + cus / 1e6,
                                 lane=f"cut/w{s}", round=r)
                    obs.observe("dist.cut_us", cus)
                t1 = perf_counter()
                full = ctrl.round_merge(wpool) if r + 1 < rounds else False
                merge_us = (perf_counter() - t1) * 1e6
                if r + 1 < rounds:
                    obs.complete("dist.merge", t1, t1 + merge_us / 1e6,
                                 lane="coord", round=r, full=bool(full))
                    obs.observe("dist.merge_us", merge_us)
                if rounds_tl is not None:
                    rounds_tl.append({
                        "round": r,
                        "cut_us": [round(u, 1) for _t, u in cut_us],
                        "merge_us": round(merge_us, 1),
                        "full_merge": bool(full)})
        t2 = perf_counter()
        _rems, masks_list = wpool.collect_rm()
        masks = merge_limb_masks(masks_list)
    finally:
        wpool.close()

    assignment = np.empty(m, dtype=np.int32)
    assignment[perm] = out
    with ThreadPoolExecutor(max_workers=_FINALIZE_SHARDS) as ex:
        result = _finalize_from_masks(g, method, p, lam, assignment, masks,
                                      executor=ex)
    t3 = perf_counter()
    obs.complete("dist.finalize", t2, t3, lane="coord")
    obs.observe("dist.finalize_us", (t3 - t2) * 1e6)
    if timeline is not None:
        timeline.update({
            "mode": "two-phase", "pool": wpool.kind, "engine": engine,
            "workers": nshards, "merge_period": merge_period,
            "divergence": divergence, "rounds": rounds_tl,
            "full_merges": ctrl.full_merges,
            "round_merges": ctrl.round_merges,
            "ingest_us": round(ingest_us, 1),
            "finalize_us": round((perf_counter() - t2) * 1e6, 1)})
    return result


def _is_binary(path: str) -> bool:
    from ..trace.binfmt import is_binary_trace_path
    return is_binary_trace_path(path)
