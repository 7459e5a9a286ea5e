"""Incremental repartitioning: stream new trace windows into a live cut.

`IncrementalPlanner` keeps a long-lived partition over a growing trace.
New windows parse into a single `TraceSession` (one id space, rolling
def-tables) and their edges stream into a durable, resumable
`ShardCutState` in **round quanta** — the same prefix-snapshot
semantics as the pipelined dist engine: round r covers global edge
offsets [r·q, (r+1)·q), and the Libra degree swap plus the λ load
bound snapshot the degrees / Σw of the edges streamed so far at the
round's end offset.  Edges past the last full quantum wait in a
backlog; `plan()` flushes them into a *clone* of the durable state, so
the committed state only ever advances by whole quanta.

**Bit-identity contract.**  Because rounds sit at fixed global offsets
and every snapshot is a pure function of the edge prefix, the output
is independent of how the trace was split into windows: appending a
new window and re-planning is bit-identical to planning a fresh
session fed the whole concatenated trace (asserted in
tests/test_torch_serve.py and checked on the card by `chip_smoke.py`).
When the whole trace fits in one quantum the output is additionally
bit-identical to `vertex_cut(g, ..., edge_order="trace",
backend="fast")` — a single uninterrupted stream.

**Dirty-row finalize.**  Replica sets live as bitmask limb rows inside
the cut state; a cold finalize would decode all O(n·limbs) words
(`masks_to_replica_csr`).  The planner instead keeps the decoded CSR
from the previous plan and re-decodes only the rows whose masks can
have changed — vertices touched by edges streamed since — then splices
them in with a flat ragged copy.  Decode cost tracks the appended
window, not the full trace.
"""
from __future__ import annotations

import numpy as np

from .. import obs
from ..core._arrayops import masks_to_replica_csr
from ..core.graph import IRGraph
from ..core.mapping import (Machine, cluster_interaction_graphs,
                            memory_centric_mapping, resolve_mapping_backend)
from ..core.cuda import resolve_device
from ..core.simulator import simulate, vertex_bytes_model
from ..core.vertex_cut import ShardCutState, VertexCutResult
from ..trace.ingest import TraceSession

__all__ = ["IncrementalPlanner", "INCREMENTAL_METHODS", "DEFAULT_QUANTUM",
           "finish_plan"]

# Libra-rule methods only: the PG case-2 rule consults remaining degree,
# which is unknowable before the stream ends — same restriction as the
# pipelined dist dataflow.
INCREMENTAL_METHODS = ("libra", "w_libra", "wb_libra")
DEFAULT_QUANTUM = 1 << 16


def finish_plan(g: IRGraph, cut: VertexCutResult,
                machine: "Machine | None" = None, backend: str = "cuda",
                device: str = "cuda"):
    """Map + simulate a finished cut (the tail of `plan_graph`'s
    pipeline, returning the mapping and report the plan bundle needs).

    `backend="cuda"`, the default, runs the interaction graphs and the
    simulator's reductions on `device` (the card unless the caller asks
    for "cpu"); the host backends ignore `device`."""
    map_backend = resolve_mapping_backend(backend)
    dev = resolve_device(device) if map_backend == "cuda" else None
    p = cut.p
    with obs.span("plan.map", cat="section", backend=map_backend):
        comm, shared = cluster_interaction_graphs(
            cut, p, vertex_bytes_model(g), backend=map_backend, device=dev)
        mapping = memory_centric_mapping(
            comm, shared, machine or Machine.for_clusters(p),
            backend=map_backend)
    with obs.span("plan.simulate", cat="section", backend=map_backend):
        rep = simulate(g, cut, mapping, backend=map_backend, device=dev)
    return mapping, rep


class _Backlog:
    """FIFO of pending (src, dst, stream-weight) edge arrays."""

    def __init__(self):
        self._parts: list = []
        self.size = 0

    def push(self, src, dst, wl) -> None:
        if len(src):
            self._parts.append((src, dst, wl))
            self.size += len(src)

    def pop(self, k: int):
        """Destructively take exactly min(k, size) leading edges."""
        k = min(k, self.size)
        taken, got = [], 0
        while got < k:
            src, dst, wl = self._parts[0]
            need = k - got
            if len(src) <= need:
                taken.append(self._parts.pop(0))
                got += len(src)
            else:
                taken.append((src[:need], dst[:need], wl[:need]))
                self._parts[0] = (src[need:], dst[need:], wl[need:])
                got += need
        self.size -= got
        if len(taken) == 1:
            return taken[0]
        return tuple(np.concatenate([t[i] for t in taken])
                     for i in range(3))

    def snapshot(self):
        """The pending edges, without consuming them."""
        if not self._parts:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(0, np.float64))
        if len(self._parts) == 1:
            return self._parts[0]
        return tuple(np.concatenate([t[i] for t in self._parts])
                     for i in range(3))


def _ragged_indices(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat gather indices for rows (starts[i] .. starts[i]+lens[i])."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    offs = starts - np.concatenate(([0], np.cumsum(lens)[:-1]))
    return np.repeat(offs, lens) + np.arange(total, dtype=np.int64)


def _splice_rows(indptr: np.ndarray, flat: np.ndarray, d: np.ndarray,
                 ip_d: np.ndarray, flat_d: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Replace rows `d` of CSR (indptr, flat) with (ip_d, flat_d)."""
    n = len(indptr) - 1
    old_counts = np.diff(indptr)
    counts = old_counts.copy()
    counts[d] = np.diff(ip_d)
    new_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=new_indptr[1:])
    new_flat = np.empty(int(new_indptr[-1]), dtype=np.int32)
    clean = np.ones(n, dtype=bool)
    clean[d] = False
    new_flat[_ragged_indices(new_indptr[:-1][clean], old_counts[clean])] = \
        flat[_ragged_indices(indptr[:-1][clean], old_counts[clean])]
    new_flat[_ragged_indices(new_indptr[:-1][d], counts[d])] = flat_d
    return new_indptr, new_flat


class IncrementalPlanner:
    """Long-lived planner over a growing trace (see module docstring).

    `backend="cuda"` (the default) streams on the fast engine, as
    `vertex_cut`'s cuda backend does, and runs `finish_plan` on `device`;
    its plans are bit-identical to `backend="fast"`.  The JAX package
    passes `backend` to the stream state itself, which refuses its
    device backend."""

    def __init__(self, p: int, method: str = "wb_libra", lam: float = 1.0,
                 quantum: int = DEFAULT_QUANTUM, backend: str = "cuda",
                 weight_model: str = "bytes", name: str = "session",
                 device: str = "cuda"):
        if method not in INCREMENTAL_METHODS:
            raise ValueError(
                f"incremental repartitioning supports the Libra-rule "
                f"trace-order methods {INCREMENTAL_METHODS}, not {method!r} "
                f"(the PG case rule needs remaining degrees, which only a "
                f"finished stream knows)")
        if p < 1:
            raise ValueError("p must be >= 1")
        if lam < 1.0:
            raise ValueError("lambda must be >= 1 (paper Eq. 3)")
        if quantum < 1:
            raise ValueError("quantum must be >= 1")
        self.p = p
        self.method = method
        self.lam = lam
        self.quantum = int(quantum)
        self.backend = backend
        self.device = device
        self.name = name
        self.weighted = method in ("w_libra", "wb_libra")
        self.balanced = method == "wb_libra"

        self.session = TraceSession(weight_model=weight_model)
        self.state = ShardCutState.create(
            0, p, np.zeros(0, np.int64), float("inf"), True,
            "fast" if backend == "cuda" else backend)
        self._backlog = _Backlog()
        self._deg = np.zeros(0, dtype=np.int64)   # prefix degrees, committed
        self._wsum = 0.0                          # prefix Σ stream-weight
        self._outs: list = []                     # committed round outputs
        self.committed_edges = 0
        self.rounds = 0
        # dirty-row finalize state
        self._csr: "tuple | None" = None          # durable CSR cache
        self._dirty_parts: list = []              # touched since last decode

    # ------------------------------------------------------------------ #
    def append(self, source) -> int:
        """Parse one trace window and stream every full quantum of its
        edges into the durable state.  Returns the edges added."""
        with obs.span("serve.append", cat="section"):
            src, dst, w = self.session.feed(source)
            wl = (np.ascontiguousarray(w, dtype=np.float64)
                  if self.weighted else np.ones(len(src)))
            if self.weighted and len(wl) and float(wl.min()) < 0:
                raise ValueError(
                    "edge weights must be >= 0 for the greedy cuts")
            self._backlog.push(src, dst, wl)
            while self._backlog.size >= self.quantum:
                self._commit_round(*self._backlog.pop(self.quantum))
        return len(src)

    def _grow_deg(self, deg: np.ndarray, n: int) -> np.ndarray:
        if len(deg) >= n:
            return deg
        grown = np.zeros(n, dtype=np.int64)
        grown[:len(deg)] = deg
        return grown

    def _prep_round(self, deg: np.ndarray, wsum: float, src_r, dst_r, wl_r):
        """Advance a (deg, wsum) prefix snapshot over one edge chunk and
        derive the chunk's swapped endpoints and λ bound."""
        deg = self._grow_deg(deg, self.session.n)
        deg += np.bincount(src_r, minlength=len(deg))
        deg += np.bincount(dst_r, minlength=len(deg))
        wsum += float(wl_r.sum())
        bound = self.lam * wsum / self.p if self.balanced else float("inf")
        swap = deg[src_r] > deg[dst_r]
        su = np.ascontiguousarray(np.where(swap, dst_r, src_r),
                                  dtype=np.int32)
        sv = np.ascontiguousarray(np.where(swap, src_r, dst_r),
                                  dtype=np.int32)
        return deg, wsum, bound, su, sv

    def _commit_round(self, src_r, dst_r, wl_r) -> None:
        self._deg, self._wsum, bound, su, sv = self._prep_round(
            self._deg, self._wsum, src_r, dst_r, wl_r)
        self.state.grow(self.session.n)
        self.state.bound = bound
        out = np.empty(len(su), dtype=np.int32)
        self.state.stream_chunk(su, sv, wl_r, out)
        self._outs.append(out)
        self._dirty_parts.append(np.concatenate((src_r, dst_r)))
        self.committed_edges += len(su)
        self.rounds += 1
        obs.counter("serve.incremental_rounds", 1)

    # ------------------------------------------------------------------ #
    def _durable_csr(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """CSR over the durable masks, decoding only dirty rows."""
        limbs = self.state.limbs
        if self._csr is None:
            indptr, flat = masks_to_replica_csr(
                self.state.masks, n, limbs, self.p)
            obs.counter("serve.finalize_rows_decoded", n)
        else:
            indptr, flat = self._csr
            if len(indptr) - 1 < n:        # new vertices: empty rows
                grown = np.full(n + 1, indptr[-1], dtype=np.int64)
                grown[:len(indptr)] = indptr
                indptr = grown
            if self._dirty_parts:
                d = np.unique(np.concatenate(self._dirty_parts)
                              .astype(np.int64))
                rows = self.state.masks[:len(self.state.rem) * limbs] \
                    .reshape(-1, limbs)
                ip_d, flat_d = masks_to_replica_csr(
                    np.ascontiguousarray(rows[d]).ravel(), len(d), limbs,
                    self.p)
                indptr, flat = _splice_rows(indptr, flat, d, ip_d, flat_d)
                obs.counter("serve.finalize_rows_decoded", len(d))
        self._csr = (indptr, flat)
        self._dirty_parts = []
        return indptr, flat

    def plan(self, machine: "Machine | None" = None):
        """Partition + map + simulate the full trace streamed so far.

        Returns (graph, cut, mapping, report).  Pending backlog edges
        are flushed into a clone of the durable state, so calling
        `plan()` never perturbs subsequent appends.
        """
        with obs.span("serve.plan_incremental", cat="section",
                      edges=self.committed_edges + self._backlog.size):
            g = self.session.graph(self.name)
            src_t, dst_t, wl_t = self._backlog.snapshot()
            outs = self._outs
            indptr, flat = self._durable_csr(g.n)
            if len(src_t):
                st = self.state.clone()
                _deg, _ws, bound, su, sv = self._prep_round(
                    self._deg.copy(), self._wsum, src_t, dst_t, wl_t)
                st.grow(g.n)
                st.bound = bound
                tail_out = np.empty(len(su), dtype=np.int32)
                st.stream_chunk(su, sv, wl_t, tail_out)
                outs = outs + [tail_out]
                t = np.unique(np.concatenate((src_t, dst_t))
                              .astype(np.int64))
                rows = st.masks[:len(st.rem) * st.limbs] \
                    .reshape(-1, st.limbs)
                ip_t, flat_t = masks_to_replica_csr(
                    np.ascontiguousarray(rows[t]).ravel(), len(t),
                    st.limbs, self.p)
                indptr, flat = _splice_rows(indptr, flat, t, ip_t, flat_t)
            assignment = (np.concatenate(outs) if outs
                          else np.zeros(0, dtype=np.int32))
            # full-stream bincounts: float-bit-identical to a cold
            # _finalize over the concatenated trace
            loads = np.bincount(assignment, weights=g.w,
                                minlength=self.p).astype(np.float64)
            counts = np.bincount(assignment,
                                 minlength=self.p).astype(np.int64)
            cut = VertexCutResult(
                graph_name=g.name, method=self.method, p=self.p,
                lam=self.lam, assignment=assignment, loads=loads,
                edge_counts=counts, n_vertices=g.n,
                total_weight=g.total_weight, replica_indptr=indptr,
                replica_flat=flat)
        mapping, rep = finish_plan(g, cut, machine, self.backend,
                                   self.device)
        return g, cut, mapping, rep
