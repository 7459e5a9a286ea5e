"""Weight Balanced p-way Vertex Cut — paper §4 (Algorithm 1 and variants).

Implements all six vertex-cut strategies evaluated in the paper plus the
random baseline used for the theoretical analysis:

  random    — random edge placement (paper §4.2.1, analysed by Eq. 10)
  pg        — PowerGraph greedy, unweighted loads   [Gonzalez et al. 2012]
  libra     — degree-based greedy, unweighted       [Xie et al. 2014]
  w_pg      — Weighted PowerGraph                   (paper §4.3 case rules)
  wb_pg     — Weight Balanced PowerGraph            (paper §4.3, λ bound)
  w_libra   — Weighted Libra                        (paper §4.3 case rules)
  wb_libra  — Weight Balanced Libra                 (paper Algorithm 1)

All six greedy cuts share one streaming engine implementing the paper's
case rules; the unweighted baselines track loads in edge *counts*, the
weighted variants in edge *weights*.  Edges are streamed in SHUFFLED order
by default (`edge_order="shuffled"`), matching distributed graph-loading
practice [Gonzalez et al. 2012]: a shuffled stream hits Case 4 frequently
early on, seeding all p clusters — streaming a connected trace in strict
program order instead funnels every edge into the first cluster (a
pathology the λ bound of the WB variants repairs; see the edge-order
ablation in the benchmarks).

Two engines implement the same streaming semantics, selected with
`vertex_cut(..., backend=...)`:

  reference — the original per-edge Python loop over `set` replica sets
              with a lazy min-heap of cluster loads.  O(|E|·log p + Σ|A|),
              kept as the readable oracle the fast engines are verified
              against (see tests/test_backend_equivalence.py).
  fast      — array-native engine.  Replica sets A(v) are
              packed bitmasks (a single machine word for p <= 64, chunked
              uint64 limbs up to p = 1024+), loads/degrees/remaining
              degrees live in flat arrays, the leading run of Case-4
              edges is seeded in one vectorized batch, and `_finalize`
              builds the replica CSR with a vectorized unique-sort
              instead of a per-edge loop.  The inner stream runs through
              an optional C kernel (`_fastcut.c`, compiled on first use —
              see `_native.py`) at ~15-20x reference throughput, or
              through a pure-Python bitmask loop when no compiler is
              available.  Both are bit-identical to the reference: same
              case rules, same double accumulation order, and the same
              deterministic (load, cluster-id) argmin tie-breaking.
  native    — force the C kernel (raises if unavailable).
  python    — force the pure-Python bitmask engine.
  cuda      — the default: stream on the fast engine, then run
              `_finalize`'s replica and load reductions on `device`
              through the segment-sum
              layer (`cuda/`): the hand-written CUDA kernel on the card,
              its plain version on the host (`device="cpu"`).  Loads and
              the replica CSR are bit-identical to the numpy finalize
              (the kernel reproduces `np.bincount`'s accumulation order).
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

import torch

from .. import obs
from ._arrayops import replica_csr
from ._native import native_available, native_engine
from .cuda import keyed_sum, metrics as cuda_metrics, resolve_device
from .graph import IRGraph

__all__ = ["VertexCutResult", "vertex_cut", "ALGORITHMS", "BACKENDS",
           "resolve_backend", "ShardCutState"]

ALGORITHMS = ("random", "pg", "libra", "w_pg", "wb_pg", "w_libra", "wb_libra")
BACKENDS = ("fast", "native", "python", "cuda", "reference")


def resolve_backend(backend: str = "fast") -> str:
    """Concrete engine a backend choice runs on ("native"/"python"/...).

    "cuda" resolves to itself: its *stream* runs on the fast engine,
    but the finalize/metrics reductions run on the segment-sum layer.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    if backend == "fast":
        return "native" if native_available() else "python"
    return backend


@dataclasses.dataclass
class VertexCutResult:
    """Outcome of a p-way vertex cut on graph `g`.

    Replica sets are stored as a CSR over sorted cluster ids
    (`replica_indptr`, `replica_flat`); the `replicas` property
    materialises the legacy list-of-sets view (None == empty) on demand.
    """

    graph_name: str
    method: str
    p: int
    lam: float
    assignment: np.ndarray          # int32[|E|] -> cluster id M(e)
    loads: np.ndarray               # float64[p], weighted loads Σ w_e
    edge_counts: np.ndarray         # int64[p]
    n_vertices: int
    total_weight: float
    replica_indptr: np.ndarray      # int64[|V|+1]
    replica_flat: np.ndarray        # int32[Σ|A(v)|], sorted per vertex
    _replicas_cache: list | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def replicas(self) -> list:
        """Per-vertex replica set A(v) as list of sets (None == empty)."""
        if self._replicas_cache is None:
            ip, flat = self.replica_indptr, self.replica_flat
            self._replicas_cache = [
                set(flat[ip[v]:ip[v + 1]].tolist()) if ip[v + 1] > ip[v]
                else None
                for v in range(self.n_vertices)]
        return self._replicas_cache

    def replica_csr(self) -> tuple[np.ndarray, np.ndarray]:
        """Replica sets as (indptr, members) — the array-native view the
        mapping/simulator fast paths consume directly (members are sorted
        cluster ids per vertex; the owner is the first entry)."""
        return self.replica_indptr, self.replica_flat

    def replica_sizes(self) -> np.ndarray:
        """|A(v)| per vertex (0 for isolated vertices)."""
        return np.diff(self.replica_indptr)

    # -- paper metrics ------------------------------------------------- #
    @property
    def replication_factor(self) -> float:
        """Eq. (2): 1/|V| Σ_v |A(v)|  (isolated vertices contribute 0)."""
        return len(self.replica_flat) / max(1, self.n_vertices)

    @property
    def replication_factor_active(self) -> float:
        sizes = self.replica_sizes()
        sizes = sizes[sizes > 0]
        return float(sizes.mean()) if len(sizes) else 0.0

    @property
    def edge_weight_imbalance(self) -> float:
        """Paper §6.2.2: (max_m Σ_{M(e)=m} w_e) / (w_avg |E| / p)."""
        ideal = self.total_weight / self.p
        return float(self.loads.max() / ideal) if ideal > 0 else 1.0

    @property
    def edge_count_imbalance(self) -> float:
        m = len(self.assignment)
        ideal = m / self.p
        return float(self.edge_counts.max() / ideal) if ideal > 0 else 1.0

    def replica_sync_volume(self, vertex_bytes: np.ndarray | float = 1.0
                            ) -> float:
        """Inter-cluster traffic of a vertex cut = replica synchronisation:
        Σ_v (|A(v)| - 1) · bytes(v).  (Paper §6.2.4 — the only communication
        in a vertex-cut partition is between a cut vertex and its replicas.)
        """
        extra = np.maximum(self.replica_sizes() - 1, 0)
        if np.isscalar(vertex_bytes):
            return float(extra.sum() * vertex_bytes)
        return float((extra * np.asarray(vertex_bytes)).sum())

    def summary(self) -> dict:
        return {
            "graph": self.graph_name, "method": self.method, "p": self.p,
            "replication_factor": round(self.replication_factor, 4),
            "edge_weight_imbalance": round(self.edge_weight_imbalance, 6),
            "edge_count_imbalance": round(self.edge_count_imbalance, 6),
        }


# ---------------------------------------------------------------------- #
# resumable shard state (the dist partitioner's worker building block)
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class ShardCutState:
    """Resumable greedy-stream state for one shard of the edge stream.

    Wraps exactly the flat buffers the fast engines mutate — loads,
    bitmask limb rows, remaining degrees — so a stream can be run in
    chunks: streaming a shard through repeated `stream_chunk` calls is
    bit-identical to one uninterrupted `_stream_fast` pass (the engines
    are pure functions of this state; the lazy heap is only an argmin
    accelerator rebuilt per call).  The dist partitioner runs one state per
    worker and periodically installs a merged near-global snapshot with
    `adopt` (PowerGraph-style oblivious mode; see
    `_arrayops.merge_limb_masks` / `merge_deltas`).
    """

    p: int
    limbs: int
    bound: float
    rule_pg: int                    # 0 = Libra rule (pre-swapped), 1 = PG
    engine: str                     # "native" or "python"
    loads: np.ndarray               # float64[p] — local near-global view
    masks: np.ndarray               # uint64[n*limbs] — A(v) limb rows
    rem: np.ndarray                 # int64[n] — remaining-degree view
    fresh: bool = True              # all-zero state (Case-4 batch eligible)

    @classmethod
    def create(cls, n: int, p: int, deg: np.ndarray, bound: float,
               libra_rule: bool, backend: str = "fast") -> "ShardCutState":
        """Fresh all-zero shard state for an n-vertex graph."""
        engine = resolve_backend(backend)
        if engine not in ("native", "python"):
            raise ValueError(
                f"shard streaming runs on the fast engines only, not "
                f"{backend!r} (the greedy stream is inherently sequential)")
        if engine == "native" and native_engine() is None:
            raise RuntimeError(
                "native backend requested but no C compiler is available "
                "(or REPRO_NO_NATIVE is set); use backend='fast'")
        limbs = (p + 63) // 64
        return cls(p=p, limbs=limbs, bound=bound,
                   rule_pg=0 if libra_rule else 1, engine=engine,
                   loads=np.zeros(p, dtype=np.float64),
                   masks=np.zeros(n * limbs, dtype=np.uint64),
                   rem=deg.astype(np.int64, copy=True))

    def stream_chunk(self, su: np.ndarray, sv: np.ndarray, w: np.ndarray,
                     out: np.ndarray) -> None:
        """Stream one contiguous chunk of (pre-swapped) edges.

        Mutates this state in place and writes cluster ids into `out`
        (a view over the chunk's slice of the stream-order output).
        The batched Case-4 seeding applies only while the state is
        fresh — exactly when `_stream_fast` would apply it.
        """
        m = len(su)
        if m == 0:
            return
        start = 0
        if self.fresh:
            start = _seed_case4(su, sv, w, self.p, self.loads, self.masks,
                                self.rem, out, self.limbs, bool(self.rule_pg))
            self.fresh = False
        if self.engine == "native":
            native_engine()(start, m, su, sv, w, self.p, self.rule_pg,
                            self.bound, self.loads, self.masks, self.limbs,
                            self.rem, out)
        else:
            _stream_python(start, m, su, sv, w, self.p, self.rule_pg,
                           self.bound, self.loads, self.masks, self.limbs,
                           self.rem, out, writeback=True)

    def adopt(self, loads: np.ndarray, rem: "np.ndarray | None",
              masks: np.ndarray) -> None:
        """Install a merged near-global snapshot (the full merge hook).

        The dist engine calls this at merge barriers after reducing
        all shards' views (`merge_limb_masks` for replica masks,
        `merge_deltas` for loads / remaining degrees); the shard
        resumes streaming against the merged arrays.  `rem=None` skips
        the remaining-degree install — the Libra placement rule never
        consults `rem`, so Libra-method merges ship loads+masks only.
        Also clears `fresh`, so Case-4 batch seeding never re-fires
        mid-stream.
        """
        np.copyto(self.loads, loads)
        if rem is not None:
            np.copyto(self.rem, rem)
        np.copyto(self.masks, masks)
        self.fresh = False

    def adopt_loads(self, loads: np.ndarray) -> None:
        """Install merged loads only (the cheap adaptive-merge hook).

        The adaptive merge schedule reconciles the O(p) load vector
        every round but defers the O(n·limbs) replica/remaining-degree
        merge until the load-divergence bound trips — loads drive the
        λ-bound and every least-loaded argmin, so keeping them
        near-global is what protects balance between full merges.
        Clears `fresh` for the same reason `adopt` does: seeding
        assumes an all-zero load vector.
        """
        np.copyto(self.loads, loads)
        self.fresh = False

    def clone(self) -> "ShardCutState":
        """Deep copy: stream the copy without disturbing the original.

        The incremental repartitioner (the plan service) flushes a pending
        edge tail into a clone at plan time, so the durable state only
        ever advances by full round quanta."""
        return ShardCutState(
            p=self.p, limbs=self.limbs, bound=self.bound,
            rule_pg=self.rule_pg, engine=self.engine,
            loads=self.loads.copy(), masks=self.masks.copy(),
            rem=self.rem.copy(), fresh=self.fresh)

    def grow(self, n: int) -> None:
        """Extend the state to an `n`-vertex graph (new rows empty).

        The pipelined dataflow creates shard states before the parse
        has discovered the full vertex set and grows them as merged
        parse shards arrive; unseen vertices have empty replica sets
        and zero remaining degree, which is exactly the all-zero
        extension.  A no-op when the state already covers `n`.
        """
        old = len(self.rem)
        if n <= old:
            return
        grown = np.zeros(n * self.limbs, dtype=np.uint64)
        grown[:old * self.limbs] = self.masks
        self.masks = grown
        rem = np.zeros(n, dtype=np.int64)
        rem[:old] = self.rem
        self.rem = rem


# ---------------------------------------------------------------------- #
# the streaming greedy engine
# ---------------------------------------------------------------------- #
def vertex_cut(g: IRGraph, p: int, method: str = "wb_libra",
               lam: float = 1.0, seed: int = 0,
               edge_order: str = "auto",
               backend: str = "cuda",
               device: str = "cuda") -> VertexCutResult:
    """Partition the edges of `g` into `p` clusters.

    Args:
      g: weighted dataflow graph.
      p: number of clusters (cores) — paper's |C|.
      method: one of ALGORITHMS.
      lam: λ ≥ 1 imbalance factor for the WB-* variants (paper Eq. 3).
      seed: RNG seed (random placement / stream shuffling).
      edge_order: "trace" (strict program order), "shuffled" (loader
        order), or "auto" (default): trace order for the λ-bounded WB
        variants — they exploit stream locality and the bound guards
        against its pathology — and shuffled order for the unbounded
        greedy variants, whose native regime is distributed graph loading
        [Gonzalez et al. 2012] and which funnel a connected program-order
        stream into a single cluster (the benchmark suite carries an
        edge-order ablation quantifying this).
      backend: "cuda" (the default: fast stream + finalize reductions
        on `device`), "fast" (array-native; C kernel when available,
        else the pure-Python bitmask engine), "native"/"python" to
        force one fast engine, or "reference" for the original loop
        (the oracle).  All backends produce identical assignments.
      device: where the "cuda" backend's reductions run: "cuda" (the
        card, the default) or "cpu" (the kernels' plain versions).
        "cuda" raises when no card is present.  The host backends
        ignore it.
    """
    if method not in ALGORITHMS:
        raise ValueError(f"unknown method {method!r}; choose from {ALGORITHMS}")
    if p < 1:
        raise ValueError("p must be >= 1")
    if lam < 1.0:
        raise ValueError("lambda must be >= 1 (paper Eq. 3)")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    # checked before the host stream, so a missing card fails at once
    dev = resolve_device(device) if backend == "cuda" else None

    m = g.num_edges
    weighted = method in ("w_pg", "wb_pg", "w_libra", "wb_libra")
    balanced = method in ("wb_pg", "wb_libra")
    libra_rule = method in ("libra", "w_libra", "wb_libra")
    if weighted and m and float(g.w.min()) < 0:
        # every engine's lazy min-heap relies on loads growing monotonically
        raise ValueError("edge weights must be >= 0 for the greedy cuts")

    rng = np.random.default_rng(seed)

    if method == "random":
        assignment = np.empty(m, dtype=np.int32)
        assignment[:] = rng.integers(0, p, size=m)
        return _finalize(g, method, p, lam, assignment, backend, dev)

    if edge_order == "auto":
        edge_order = "trace" if balanced else "shuffled"
    if edge_order == "shuffled":
        perm = rng.permutation(m)
    elif edge_order == "trace":
        perm = np.arange(m)
    else:
        raise ValueError("edge_order must be 'shuffled', 'trace' or 'auto'")

    src = g.src[perm]
    dst = g.dst[perm]
    # Loads for greedy decisions: weights for the weighted variants, edge
    # counts for the unweighted PG/Libra baselines.
    w = g.w[perm] if weighted else np.ones(m)
    w = np.ascontiguousarray(w, dtype=np.float64)
    deg = g.degrees()
    # Algorithm 1 line 4: cluster weight-sum bound b = λ Σ w_e / p.
    # (Computed once here so every backend sees the identical bound.)
    total_load = float(w.sum())
    bound = lam * total_load / p if balanced else float("inf")

    if backend == "reference":
        with obs.span("cut.stream", engine="reference", edges=len(src)):
            assignment = _stream_reference(g.n, p, src, dst, w, deg,
                                           bound, libra_rule, perm)
    else:
        # the cuda backend streams on the fast engine: the greedy
        # stream is inherently sequential, only the reductions move
        assignment = _stream_fast(g.n, p, src, dst, w, deg, bound,
                                  libra_rule, perm,
                                  "fast" if backend == "cuda" else backend)
    return _finalize(g, method, p, lam, assignment, backend, dev)


# ---------------------------------------------------------------------- #
# reference engine: the original per-edge loop over Python sets (oracle)
# ---------------------------------------------------------------------- #
def _stream_reference(n: int, p: int, src_a: np.ndarray, dst_a: np.ndarray,
                      w_a: np.ndarray, deg_a: np.ndarray, bound: float,
                      libra_rule: bool, perm: np.ndarray) -> np.ndarray:
    m = len(src_a)
    src = src_a.tolist()
    dst = dst_a.tolist()
    wl = w_a.tolist()
    # Algorithm 1 line 3: count degrees.
    deg = deg_a.tolist()
    # PowerGraph case-2 rule needs *unassigned* (remaining) degree.
    rem = list(deg)

    assignment = np.empty(m, dtype=np.int32)
    loads = [0.0] * p
    heap = [(0.0, c) for c in range(p)]  # lazy min-heap of (load, cluster)
    A: list = [None] * n                 # replica sets A(v)

    def least_global() -> int:
        while True:
            ld, c = heap[0]
            if loads[c] == ld:
                return c
            heapq.heappop(heap)

    def least_in(s) -> int:
        # deterministic argmin: lowest cluster id among minimum loads
        best, best_l = -1, float("inf")
        for c in s:
            lc = loads[c]
            if lc < best_l or (lc == best_l and c < best):
                best, best_l = c, lc
        return best

    for e in range(m):
        u, v = src[e], dst[e]
        Au, Av = A[u], A[v]
        we = wl[e]

        if not Au and not Av:
            # Case 4: both empty -> least loaded of all p clusters.
            c = least_global()
        elif not Av:
            # Case 3 (A(u) nonempty only).
            c = least_in(Au)
            if loads[c] >= bound:
                c = least_global()
        elif not Au:
            c = least_in(Av)
            if loads[c] >= bound:
                c = least_global()
        else:
            inter = Au & Av
            if inter:
                # Case 1: intersection nonempty.
                c = least_in(inter)
                if loads[c] >= bound:
                    c = least_in(Au | Av)
                    if loads[c] >= bound:
                        c = least_global()
            else:
                # Case 2: both nonempty, disjoint.
                if libra_rule:
                    # Libra: favour the LOWER-degree endpoint's clusters
                    # (the higher-degree vertex is cut — Alg. 1 line 27).
                    s_set, t_set = (Au, Av) if deg[u] <= deg[v] else (Av, Au)
                else:
                    # PowerGraph: endpoint with MORE unassigned edges.
                    s_set, t_set = (Au, Av) if rem[u] >= rem[v] else (Av, Au)
                c = least_in(s_set)
                if loads[c] >= bound:
                    c = least_in(t_set)
                    if loads[c] >= bound:
                        c = least_global()

        # Algorithm 1 line 37: M(e) <- m; A(v_i) <- m; A(v_j) <- m.
        assignment[perm[e]] = c
        nl = loads[c] + we
        loads[c] = nl
        heapq.heappush(heap, (nl, c))
        if Au is None:
            A[u] = {c}
        else:
            Au.add(c)
        if Av is None:
            A[v] = {c}
        else:
            Av.add(c)
        rem[u] -= 1
        rem[v] -= 1

    return assignment


# ---------------------------------------------------------------------- #
# fast engine: flat arrays + packed bitmask replica sets
# ---------------------------------------------------------------------- #
def _stream_fast(n: int, p: int, src: np.ndarray, dst: np.ndarray,
                 w: np.ndarray, deg: np.ndarray, bound: float,
                 libra_rule: bool, perm: np.ndarray,
                 backend: str) -> np.ndarray:
    m = len(src)
    if libra_rule:
        # Libra's case-2 rule compares static degrees, so the endpoint
        # order can be pre-swapped once, vectorized: A(su) is tried first.
        swap = deg[src] > deg[dst]
        su = np.ascontiguousarray(np.where(swap, dst, src), dtype=np.int32)
        sv = np.ascontiguousarray(np.where(swap, src, dst), dtype=np.int32)
    else:
        su = np.ascontiguousarray(src, dtype=np.int32)
        sv = np.ascontiguousarray(dst, dtype=np.int32)
    rule_pg = 0 if libra_rule else 1

    limbs = (p + 63) // 64
    loads = np.zeros(p, dtype=np.float64)
    masks = np.zeros(n * limbs, dtype=np.uint64)  # A(v) bitmask limb rows
    rem = deg.astype(np.int64, copy=True)
    out = np.empty(m, dtype=np.int32)

    run = _seed_case4(su, sv, w, p, loads, masks, rem, out, limbs,
                      bool(rule_pg))

    engine = None
    if backend in ("fast", "native"):
        engine = native_engine()
        if engine is None and backend == "native":
            raise RuntimeError(
                "native backend requested but no C compiler is available "
                "(or REPRO_NO_NATIVE is set); use backend='fast'")
    if engine is not None:
        with obs.span("cut.stream", engine="native", edges=m):
            engine(run, m, su, sv, w, p, rule_pg, bound, loads, masks,
                   limbs, rem, out)
    else:
        with obs.span("cut.stream", engine="python", edges=m):
            _stream_python(run, m, su, sv, w, p, rule_pg, bound, loads,
                           masks, limbs, rem, out)

    assignment = np.empty(m, dtype=np.int32)
    assignment[perm] = out
    return assignment


def _seed_case4(su: np.ndarray, sv: np.ndarray, w: np.ndarray, p: int,
                loads: np.ndarray, masks: np.ndarray, rem: np.ndarray,
                out: np.ndarray, limbs: int, rule_pg: bool) -> int:
    """Batched Case-4 seeding: the leading run of edges touching only
    fresh vertices goes to clusters 0..run-1 in one vectorized step.

    Exact because before cluster `i` is seeded, clusters i..p-1 all carry
    load 0 and the lazy heap breaks ties by lowest id — the sequential
    engine would pick exactly cluster i (weights must be positive so a
    seeded cluster can never drop back below an untouched one).
    """
    m = len(su)
    cap = min(p, m)
    if cap == 0:
        return 0
    ends = np.empty(2 * cap, dtype=np.int64)
    ends[0::2] = su[:cap]
    ends[1::2] = sv[:cap]
    order = np.argsort(ends, kind="stable")
    se = ends[order]
    dup = se[1:] == se[:-1]
    if dup.any():
        # a repeated vertex is no longer fresh: its second occurrence
        # (and everything after) is left to the streaming engine
        second = np.maximum(order[1:][dup], order[:-1][dup])
        run = int(second.min()) // 2
    else:
        run = cap
    if run:
        pos = w[:run] > 0
        if not pos.all():
            run = int(np.argmin(pos))
    if run == 0:
        return 0
    cs = np.arange(run, dtype=np.int64)
    loads[:run] = w[:run]
    bit = np.uint64(1) << (cs % 64).astype(np.uint64)
    masks[su[:run].astype(np.int64) * limbs + cs // 64] |= bit
    masks[sv[:run].astype(np.int64) * limbs + cs // 64] |= bit
    out[:run] = cs
    if rule_pg:
        np.subtract.at(rem, su[:run], 1)
        np.subtract.at(rem, sv[:run], 1)
    return run


def _stream_python(start: int, m: int, su_a: np.ndarray, sv_a: np.ndarray,
                   w_a: np.ndarray, p: int, rule_pg: int, bound: float,
                   loads_a: np.ndarray, masks: np.ndarray, limbs: int,
                   rem_a: np.ndarray, out: np.ndarray,
                   writeback: bool = False) -> None:
    """Pure-Python fast engine (fallback when the C kernel is absent).

    Same decisions as the reference loop, with the structural costs
    stripped: the stream starts after the batched Case-4 seeding, the
    Libra endpoint order is pre-swapped so the degree rule is branch-free,
    and the global argmin uses a fixed-size lazy lower-bound heap (an
    entry is a stale lower bound refreshed when it surfaces — valid
    because loads only grow) instead of one heap push per edge into an
    ever-growing heap.

    With `writeback=True` the final loads / remaining degrees / replica
    bitmasks are re-encoded into the caller's arrays so the stream is
    resumable (`ShardCutState.stream_chunk`); the one-shot `_stream_fast`
    path skips that O(n) epilogue because only `out` is consumed.
    """
    n = len(rem_a)
    loads = loads_a.tolist()
    A: list = [None] * n
    if start or masks.any():
        # decode existing replica bitmasks: present after the batched
        # Case-4 seeding, and on every resumed ShardCutState chunk
        rows = masks.reshape(n, limbs)
        for v in np.flatnonzero(rows.any(axis=1)).tolist():
            # '<u8' pins the limb layout so the decode also holds on
            # big-endian hosts
            x = int.from_bytes(rows[v].astype("<u8").tobytes(), "little")
            s = set()
            while x:
                b = x & -x
                s.add(b.bit_length() - 1)
                x ^= b
            A[v] = s
    rem = rem_a.tolist()
    su = su_a[start:].tolist()
    sv = sv_a[start:].tolist()
    wl = w_a[start:].tolist()

    heap = [(loads[c], c) for c in range(p)]
    heapq.heapify(heap)
    heapreplace = heapq.heapreplace
    res = [0] * (m - start)
    inf = float("inf")

    def least_in(s) -> int:
        # deterministic argmin: lowest cluster id among minimum loads
        best, best_l = -1, inf
        for c in s:
            lc = loads[c]
            if lc < best_l or (lc == best_l and c < best):
                best, best_l = c, lc
        return best

    def least_global() -> int:
        while True:
            ld, c = heap[0]
            if loads[c] == ld:
                return c
            heapreplace(heap, (loads[c], c))

    i = 0
    for u, v, we in zip(su, sv, wl):
        Au = A[u]
        Av = A[v]
        if Au:
            if Av:
                inter = Au & Av
                if inter:                            # case 1
                    c = least_in(inter)
                    if loads[c] >= bound:
                        c = least_in(Au | Av)
                        if loads[c] >= bound:
                            c = least_global()
                else:                                # case 2
                    if rule_pg and rem[u] < rem[v]:
                        s_set, t_set = Av, Au
                    else:                            # libra order pre-swapped
                        s_set, t_set = Au, Av
                    c = least_in(s_set)
                    if loads[c] >= bound:
                        c = least_in(t_set)
                        if loads[c] >= bound:
                            c = least_global()
            else:                                    # case 3
                c = least_in(Au)
                if loads[c] >= bound:
                    c = least_global()
        elif Av:                                     # case 3'
            c = least_in(Av)
            if loads[c] >= bound:
                c = least_global()
        else:                                        # case 4
            c = least_global()
            nl = loads[c] + we
            loads[c] = nl
            heapreplace(heap, (nl, c))
            A[u] = {c}
            A[v] = {c} if u != v else A[u]
            if rule_pg:
                rem[u] -= 1
                rem[v] -= 1
            res[i] = c
            i += 1
            continue

        loads[c] += we
        if Au is None:
            A[u] = {c}
        else:
            Au.add(c)
        Av = A[v]
        if Av is None:
            A[v] = {c}
        else:
            Av.add(c)
        if rule_pg:
            rem[u] -= 1
            rem[v] -= 1
        res[i] = c
        i += 1

    out[start:] = res
    if writeback:
        loads_a[:] = loads
        rem_a[:] = rem
        rows = masks.reshape(n, limbs)
        nbytes = limbs * 8
        for v, a in enumerate(A):
            if a:
                x = 0
                for c in a:
                    x |= 1 << c
                rows[v] = np.frombuffer(x.to_bytes(nbytes, "little"),
                                        dtype="<u8")


def _finalize(g: IRGraph, method: str, p: int, lam: float,
              assignment: np.ndarray, backend: str,
              device: "torch.device | None") -> VertexCutResult:
    with obs.span("cut.finalize", backend=backend):
        return _finalize_impl(g, method, p, lam, assignment, backend, device)


def _finalize_impl(g: IRGraph, method: str, p: int, lam: float,
                   assignment: np.ndarray, backend: str,
                   device: "torch.device | None") -> VertexCutResult:
    if backend == "cuda":
        # replica CSR, loads and edge counts on `device`; keyed_sum's
        # stable sort reproduces np.bincount's accumulation order, so all
        # three are bit-identical to the numpy branch below
        a = cuda_metrics.as_tensor(assignment, torch.int64, device)
        ip, fl = cuda_metrics.replica_csr(g.n, p, g.src, g.dst, a, device)
        w = cuda_metrics.as_tensor(g.w, torch.float64, device)
        indptr, flat = ip.cpu().numpy(), fl.cpu().numpy()
        loads = keyed_sum(a, w, p).cpu().numpy()
        counts = keyed_sum(a, torch.ones_like(a), p).cpu().numpy()
    else:
        indptr, flat = replica_csr(g.n, p, g.src, g.dst, assignment)
        loads = np.bincount(assignment, weights=g.w,
                            minlength=p).astype(np.float64)
        counts = np.bincount(assignment, minlength=p).astype(np.int64)
    return VertexCutResult(
        graph_name=g.name, method=method, p=p, lam=lam,
        assignment=assignment, loads=loads,
        edge_counts=counts, n_vertices=g.n, total_weight=g.total_weight,
        replica_indptr=indptr, replica_flat=flat)
