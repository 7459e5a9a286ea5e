"""Edge-cut baselines the paper compares against (§6.1).

  compnet — community-detection-inspired partitioner of [Xiao et al. 2017]:
            weighted label propagation finds communities, which are then
            packed into p balanced clusters (LPT).  Low cut, weaker balance.
  metis   — METIS-style multilevel edge cut [LaSalle et al. 2015]:
            heavy-edge-matching coarsening, LPT initial partition of the
            coarsest graph, then boundary-refinement (FM-lite) during
            uncoarsening.  Strong balance, more cut edges on power-law
            graphs — exactly the failure mode the paper exploits.

Both return an `EdgeCutResult` (vertex → cluster).  In an edge-cut
partition the inter-cluster traffic is the weight of *all* cut edges
(paper §6.2.4), unlike the vertex cut whose only traffic is replica sync.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ._arrayops import csr_adjacency, dedup_edges
from .graph import IRGraph

__all__ = ["EdgeCutResult", "edge_cut", "EDGE_CUT_METHODS"]

EDGE_CUT_METHODS = ("compnet", "metis")


@dataclasses.dataclass
class EdgeCutResult:
    graph_name: str
    method: str
    p: int
    parts: np.ndarray            # int32[|V|] vertex -> cluster
    loads: np.ndarray            # float64[p]: Σ w_e of edges owned by cluster
    cut_weight: float            # Σ w_e over inter-cluster edges
    cut_edges: int
    total_weight: float

    @property
    def edge_weight_imbalance(self) -> float:
        ideal = self.total_weight / self.p
        return float(self.loads.max() / ideal) if ideal > 0 else 1.0

    def cross_traffic(self) -> float:
        """Bytes moved between clusters = weight of cut edges."""
        return self.cut_weight

    def summary(self) -> dict:
        return {
            "graph": self.graph_name, "method": self.method, "p": self.p,
            "cut_weight": round(self.cut_weight, 2),
            "cut_edges": self.cut_edges,
            "edge_weight_imbalance": round(self.edge_weight_imbalance, 6),
        }


# ---------------------------------------------------------------------- #
def edge_cut(g: IRGraph, p: int, method: str = "metis",
             seed: int = 0) -> EdgeCutResult:
    if method == "compnet":
        parts = _compnet(g, p, seed)
    elif method == "metis":
        parts = _metis_like(g, p, seed)
    else:
        raise ValueError(f"unknown edge-cut method {method!r}")
    return _finalize(g, method, p, parts)


def _finalize(g: IRGraph, method: str, p: int,
              parts: np.ndarray) -> EdgeCutResult:
    parts = parts.astype(np.int32)
    cross = parts[g.src] != parts[g.dst]
    cut_w = float(g.w[cross].sum())
    # Work ownership: an edge is executed where its consumer (dst) lives.
    loads = np.zeros(p, dtype=np.float64)
    np.add.at(loads, parts[g.dst], g.w)
    return EdgeCutResult(graph_name=g.name, method=method, p=p, parts=parts,
                         loads=loads, cut_weight=cut_w,
                         cut_edges=int(cross.sum()),
                         total_weight=g.total_weight)


# ---------------------------------------------------------------------- #
# CompNet: weighted label propagation -> LPT packing
# ---------------------------------------------------------------------- #
def _compnet(g: IRGraph, p: int, seed: int, sweeps: int = 8) -> np.ndarray:
    rng = np.random.default_rng(seed)
    indptr, nbr, eid = g.csr()
    ew = g.w
    labels = np.arange(g.n, dtype=np.int64)
    order = np.arange(g.n)
    for _ in range(sweeps):
        rng.shuffle(order)
        changed = 0
        for v in order:
            lo, hi = indptr[v], indptr[v + 1]
            if lo == hi:
                continue
            ls = labels[nbr[lo:hi]]
            ws = ew[eid[lo:hi]]
            # adopt the label with the largest incident weight
            uniq, inv = np.unique(ls, return_inverse=True)
            scores = np.zeros(len(uniq))
            np.add.at(scores, inv, ws)
            best = uniq[int(np.argmax(scores))]
            if best != labels[v]:
                labels[v] = best
                changed += 1
        if changed == 0:
            break
    # pack communities into p clusters by vertex work (LPT)
    comm_ids, comm_inv = np.unique(labels, return_inverse=True)
    vwork = np.zeros(g.n)
    np.add.at(vwork, g.dst, g.w)     # consumer-side work
    cwork = np.zeros(len(comm_ids))
    np.add.at(cwork, comm_inv, vwork)
    order = np.argsort(-cwork)
    cluster_of_comm = np.zeros(len(comm_ids), dtype=np.int32)
    loads = np.zeros(p)
    for c in order:
        tgt = int(np.argmin(loads))
        cluster_of_comm[c] = tgt
        loads[tgt] += cwork[c]
    return cluster_of_comm[comm_inv]


# ---------------------------------------------------------------------- #
# METIS-like multilevel edge cut
# ---------------------------------------------------------------------- #
def _metis_like(g: IRGraph, p: int, seed: int,
                coarsest: int | None = None) -> np.ndarray:
    coarsest = coarsest or max(4 * p, 256)
    rng = np.random.default_rng(seed)

    # Work per vertex (balance target), collapsed during coarsening.
    vwork = np.zeros(g.n)
    np.add.at(vwork, g.dst, g.w)
    vwork += 1e-9  # keep isolated vertices movable

    n, src, dst, w, work = g.n, g.src.copy(), g.dst.copy(), g.w.copy(), vwork
    graphs = [(n, src, dst, w, work)]   # level 0 = finest
    matches: list[np.ndarray] = []      # match[i]: level i ids -> level i+1
    while n > coarsest:
        match = _heavy_edge_matching(n, src, dst, w, rng)
        n2 = int(match.max()) + 1
        if n2 >= n * 0.98:  # insufficient progress
            break
        s2, d2 = match[src], match[dst]
        keep = s2 != d2
        s2, d2, w2 = dedup_edges(n2, s2[keep], d2[keep], w[keep])
        work2 = np.zeros(n2)
        np.add.at(work2, match, work)
        matches.append(match)
        n, src, dst, w, work = n2, s2, d2, w2, work2
        graphs.append((n, src, dst, w, work))

    parts = _lpt_initial(n, src, dst, w, work, p, rng)
    parts = _refine(n, src, dst, w, work, parts, p)

    # project back through the levels, refining at each
    for lvl in range(len(matches) - 1, -1, -1):
        parts = parts[matches[lvl]]
        n, src, dst, w, work = graphs[lvl]
        parts = _refine(n, src, dst, w, work, parts, p, passes=1)
    return parts


def _heavy_edge_matching(n, src, dst, w, rng) -> np.ndarray:
    order = np.argsort(-w, kind="stable")
    matched = np.full(n, -1, dtype=np.int64)
    nxt = 0
    for e in order:
        u, v = int(src[e]), int(dst[e])
        if matched[u] < 0 and matched[v] < 0 and u != v:
            matched[u] = matched[v] = nxt
            nxt += 1
    for v in range(n):
        if matched[v] < 0:
            matched[v] = nxt
            nxt += 1
    return matched


def _lpt_initial(n, src, dst, w, work, p, rng) -> np.ndarray:
    order = np.argsort(-work)
    parts = np.zeros(n, dtype=np.int32)
    loads = np.zeros(p)
    for v in order:
        tgt = int(np.argmin(loads))
        parts[v] = tgt
        loads[tgt] += work[v]
    return parts


def _refine(n, src, dst, w, work, parts, p, passes: int = 3,
            balance_tol: float = 1.08) -> np.ndarray:
    if len(src) == 0:
        return parts
    indptr, nbr, eid = csr_adjacency(n, src, dst)
    ew = w
    loads = np.zeros(p)
    np.add.at(loads, parts, work)
    ideal = loads.sum() / p
    for _ in range(passes):
        moved = 0
        boundary = np.unique(np.concatenate(
            [src[parts[src] != parts[dst]], dst[parts[src] != parts[dst]]]))
        for v in boundary:
            lo, hi = indptr[v], indptr[v + 1]
            if lo == hi:
                continue
            cur = parts[v]
            ls = parts[nbr[lo:hi]]
            ws = ew[eid[lo:hi]]
            uniq, inv = np.unique(ls, return_inverse=True)
            gain = np.zeros(len(uniq))
            np.add.at(gain, inv, ws)
            internal = gain[uniq == cur].sum() if (uniq == cur).any() else 0.0
            best_gain, best_t = 0.0, cur
            for t, gsum in zip(uniq, gain):
                if t == cur:
                    continue
                if loads[t] + work[v] > balance_tol * ideal:
                    continue
                dg = gsum - internal
                if dg > best_gain:
                    best_gain, best_t = dg, int(t)
            if best_t != cur:
                loads[cur] -= work[v]
                loads[best_t] += work[v]
                parts[v] = best_t
                moved += 1
        if moved == 0:
            break
    return parts
