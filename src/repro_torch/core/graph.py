"""Weighted directed dataflow-graph representation (the LLVM-IR-graph analogue).

The paper's object of study is G = (V, E, W): vertices are IR instructions,
edges are dynamic data dependencies, and edge weights are measured memory-op
times.  Here the same structure is built from traced benchmark programs
(`core.benchgraphs`), synthetically (`core.powerlaw`), or read from an `.npz`
snapshot.  Storage is flat numpy arrays (an edge list + lazily built CSR
adjacency) so graphs with millions of edges stay cheap.  The arrays and the
`.npz` layout are those of the JAX package's `IRGraph`, so snapshots move
between the two packages unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from ._arrayops import csr_adjacency

__all__ = ["IRGraph", "from_reference_arrays"]


@dataclasses.dataclass
class IRGraph:
    """Edge-list weighted digraph.

    Attributes:
      n: number of vertices (ids are 0..n-1).
      src, dst: int32[|E|] edge endpoints, in *trace order* (the paper streams
        edges in program order; greedy placement quality depends on it).
      w: float64[|E|] edge weights (estimated memory-op time / bytes moved).
      name: label used in reports.
      node_labels: optional per-vertex labels (e.g. traced op names).
    """

    n: int
    src: np.ndarray
    dst: np.ndarray
    w: np.ndarray
    name: str = "graph"
    node_labels: Sequence[str] | None = None

    def __post_init__(self):
        self.src = np.asarray(self.src, dtype=np.int32)
        self.dst = np.asarray(self.dst, dtype=np.int32)
        self.w = np.asarray(self.w, dtype=np.float64)
        if not (len(self.src) == len(self.dst) == len(self.w)):
            raise ValueError("src/dst/w must have equal length")
        if len(self.src) and (self.src.min() < 0 or
                              max(self.src.max(), self.dst.max()) >= self.n):
            raise ValueError("edge endpoint out of range")
        self._degree_cache: np.ndarray | None = None

    # ------------------------------------------------------------------ #
    # basic properties
    # ------------------------------------------------------------------ #
    @property
    def num_edges(self) -> int:
        return int(len(self.src))

    @property
    def num_vertices(self) -> int:
        return int(self.n)

    @property
    def total_weight(self) -> float:
        return float(self.w.sum())

    @property
    def avg_weight(self) -> float:
        return float(self.w.mean()) if len(self.w) else 0.0

    def degrees(self) -> np.ndarray:
        """Total (in+out) degree per vertex — the d_i of Algorithm 1 line 3."""
        if self._degree_cache is None:
            deg = np.bincount(self.src, minlength=self.n)
            deg += np.bincount(self.dst, minlength=self.n)
            self._degree_cache = deg.astype(np.int64)
        return self._degree_cache

    # ------------------------------------------------------------------ #
    # power-law statistics (paper §2, Table 4)
    # ------------------------------------------------------------------ #
    def power_law_alpha(self, d_min: int = 1) -> float:
        """MLE estimate of the power-law exponent alpha of the degree dist.

        Discrete MLE (Clauset et al.): alpha ≈ 1 + n / sum(ln(d / (d_min - .5))).
        """
        d = self.degrees()
        d = d[d >= d_min]
        if len(d) == 0:
            return float("nan")
        return float(1.0 + len(d) / np.log(d / (d_min - 0.5)).sum())

    def degree_histogram(self) -> tuple[np.ndarray, np.ndarray]:
        d = self.degrees()
        vals, counts = np.unique(d[d > 0], return_counts=True)
        return vals, counts

    def stats(self) -> dict:
        return {
            "name": self.name,
            "nodes": self.num_vertices,
            "edges": self.num_edges,
            "alpha": round(self.power_law_alpha(), 3),
            "total_weight": self.total_weight,
            "max_degree": int(self.degrees().max()) if self.n else 0,
        }

    # ------------------------------------------------------------------ #
    # adjacency / construction helpers
    # ------------------------------------------------------------------ #
    def csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Undirected CSR adjacency: (indptr, neighbor ids, edge ids)."""
        return csr_adjacency(self.n, self.src, self.dst)

    @classmethod
    def from_edges(cls, edges: Iterable[tuple[int, int, float]],
                   name: str = "graph", n: int | None = None) -> "IRGraph":
        e = list(edges)
        if e:
            src, dst, w = map(np.asarray, zip(*e))
        else:
            src = dst = w = np.zeros(0)
        n = int(n if n is not None else (max(src.max(), dst.max()) + 1 if len(e) else 0))
        return cls(n=n, src=src, dst=dst, w=w, name=name)

    def permuted_edges(self, seed: int = 0) -> "IRGraph":
        """Randomly permute edge stream order (for robustness experiments)."""
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self.num_edges)
        return IRGraph(self.n, self.src[perm], self.dst[perm], self.w[perm],
                       name=f"{self.name}/shuffled")

    def save_npz(self, path: str) -> None:
        np.savez_compressed(path, n=self.n, src=self.src, dst=self.dst,
                            w=self.w, name=self.name)

    @classmethod
    def load_npz(cls, path: str) -> "IRGraph":
        z = np.load(path, allow_pickle=False)
        return cls(n=int(z["n"]), src=z["src"], dst=z["dst"], w=z["w"],
                   name=str(z["name"]))


def from_reference_arrays(n: int, src: np.ndarray, dst: np.ndarray,
                          w: np.ndarray, name: str = "graph") -> IRGraph:
    """An `IRGraph` over the arrays of another package's graph, unchanged.

    The one hand-over point from the JAX package's `IRGraph` (its `n`,
    `src`, `dst`, `w`, `name`): the arrays keep their dtypes and values,
    so both packages partition the very same edge stream.
    """
    return IRGraph(n=int(n), src=src, dst=dst, w=w, name=str(name))
