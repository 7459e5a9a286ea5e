"""Power-law graph synthesis + the paper's random-cut theory (Eq. 4–10).

Two roles:
  * generate synthetic Zipf-degree graphs used by property tests and the
    replication-factor benchmark (paper Fig. 8 plots the Eq. 10 curve as the
    theoretical upper bound for the greedy algorithms);
  * closed-form expectations for the random weighted vertex cut.
"""
from __future__ import annotations

import numpy as np

from .graph import IRGraph

__all__ = [
    "zipf_degrees",
    "synthesize_powerlaw_graph",
    "expected_replication_random",
    "expected_replication_random_empirical",
]


def zipf_degrees(n: int, alpha: float, d_max: int | None = None,
                 seed: int = 0) -> np.ndarray:
    """Sample n vertex degrees from the truncated Zipf P(d) ∝ d^-alpha."""
    d_max = d_max or max(2, n - 1)
    rng = np.random.default_rng(seed)
    d = np.arange(1, d_max + 1, dtype=np.float64)
    pmf = d ** (-alpha)
    pmf /= pmf.sum()
    return rng.choice(np.arange(1, d_max + 1), size=n, p=pmf)


def synthesize_powerlaw_graph(n: int, alpha: float, seed: int = 0,
                              weight_cv: float = 1.0,
                              name: str | None = None) -> IRGraph:
    """Chung-Lu style generator: endpoints drawn ∝ target degree.

    Edge weights model memory-op times: log-normal (heavy-tailed, like
    cache-hit vs. DRAM-miss latencies), scaled so the mean is 1.0.
    """
    rng = np.random.default_rng(seed)
    deg = zipf_degrees(n, alpha, seed=seed).astype(np.float64)
    m = max(1, int(deg.sum() // 2))
    p = deg / deg.sum()
    src = rng.choice(n, size=m, p=p).astype(np.int32)
    dst = rng.choice(n, size=m, p=p).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    sigma = np.sqrt(np.log1p(weight_cv ** 2))
    w = rng.lognormal(mean=-sigma ** 2 / 2, sigma=sigma, size=len(src))
    return IRGraph(n=n, src=src, dst=dst, w=w,
                   name=name or f"powerlaw(n={n},a={alpha})")


def _zipf_norm(n: int, alpha: float) -> float:
    d = np.arange(1, n, dtype=np.float64)
    return float((d ** (-alpha)).sum())


def expected_replication_random(n_vertices: int, alpha: float,
                                p: int) -> float:
    """Paper Eq. (10): E[ 1/|V| Σ_v |A(v)| ] for the random weighted cut.

        p - p / h_|V|(alpha) * Σ_{d=1}^{|V|-1} ((p-1)/p)^d d^-alpha
    """
    if n_vertices < 2:
        return 1.0
    d = np.arange(1, n_vertices, dtype=np.float64)
    h = (d ** (-alpha)).sum()
    # ((p-1)/p)^d underflows gracefully for large d.
    s = (((p - 1.0) / p) ** d * d ** (-alpha)).sum()
    return float(p - p / h * s)


def expected_replication_random_empirical(degrees: np.ndarray,
                                          p: int) -> float:
    """Eq. (6) averaged over the *empirical* degree sequence:

        1/|V| Σ_v p (1 - (1 - 1/p)^D[v])

    A tighter bound than Eq. (10) when the graph's degrees are known.
    """
    d = np.asarray(degrees, dtype=np.float64)
    d = np.maximum(d, 0.0)
    return float(np.mean(p * (1.0 - (1.0 - 1.0 / p) ** d)))
