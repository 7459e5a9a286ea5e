"""The long-lived partition-plan service.

`PlanService` answers plan requests for recurring graphs/traces from a
two-tier content-addressed cache (`PlanCache`): requests fingerprint
their *content* plus result-relevant knobs (`serve.fingerprint`), hits
return the persisted (partition, mapping, cost) bundle without parsing
or cutting anything, misses run the full planning pipeline once and
persist the bundle through `checkpoint.store` — so restarts are warm
and repeat traffic (the production regime: millions of users, few
distinct programs) is served at dictionary-lookup cost.

`plan_many` batches: requests are fingerprinted up front and duplicate
fingerprints inside one batch plan once.

Every phase is instrumented through `repro_torch.obs`: cache hit/miss/store
counters, fingerprint/load/plan spans — `REPRO_PROFILE=out.json` (or
`obs.scoped()`) captures a serving profile.

Beyond the profiling-gated spans, the service owns an **always-on**
:class:`~repro_torch.obs.metrics.MetricsRegistry` (`PlanService.registry`):
per-tier request counters, hot-map eviction counts, and per-tier plan
latency histograms, summarised live by :meth:`PlanService.metrics`
(hit rate, plans/s, latency p50/p99) and surfaced by
``python -m repro_torch.serve metrics``.
"""
from __future__ import annotations

import dataclasses
import os
from time import perf_counter

from .. import obs
from ..obs.metrics import MetricsRegistry
from ..core.mapping import Machine
from ..core.simulator import coerce_graph
from ..core.vertex_cut import vertex_cut
from .cache import PlanBundle, PlanCache
from .fingerprint import plan_fingerprint
from .incremental import finish_plan

__all__ = ["PlanRequest", "PlanResponse", "PlanService",
           "DEFAULT_CACHE_DIR"]

DEFAULT_CACHE_DIR = ".cache/plans"


@dataclasses.dataclass(frozen=True)
class PlanRequest:
    """One planning request: a graph source plus the planning knobs.

    `source` is a path (NDJSON trace / `.rtb` / `.npz`) or an in-memory
    `IRGraph`.  Knobs beyond (p, method, lam, seed) that change the
    result — e.g. a non-default `edge_order` — go through the dedicated
    fields so the fingerprint stays canonical.
    """

    source: object
    p: int
    method: str = "wb_libra"
    lam: float = 1.0
    seed: int = 0
    edge_order: str = "auto"
    weight_model: str = "bytes"


@dataclasses.dataclass
class PlanResponse:
    fingerprint: str
    cache: str                      # "cold" | "memory" | "disk"
    bundle: PlanBundle

    def summary(self) -> dict:
        return {"fingerprint": self.fingerprint, "cache": self.cache,
                **self.bundle.summary()}


class PlanService:
    """Content-addressed plan cache over the full planning pipeline.

    Cold plans run `backend` ("cuda", the default: the finalize,
    interaction-graph and simulator reductions on `device`, the card
    unless the caller asks for "cpu"); the host backends ignore
    `device`.  Hits read the cache and touch neither."""

    def __init__(self, cache_dir: str = DEFAULT_CACHE_DIR,
                 backend: str = "cuda", machine: "Machine | None" = None,
                 use_stat_memo: bool = True,
                 max_hot_entries: "int | None" = None,
                 max_hot_bytes: "int | None" = None, *,
                 device: str = "cuda"):
        self.registry = MetricsRegistry()   # always on, never profiling-gated
        self.cache = PlanCache(cache_dir, max_entries=max_hot_entries,
                               max_bytes=max_hot_bytes,
                               metrics=self.registry)
        self.backend = backend
        self.device = device
        self.machine = machine
        self.use_stat_memo = use_stat_memo
        self.hits = 0
        self.misses = 0
        self._t0 = perf_counter()

    def _record(self, tier: str, us: float) -> None:
        """Per-tier request accounting into the live registry."""
        self.registry.counter(f"serve.plans.{tier}")
        self.registry.observe("serve.plan_latency_us", us)
        self.registry.observe(f"serve.plan_latency_us.{tier}", us)

    # ------------------------------------------------------------------ #
    def _fingerprint(self, req: PlanRequest) -> str:
        with obs.span("serve.fingerprint", cat="op"):
            return plan_fingerprint(
                req.source, req.p, req.method, req.lam, seed=req.seed,
                edge_order=req.edge_order, weight_model=req.weight_model,
                use_stat_memo=self.use_stat_memo)

    def _plan_cold(self, req: PlanRequest) -> PlanBundle:
        with obs.span("serve.plan_cold", cat="section", p=req.p,
                      method=req.method):
            with obs.span("plan.cut", cat="section", backend=self.backend,
                          p=req.p):
                if isinstance(req.source, (str, os.PathLike)):
                    from ..trace import load_graph
                    g = load_graph(req.source,
                                   weight_model=req.weight_model)
                else:
                    g = coerce_graph(req.source)
                cut = vertex_cut(g, req.p, method=req.method, lam=req.lam,
                                 seed=req.seed, edge_order=req.edge_order,
                                 backend=self.backend, device=self.device)
            mapping, rep = finish_plan(g, cut, self.machine, self.backend,
                                       self.device)
        return PlanBundle(
            assignment=cut.assignment, loads=cut.loads,
            edge_counts=cut.edge_counts,
            replica_indptr=cut.replica_indptr,
            replica_flat=cut.replica_flat,
            core_of=mapping.core_of, core_times=rep.core_times,
            exec_time=rep.exec_time, comm_bytes=rep.data_comm_bytes,
            graph_name=g.name, n_vertices=g.n,
            total_weight=g.total_weight, p=req.p, method=req.method,
            lam=req.lam)

    # ------------------------------------------------------------------ #
    def plan(self, req: PlanRequest) -> PlanResponse:
        """Serve one request: cache hit or cold plan + persist."""
        t0 = perf_counter()
        fp = self._fingerprint(req)
        in_memory = fp in self.cache._hot
        bundle = self.cache.get(fp)
        if bundle is not None:
            self.hits += 1
            tier = "memory" if in_memory else "disk"
            self._record(tier, (perf_counter() - t0) * 1e6)
            return PlanResponse(fingerprint=fp, cache=tier, bundle=bundle)
        self.misses += 1
        obs.counter("serve.cache_miss", 1)
        bundle = self._plan_cold(req)
        self.cache.put(fp, bundle)
        self._record("cold", (perf_counter() - t0) * 1e6)
        return PlanResponse(fingerprint=fp, cache="cold", bundle=bundle)

    def plan_many(self, requests) -> list:
        """Batched serving; duplicate fingerprints plan once."""
        requests = list(requests)
        with obs.span("serve.plan_many", cat="section",
                      requests=len(requests)):
            responses: list = [None] * len(requests)
            first_of: dict = {}
            for i, req in enumerate(requests):
                t0 = perf_counter()
                fp = self._fingerprint(req)
                prior = first_of.get(fp)
                if prior is not None:
                    # in-batch duplicate: by the time we got here the
                    # first occurrence has populated the hot map
                    self.hits += 1
                    self._record("memory", (perf_counter() - t0) * 1e6)
                    responses[i] = PlanResponse(
                        fingerprint=fp, cache="memory",
                        bundle=responses[prior].bundle)
                    continue
                first_of[fp] = i
                in_memory = fp in self.cache._hot
                bundle = self.cache.get(fp)
                if bundle is not None:
                    self.hits += 1
                    tier = "memory" if in_memory else "disk"
                    self._record(tier, (perf_counter() - t0) * 1e6)
                    responses[i] = PlanResponse(fingerprint=fp, cache=tier,
                                                bundle=bundle)
                    continue
                self.misses += 1
                obs.counter("serve.cache_miss", 1)
                bundle = self._plan_cold(requests[i])
                self.cache.put(fp, bundle)
                self._record("cold", (perf_counter() - t0) * 1e6)
                responses[i] = PlanResponse(fingerprint=fp, cache="cold",
                                            bundle=bundle)
        return responses

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "hot_entries": len(self.cache._hot),
                "hot_bytes": self.cache.hot_bytes,
                "evictions": self.cache.evictions,
                "disk_entries": len(self.cache.fingerprints()),
                "cache_dir": self.cache.root}

    def metrics(self) -> dict:
        """Live serving metrics from the always-on registry: request
        counts by tier, cache hit rate, sustained plans/s since service
        start, and plan-latency p50/p99 (overall and per tier)."""
        snap = self.registry.snapshot()
        total = self.hits + self.misses
        elapsed = max(perf_counter() - self._t0, 1e-9)
        lat = snap["histograms"].get("serve.plan_latency_us")
        tiers = {}
        for tier in ("memory", "disk", "cold"):
            h = snap["histograms"].get(f"serve.plan_latency_us.{tier}")
            if h is not None:
                tiers[tier] = {"count": h["count"], "p50_us": h["p50"],
                               "p99_us": h["p99"]}
        return {
            "plans": total,
            "plans_per_s": round(total / elapsed, 3),
            "uptime_s": round(elapsed, 3),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
            "evictions": self.cache.evictions,
            "hot_entries": len(self.cache._hot),
            "hot_bytes": self.cache.hot_bytes,
            "plan_latency_p50_us": lat["p50"] if lat else 0.0,
            "plan_latency_p99_us": lat["p99"] if lat else 0.0,
            "tiers": tiers,
        }
