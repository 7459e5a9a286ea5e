"""Persistent content-addressed plan cache on `checkpoint.store`.

Layout: one `CheckpointManager` directory per fingerprint —

    <root>/<fingerprint>/step_00000000/shard_0.npz + meta.json + COMMIT

The bundle's arrays (assignment, loads, replica CSR, core placement,
core times) ride in the npz shard; its scalars (exec_time, comm bytes,
graph shape, knobs) ride in the JSON metadata.  Reusing the checkpoint
store buys the crash-recovery contract for free: a plan is visible only
after the atomic COMMIT+rename, a crash mid-write leaves a stale `.tmp`
that the next manager GCs, and restarts are warm — a new service over
the same root serves every previously-planned fingerprint from disk.

An in-memory hot map (fingerprint -> bundle) sits in front of the disk
layer so repeat hits are dictionary lookups.  The hot map is LRU-bounded
(``max_entries`` / ``max_bytes``): a long-lived service over an
unbounded request universe must not grow without limit, and an evicted
bundle is never lost — it reloads from the checkpoint store on the next
request.  Evictions are counted into the owning service's metrics
registry when one is injected.
"""
from __future__ import annotations

import collections
import dataclasses
import os

import numpy as np

from .. import obs
from ..checkpoint.store import CheckpointManager

__all__ = ["PlanBundle", "PlanCache"]

_ARRAY_FIELDS = ("assignment", "loads", "edge_counts", "replica_indptr",
                 "replica_flat", "core_of", "core_times")


@dataclasses.dataclass
class PlanBundle:
    """The persisted outcome of one planning run: (partition, mapping,
    simulated cost) — everything a deployment needs, nothing that would
    require re-running the pipeline."""

    # partition (VertexCutResult essentials)
    assignment: np.ndarray          # int32[|E|] -> cluster id
    loads: np.ndarray               # float64[p]
    edge_counts: np.ndarray         # int64[p]
    replica_indptr: np.ndarray      # int64[|V|+1]
    replica_flat: np.ndarray        # int32[Σ|A(v)|]
    # mapping
    core_of: np.ndarray             # int[p] -> core id
    # simulation
    core_times: np.ndarray          # float64[n_cores]
    exec_time: float
    comm_bytes: float
    # identity
    graph_name: str
    n_vertices: int
    total_weight: float
    p: int
    method: str
    lam: float

    @property
    def replication_factor(self) -> float:
        return len(self.replica_flat) / max(1, self.n_vertices)

    def summary(self) -> dict:
        return {
            "graph": self.graph_name, "p": self.p, "method": self.method,
            "lam": self.lam,
            "replication_factor": round(self.replication_factor, 4),
            "exec_time": self.exec_time, "comm_bytes": self.comm_bytes,
        }


class PlanCache:
    """Two-tier plan cache: LRU hot map over the checkpoint store.

    ``max_entries`` / ``max_bytes`` bound the hot map (None = unbounded);
    the least-recently-used bundle is dropped first, counted as
    ``serve.cache.evictions`` in the injected ``metrics`` registry.
    """

    def __init__(self, root: str, max_entries: "int | None" = None,
                 max_bytes: "int | None" = None, metrics=None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._hot: "collections.OrderedDict[str, PlanBundle]" = \
            collections.OrderedDict()
        self._hot_bytes = 0
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.metrics = metrics          # MetricsRegistry or None
        self.evictions = 0

    def _manager(self, fp: str) -> CheckpointManager:
        return CheckpointManager(os.path.join(self.root, fp), keep=1)

    @staticmethod
    def _bundle_nbytes(bundle: PlanBundle) -> int:
        return sum(np.asarray(getattr(bundle, k)).nbytes
                   for k in _ARRAY_FIELDS)

    def _remember(self, fp: str, bundle: PlanBundle) -> None:
        if fp in self._hot:
            self._hot.move_to_end(fp)
            return
        self._hot[fp] = bundle
        self._hot_bytes += self._bundle_nbytes(bundle)
        while self._hot and (
                (self.max_entries is not None
                 and len(self._hot) > self.max_entries)
                or (self.max_bytes is not None
                    and self._hot_bytes > self.max_bytes)):
            _old_fp, old = self._hot.popitem(last=False)
            self._hot_bytes -= self._bundle_nbytes(old)
            self.evictions += 1
            obs.counter("serve.cache_evict", 1)
            if self.metrics is not None:
                self.metrics.counter("serve.cache.evictions")

    @property
    def hot_bytes(self) -> int:
        return self._hot_bytes

    def fingerprints(self) -> list:
        """Fingerprints with a committed bundle on disk."""
        out = []
        for name in sorted(os.listdir(self.root)):
            d = os.path.join(self.root, name)
            if os.path.isdir(d) and CheckpointManager(d).all_steps():
                out.append(name)
        return out

    def get(self, fp: str) -> "PlanBundle | None":
        """Hot map, then disk; returns None on a miss."""
        bundle = self._hot.get(fp)
        if bundle is not None:
            self._hot.move_to_end(fp)       # LRU recency
            obs.counter("serve.cache_hit_memory", 1)
            return bundle
        mgr = self._manager(fp)
        if mgr.latest_step() is None:
            return None
        with obs.span("serve.cache_load", cat="op", fp=fp[:16]):
            flat, meta = mgr.restore_flat()
        bundle = PlanBundle(
            **{k: flat[k] for k in _ARRAY_FIELDS},
            exec_time=float(meta["exec_time"]),
            comm_bytes=float(meta["comm_bytes"]),
            graph_name=str(meta["graph_name"]),
            n_vertices=int(meta["n_vertices"]),
            total_weight=float(meta["total_weight"]),
            p=int(meta["p"]), method=str(meta["method"]),
            lam=float(meta["lam"]))
        self._remember(fp, bundle)
        obs.counter("serve.cache_hit_disk", 1)
        return bundle

    def put(self, fp: str, bundle: PlanBundle) -> None:
        self._remember(fp, bundle)
        flat = {k: np.asarray(getattr(bundle, k)) for k in _ARRAY_FIELDS}
        meta = {"exec_time": bundle.exec_time,
                "comm_bytes": bundle.comm_bytes,
                "graph_name": bundle.graph_name,
                "n_vertices": bundle.n_vertices,
                "total_weight": bundle.total_weight,
                "p": bundle.p, "method": bundle.method, "lam": bundle.lam}
        with obs.span("serve.cache_store", cat="op", fp=fp[:16]):
            self._manager(fp).save(0, flat, meta)
        obs.counter("serve.cache_store", 1)
