"""Plan a graph: WB-Libra cut, Algorithm-2 mapping, simulated cost.

`plan_graph` is the planner's graph half: partition an `IRGraph` (or a
path to an `.npz` snapshot, a `.rtb` container or an NDJSON trace), map
the clusters with the memory-centric mapper, and return the simulated
cost.  The program-capture half of the JAX
package's planner (`plan_step`, `optimal_parallelism`,
`expert_placement`, `mesh_device_order`) needs a graph built from a
traced program, and is still to be ported (ROADMAP.md, queue 1,
item 5).
"""
from __future__ import annotations

import dataclasses
import os

from .. import obs
from .cuda import resolve_device
from .graph import IRGraph
from .mapping import (Machine, cluster_interaction_graphs,
                      memory_centric_mapping, resolve_mapping_backend)
from .simulator import coerce_graph, simulate, vertex_bytes_model
from .vertex_cut import VertexCutResult, vertex_cut

__all__ = ["PlanReport", "plan_graph"]


@dataclasses.dataclass
class PlanReport:
    graph: IRGraph
    cut: VertexCutResult
    exec_time: float
    comm_bytes: float
    p: int

    def summary(self) -> dict:
        return {
            "graph": self.graph.name, "p": self.p,
            "replication_factor": round(self.cut.replication_factor, 3),
            "edge_weight_imbalance":
                round(self.cut.edge_weight_imbalance, 4),
            "est_exec_time": self.exec_time,
            "est_comm_bytes": self.comm_bytes,
        }


def plan_graph(g, p: int, method: str = "wb_libra",
               lam: float = 1.0, machine: Machine | None = None,
               backend: str = "cuda", workers: int = 1,
               merge_period: "int | None" = None,
               divergence: "float | None" = None,
               device: str = "cuda") -> PlanReport:
    """Plan `g` — an `IRGraph`, or a path to an `.npz` snapshot, a
    `.rtb` binary trace or an NDJSON dynamic trace (`coerce_graph`).
    `backend` threads through every stage
    ("cuda"/"fast"/"native"/"python"/"reference"); "cuda", the default,
    keeps the finalize/metrics/simulator reductions on `device` (the
    card unless the caller passes `device="cpu"`), and "dist" runs the
    sharded streaming partitioner (`repro_torch.dist`, on the host) on
    `workers` workers, ingesting trace paths through the parallel parse
    front end (`workers=1` is bit-identical to "fast").  The host
    backends ignore `device`."""
    map_backend = resolve_mapping_backend(backend)
    dev = resolve_device(device) if backend == "cuda" else None
    with obs.span("plan.cut", cat="section", backend=backend, p=p):
        if backend == "dist":
            if isinstance(g, (str, os.PathLike)) \
                    and not os.fspath(g).endswith(".npz"):
                from ..dist import dist_ingest
                g = dist_ingest(g, workers=workers)
            g = coerce_graph(g)
            from ..dist import dist_vertex_cut
            cut = dist_vertex_cut(g, p, method=method, lam=lam,
                                  workers=workers, merge_period=merge_period,
                                  divergence=divergence)
        else:
            g = coerce_graph(g)
            cut = vertex_cut(g, p, method=method, lam=lam, backend=backend,
                             device=dev)
    with obs.span("plan.map", cat="section", backend=map_backend):
        comm, shared = cluster_interaction_graphs(
            cut, p, vertex_bytes_model(g), backend=map_backend, device=dev)
        mapping = memory_centric_mapping(comm, shared,
                                         machine or Machine.for_clusters(p),
                                         backend=map_backend)
    with obs.span("plan.simulate", cat="section", backend=map_backend):
        rep = simulate(g, cut, mapping, backend=map_backend, device=dev)
    return PlanReport(graph=g, cut=cut, exec_time=rep.exec_time,
                      comm_bytes=rep.data_comm_bytes, p=p)
