"""The planner: plan a graph, place MoE experts, order a mesh.

The port of `repro.core.planner`:

  1. `plan_graph` — partition an `IRGraph` (or a path to an `.npz`
     snapshot, a `.rtb` container or an NDJSON trace) with WB-Libra, map
     the clusters with the memory-centric mapper and return the
     simulated cost; `plan_step` / `optimal_parallelism` capture a
     PyTorch step function to an IR graph (`core.op_graph`) and plan it,
     the paper's "discover the optimal parallelization degree" applied
     to PyTorch programs.
  2. `expert_placement` — Weight Balanced Vertex Cut over the expert
     co-activation graph: experts are vertices, co-routed token pairs
     weighted edges, and the cut's replica sets A(expert) give an
     expert→device placement in which hot experts are replicated across
     EP shards and the per-device routed-token load is λ-balanced;
     `naive_expert_placement` is the contiguous layout it is compared
     with.
  3. `mesh_device_order` — Algorithm-2 mapping of model shards onto a
     device mesh, so that heavily-communicating shards are neighbours.

Items 2 and 3 are host numpy over `vertex_cut` and
`memory_centric_mapping`; `expert_placement`'s cut runs its finalize
on the card with `backend="cuda"` (the default).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from .. import obs
from .cuda import resolve_device
from .graph import IRGraph
from .mapping import (Machine, cluster_interaction_graphs,
                      memory_centric_mapping, resolve_mapping_backend)
from .op_graph import trace_to_graph
from .simulator import coerce_graph, simulate, vertex_bytes_model
from .vertex_cut import VertexCutResult, vertex_cut

__all__ = ["PlanReport", "plan_graph", "plan_step", "optimal_parallelism",
           "ExpertPlacement",
           "expert_placement", "naive_expert_placement", "mesh_device_order"]


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


def plan_step(fn, *args, p: int = 8, method: str = "wb_libra",
              lam: float = 1.0, backend: str = "cuda", device: str = "cuda",
              **kw) -> PlanReport:
    """Capture `fn(*args, **kw)` and plan its p-way partitioned
    execution; `device` is the planner's (`plan_graph`: it raises before
    the capture where it cannot be had), the program runs where its
    tensors are."""
    if backend == "cuda":
        resolve_device(device)
    g = trace_to_graph(fn, *args, **kw)
    return plan_graph(g, p, method=method, lam=lam, backend=backend,
                      device=device)


def optimal_parallelism(fn, *args, candidates=(2, 4, 8, 16, 32),
                        method: str = "wb_libra", backend: str = "cuda",
                        device: str = "cuda") -> tuple[int, list]:
    """Pick the cluster count with the lowest simulated execution time —
    the paper's stated goal of 'discovering optimal parallelization
    degree' for a program.  `fn(*args)` is captured once and planned at
    each candidate."""
    if backend == "cuda":
        resolve_device(device)
    g = trace_to_graph(fn, *args)
    reports = [plan_graph(g, p, method=method, backend=backend,
                          device=device)
               for p in candidates]
    best = int(np.argmin([r.exec_time for r in reports]))
    return candidates[best], reports


# ---------------------------------------------------------------------- #
# MoE expert placement (EP integration)
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class ExpertPlacement:
    """Expert→device placement with replication of hot experts."""

    n_experts: int
    n_devices: int
    device_experts: list            # per device: sorted list of expert ids
    expert_devices: list            # per expert: sorted list of device ids
    device_load: np.ndarray         # expected routed tokens per device
    replication_factor: float       # mean replicas per expert
    all_to_all_fraction: float      # fraction of tokens leaving their shard

    def summary(self) -> dict:
        return {
            "n_experts": self.n_experts, "n_devices": self.n_devices,
            "replication_factor": round(self.replication_factor, 3),
            "load_imbalance": round(
                float(self.device_load.max()
                      / max(self.device_load.mean(), 1e-9)), 4),
            "all_to_all_fraction": round(self.all_to_all_fraction, 4),
        }


def expert_placement(expert_load: np.ndarray,
                     co_activation: np.ndarray | None = None,
                     n_devices: int = 8, lam: float = 1.0,
                     seed: int = 0,
                     max_replicas: int = 4,
                     backend: str = "cuda",
                     device: str = "cuda") -> ExpertPlacement:
    """WB-Libra placement of MoE experts across EP shards.

    Builds the expert co-activation graph (vertices = experts; edge (i,j)
    weighted by tokens routed to both i and j in the same top-k set) and
    partitions its *edges* into `n_devices` clusters.  A(expert) — the
    replica set — is the set of devices serving that expert: hot experts
    end up replicated like the paper's cut hub vertices, balancing
    per-device load while keeping co-routed experts on the same shard.

    Args:
      expert_load: [E] routed token counts (from routing statistics).
      co_activation: optional [E,E] co-routing counts; a rank-1 surrogate
        `load_i * load_j / total` is used when absent.
      n_devices: EP shards.
      lam: balance bound (paper Eq. 3).
      max_replicas: memory cap — an expert's weights are materialised on
        every replica shard, so A(expert) is trimmed to the
        `max_replicas` least-loaded members.
      backend: the cut's backend (`vertex_cut`); every backend gives the
        same placement.
      device: where the "cuda" backend's finalize runs: "cuda" (the
        card, the default; raises without one) or "cpu".  The host
        backends ignore it.
    """
    expert_load = np.asarray(expert_load, dtype=np.float64)
    e_cnt = len(expert_load)
    if co_activation is None:
        tot = max(expert_load.sum(), 1e-9)
        co_activation = np.outer(expert_load, expert_load) / tot
    co = np.array(co_activation, dtype=np.float64)
    np.fill_diagonal(co, 0.0)

    iu, ju = np.nonzero(np.triu(co > 0, k=1))
    wts = co[iu, ju]
    # keep the heaviest edges (the co-activation graph can be dense)
    if len(wts) > 64 * e_cnt:
        order = np.argsort(-wts)[: 64 * e_cnt]
        iu, ju, wts = iu[order], ju[order], wts[order]
    g = IRGraph(n=e_cnt, src=iu, dst=ju, w=wts, name="expert_coactivation")
    cut = vertex_cut(g, n_devices, method="wb_libra", lam=lam, seed=seed,
                     edge_order="shuffled", backend=backend, device=device)

    # a cold expert (no replica) is placed on the least loaded device below
    expert_devices = [sorted(a) if a else [] for a in cut.replicas]

    # distribute each expert's load over its replicas (hottest first so
    # the max_replicas trim keeps balance); cold experts fill gaps
    device_load = np.zeros(n_devices)
    for ex in np.argsort(-expert_load):
        ex = int(ex)
        devs = expert_devices[ex]
        if not devs:
            d = int(np.argmin(device_load))
            expert_devices[ex] = [d]
            devs = [d]
        if len(devs) > max_replicas:
            devs = sorted(devs, key=lambda d: device_load[d])[:max_replicas]
            expert_devices[ex] = sorted(devs)
        share = expert_load[ex] / len(devs)
        for d in devs:
            device_load[d] += share

    device_experts = [[] for _ in range(n_devices)]
    for ex, devs in enumerate(expert_devices):
        for d in devs:
            device_experts[d].append(ex)
    device_experts = [sorted(d) for d in device_experts]

    # all-to-all volume: a token on data-shard d routed to expert ex must
    # leave d unless ex is served locally.  With uniform token origin the
    # leave probability is 1 - |A(ex)|/n_devices.
    tot = max(expert_load.sum(), 1e-9)
    stay = sum(expert_load[ex] * len(expert_devices[ex]) / n_devices
               for ex in range(e_cnt))
    rf = float(np.mean([len(d) for d in expert_devices]))
    return ExpertPlacement(
        n_experts=e_cnt, n_devices=n_devices,
        device_experts=device_experts, expert_devices=expert_devices,
        device_load=device_load, replication_factor=rf,
        all_to_all_fraction=float(1.0 - stay / tot))


def naive_expert_placement(expert_load: np.ndarray,
                           n_devices: int) -> ExpertPlacement:
    """Contiguous block placement (the standard EP layout) for comparison."""
    expert_load = np.asarray(expert_load, dtype=np.float64)
    e_cnt = len(expert_load)
    per = int(np.ceil(e_cnt / n_devices))
    expert_devices = [[min(ex // per, n_devices - 1)] for ex in range(e_cnt)]
    device_load = np.zeros(n_devices)
    for ex in range(e_cnt):
        device_load[expert_devices[ex][0]] += expert_load[ex]
    device_experts = [[] for _ in range(n_devices)]
    for ex, devs in enumerate(expert_devices):
        device_experts[devs[0]].append(ex)
    tot = max(expert_load.sum(), 1e-9)
    stay = sum(expert_load[ex] / n_devices for ex in range(e_cnt))
    return ExpertPlacement(
        n_experts=e_cnt, n_devices=n_devices,
        device_experts=device_experts, expert_devices=expert_devices,
        device_load=device_load, replication_factor=1.0,
        all_to_all_fraction=float(1.0 - stay / tot))


# ---------------------------------------------------------------------- #
# mesh device ordering (Algorithm 2 on the device mesh)
# ---------------------------------------------------------------------- #
def mesh_device_order(shard_comm: np.ndarray, rows: int, cols: int,
                      backend: str = "fast") -> np.ndarray:
    """Assign model shards to mesh coordinates.

    `shard_comm[i, j]` is the traffic between logical shards i and j.
    Returns `core_of[shard] -> mesh slot` from the memory-centric
    mapping: communicating shards become neighbours (factor 2),
    independent shards spread across regions (factor 3).  The placement
    is a host loop on every backend (as `memory_centric_mapping`'s), so
    `backend` only names the engine and never needs a card.
    """
    p = shard_comm.shape[0]
    mach = Machine(rows=rows, cols=cols,
                   cluster_threshold=max(1, int(np.ceil(p / (rows * cols)))))
    mapping = memory_centric_mapping(shard_comm, np.zeros_like(shard_comm),
                                     mach,
                                     backend=resolve_mapping_backend(backend))
    return mapping.core_of
