"""Deterministic NUMA multi-core cost simulator (paper §6 evaluation rig).

The paper evaluates partitions by executing them in gem5 on an out-of-order
NUMA mesh (Table 2).  gem5 is out of scope here; instead we charge each
cluster an analytic cost on the same machine model used by the mapper:

  compute   — Σ of edge weights (weights *are* memory-op time, §3) plus a
              fixed per-instruction issue cost; clusters sharing a core
              serialize (the paper's threshold=4 colocations).
  replica sync (vertex cut) — for every cut vertex, its owner pushes the
              value to each replica: hops·hop_latency + bytes/link_bw,
              charged to the receiving core; zero if owner and replica
              share a core (factor-1 benefit).
  cut edges (edge cut) — every inter-cluster edge moves its payload
              between the producing and consuming cores.
  synchronisation — critical-section/coherence traffic grows superlinearly
              with the cluster count (the paper observes comm turning back
              up beyond 128 clusters); modelled as σ·P·log2(P) messages.

Outputs: overall execution time (max over cores + sync) and total
inter-core data communication, the two quantities in Tables 6–9.

Like the partitioner and the mapper, the simulator runs on one of three
engines selected with `backend=`: "cuda" (the default) runs the
accumulations on `device` through the segment-sum layer (`cuda/`: the
CUDA kernel on the card, its plain version on the host); "fast" builds
the vertex-cut (owner, dst, bytes) replica-sync triples straight from
the replica CSR with no Python loop (`_arrayops.star_triples`);
"reference" is
the original per-vertex loop over `set` replica sets, kept as the oracle
(tests assert all SimReports agree to rtol 1e-12; the cuda/fast
core_times are bit-identical).
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from .. import obs
from ._arrayops import star_triples
from .cuda import keyed_sum, metrics as cuda_metrics, resolve_device
from .graph import IRGraph
from .mapping import (Machine, MappingResult, cluster_interaction_graphs,
                      resolve_mapping_backend)
from .vertex_cut import VertexCutResult
from .edge_cut import EdgeCutResult

__all__ = ["SimReport", "simulate", "run_pipeline", "vertex_bytes_model",
           "coerce_graph"]

# -- cost constants (machine-model scale; Table 2: 2.4 GHz OoO cores) ----
CYCLE = 1.0 / 2.4e9                   # edge weights are cycles (rdtsc units)
INSTR_COST = 0.5 * CYCLE              # avg non-memory issue cost (s/instr)
CACHE_LINE = 64.0                     # bytes moved per dependency/sync msg
SYNC_MSG_BYTES = 64.0                 # one cache line per sync message
SYNC_BASE = 100 * CYCLE               # critical-section entry cost (s)
WEIGHT_TO_SECONDS = CYCLE             # edge-weight unit -> seconds


@dataclasses.dataclass
class SimReport:
    graph_name: str
    method: str
    p: int
    exec_time: float                  # seconds (modelled)
    data_comm_bytes: float            # inter-core traffic
    core_times: np.ndarray
    sync_time: float
    sync_bytes: float

    def summary(self) -> dict:
        return {"graph": self.graph_name, "method": self.method, "p": self.p,
                "exec_time": self.exec_time,
                "data_comm_bytes": self.data_comm_bytes}


def vertex_bytes_model(g: IRGraph) -> np.ndarray:
    """Bytes synced per vertex replica: one cache line per value (§6.2.4 —
    the only vertex-cut traffic is replica synchronisation of cut vertices).
    """
    return np.full(g.n, CACHE_LINE)


# ---------------------------------------------------------------------- #
def simulate(g: IRGraph, partition, mapping: MappingResult,
             backend: str = "cuda", device: str = "cuda") -> SimReport:
    """Execute a partition (vertex- or edge-cut) on the mapped machine.

    `backend="cuda"`, the default, applies to vertex cuts (the paper's
    subject), on `device` ("cuda", the default, raises when no card is
    present; "cpu" runs the plain versions); edge-cut baselines always
    score on the numpy path.  The host backends ignore `device`.
    """
    backend = resolve_mapping_backend(backend)
    dev = resolve_device(device) if backend == "cuda" else None
    if isinstance(partition, VertexCutResult):
        with obs.span("sim.run", backend=backend, kind="vertex"):
            return _simulate_vertex_cut(g, partition, mapping, backend, dev)
    if isinstance(partition, EdgeCutResult):
        with obs.span("sim.run", backend=backend, kind="edge"):
            return _simulate_edge_cut(g, partition, mapping)
    raise TypeError(f"unsupported partition type {type(partition)}")


def _per_cluster_compute(g: IRGraph, edge_cluster: np.ndarray,
                         p: int) -> np.ndarray:
    t = np.zeros(p)
    np.add.at(t, edge_cluster, g.w * WEIGHT_TO_SECONDS + INSTR_COST)
    return t


def _core_compute(cluster_time: np.ndarray, mapping: MappingResult
                  ) -> np.ndarray:
    core_t = np.zeros(mapping.machine.n_cores)
    np.add.at(core_t, mapping.core_of, cluster_time)
    return core_t


def _sync_model(p: int, n_cores: int) -> tuple[float, float]:
    """Critical-section synchronisation cost/traffic, same for all methods."""
    if p <= 1:
        return 0.0, 0.0
    rounds = p * math.log2(p)
    sync_bytes = rounds * SYNC_MSG_BYTES * max(1.0, p / 256.0)
    sync_time = rounds * SYNC_BASE / max(1, n_cores)
    return sync_time, sync_bytes


def _vc_triples_reference(r: VertexCutResult, vb: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Oracle: per-vertex loop flattening (owner, dst, bytes) triples."""
    owners, dsts, sizes = [], [], []
    for v, a in enumerate(r.replicas):
        if not a or len(a) < 2:
            continue
        members = sorted(a)
        owners.extend([members[0]] * (len(members) - 1))
        dsts.extend(members[1:])
        sizes.extend([vb[v]] * (len(members) - 1))
    return (np.asarray(owners, dtype=np.int64),
            np.asarray(dsts, dtype=np.int64), np.asarray(sizes))


def _simulate_cuda_vertex_cut(g: IRGraph, r: VertexCutResult,
                              mapping: MappingResult,
                              device: torch.device) -> SimReport:
    """The same cost model with every accumulation on `device` through
    the segment-sum layer.  `keyed_sum` reproduces the `np.add.at`
    accumulation order, so core_times are bit-identical to the fast
    engine; only the final `sum` of the bytes may reassociate, hence the
    rtol-1e-12 contract on `data_comm_bytes`.

    The elementwise steps are separate eager ops in numpy's order
    (w * c1, then + c2; hops * latency, then + penalty; lat / overlap,
    b / bw, then +), so each rounds exactly once as in numpy: a fused
    kernel could contract a multiply and an add into one FMA.  Divisors
    are device tensors, because a CUDA division by a host scalar is
    computed as a multiplication by its reciprocal.
    """
    mach = mapping.machine
    f64 = torch.float64

    def scalar(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=f64, device=device)

    assign = cuda_metrics.as_tensor(r.assignment, torch.int64, device)
    w = cuda_metrics.as_tensor(g.w, f64, device)
    cluster_t = keyed_sum(assign, w * WEIGHT_TO_SECONDS + INSTR_COST, r.p)
    core_of = cuda_metrics.as_tensor(mapping.core_of, torch.int64, device)
    core_t = keyed_sum(core_of, cluster_t, mach.n_cores).cpu().numpy()

    owners, dsts, b = cuda_metrics.star_triples(
        *r.replica_csr(), vertex_bytes_model(g), device)
    core_wait = np.zeros(mach.n_cores)
    comm_bytes = 0.0
    if owners.numel():
        oc = core_of[owners]
        dc = core_of[dsts]
        diff = oc != dc           # factor-1 colocation: coherence-free
        oc, dc, b = oc[diff], dc[diff], b[diff]
        hops = (torch.abs(oc // mach.cols - dc // mach.cols)
                + torch.abs(oc % mach.cols - dc % mach.cols))
        lat = hops.to(f64) * mach.hop_latency + mach.coherence_penalty
        wait = (lat / scalar(mach.mshr_overlap)
                + b / scalar(mach.link_bw))
        core_wait = keyed_sum(dc, wait, mach.n_cores).cpu().numpy()
        comm_bytes = float(b.sum())
    sync_t, sync_b = _sync_model(r.p, mach.n_cores)
    exec_time = float((core_t + core_wait).max() + sync_t)
    return SimReport(g.name, r.method, r.p, exec_time,
                     comm_bytes + sync_b, core_t + core_wait, sync_t, sync_b)


def _simulate_vertex_cut(g: IRGraph, r: VertexCutResult,
                         mapping: MappingResult, backend: str,
                         device: "torch.device | None") -> SimReport:
    if backend == "cuda":
        return _simulate_cuda_vertex_cut(g, r, mapping, device)
    mach = mapping.machine
    cluster_t = _per_cluster_compute(g, r.assignment, r.p)
    core_t = _core_compute(cluster_t, mapping)

    vb = vertex_bytes_model(g)
    core_wait = np.zeros(mach.n_cores)
    # flatten (owner_core, dst_core, bytes) across all replica sets;
    # the fast path reads them straight off the replica CSR
    if backend == "fast":
        owners, dsts, b = star_triples(*r.replica_csr(), vb)
    else:
        owners, dsts, b = _vc_triples_reference(r, vb)
    if len(owners):
        oc = mapping.core_of[owners].astype(np.int64)
        dc = mapping.core_of[dsts].astype(np.int64)
        diff = oc != dc           # factor-1 colocation: coherence-free
        oc, dc, b = oc[diff], dc[diff], b[diff]
        hops = (np.abs(oc // mach.cols - dc // mach.cols)
                + np.abs(oc % mach.cols - dc % mach.cols))
        lat = hops * mach.hop_latency + mach.coherence_penalty
        np.add.at(core_wait, dc,
                  lat / mach.mshr_overlap + b / mach.link_bw)
        comm_bytes = float(b.sum())
    else:
        comm_bytes = 0.0
    sync_t, sync_b = _sync_model(r.p, mach.n_cores)
    exec_time = float((core_t + core_wait).max() + sync_t)
    return SimReport(g.name, r.method, r.p, exec_time,
                     comm_bytes + sync_b, core_t + core_wait, sync_t, sync_b)


def _simulate_edge_cut(g: IRGraph, r: EdgeCutResult,
                       mapping: MappingResult) -> SimReport:
    mach = mapping.machine
    # edge executed at consumer's cluster
    edge_cluster = r.parts[g.dst]
    cluster_t = _per_cluster_compute(g, edge_cluster, r.p)
    core_t = _core_compute(cluster_t, mapping)

    cu = r.parts[g.src]
    cv = r.parts[g.dst]
    cross = cu != cv
    core_wait = np.zeros(mach.n_cores)
    src_cores = mapping.core_of[cu[cross]].astype(np.int64)
    dst_cores = mapping.core_of[cv[cross]].astype(np.int64)
    diff = src_cores != dst_cores
    sc, dc = src_cores[diff], dst_cores[diff]
    hops = (np.abs(sc // mach.cols - dc // mach.cols)
            + np.abs(sc % mach.cols - dc % mach.cols))
    lat = hops * mach.hop_latency + mach.coherence_penalty
    np.add.at(core_wait, dc,
              lat / mach.mshr_overlap + CACHE_LINE / mach.link_bw)
    comm_bytes = float(len(sc) * CACHE_LINE)
    sync_t, sync_b = _sync_model(r.p, mach.n_cores)
    exec_time = float((core_t + core_wait).max() + sync_t)
    return SimReport(g.name, r.method, r.p, exec_time,
                     comm_bytes + sync_b, core_t + core_wait, sync_t, sync_b)


# ---------------------------------------------------------------------- #
def coerce_graph(g) -> IRGraph:
    """Accept an `IRGraph` or a path to an `.npz` snapshot (the layout
    that the JAX package's `IRGraph.save_npz` writes too).  Trace paths
    (NDJSON, `.rtb`) need the trace front end, which is not ported yet."""
    if isinstance(g, IRGraph):
        return g
    if isinstance(g, (str, os.PathLike)):
        if os.fspath(g).endswith(".npz"):
            return IRGraph.load_npz(g)
        raise NotImplementedError(
            f"trace paths are not ported yet (ROADMAP.md, queue 1, item 2): "
            f"{os.fspath(g)!r}; pass an IRGraph or an .npz snapshot")
    raise TypeError(f"expected IRGraph or path, got {type(g).__name__}")


def run_pipeline(g, p: int, method: str, lam: float = 1.0,
                 machine: Machine | None = None, seed: int = 0,
                 backend: str = "cuda", workers: int = 1,
                 merge_period: "int | None" = None,
                 divergence: "float | None" = None,
                 profile: "str | None" = None,
                 device: str = "cuda"):
    """partition -> map -> simulate, returning (partition, mapping, report).

    The end-to-end path of Fig. 1: structure analysis is already in `g`
    (an `IRGraph`, or a path to an `.npz` snapshot), vertex/edge cut
    produces clusters, the memory-centric mapping schedules them, and the
    simulator scores the result.  `backend` selects the engine for every
    stage: the partitioner accepts any of its backends
    ("cuda"/"fast"/"native"/"python"/"reference"); the mapping and
    simulator run their reference oracle iff `backend == "reference"`
    and the segment-sum layer iff `backend == "cuda"`.  The default,
    "cuda", runs the reductions on `device`: the card by default (which
    raises when no card is present), the kernels' plain versions on the
    host with `device="cpu"`.  The host backends ignore `device`.

    `workers`, `merge_period` and `divergence` belong to
    `backend="dist"`, and `profile=` to the full telemetry layer; neither
    is ported yet, and both raise NotImplementedError.
    """
    if profile is not None:
        raise NotImplementedError(
            "profile= needs the full obs layer, which is not ported yet "
            "(ROADMAP.md, queue 1, item 6)")
    from .edge_cut import EDGE_CUT_METHODS, edge_cut as _edge_cut
    from .vertex_cut import ALGORITHMS, vertex_cut as _vertex_cut
    from .mapping import memory_centric_mapping

    map_backend = resolve_mapping_backend(backend)
    dev = resolve_device(device) if backend == "cuda" else None
    with obs.span("pipeline.ingest", cat="section", backend=backend):
        g = coerce_graph(g)

    machine = machine or Machine.for_clusters(p)
    if method in ALGORITHMS:
        with obs.span("pipeline.partition", cat="section", backend=backend,
                      method=method, p=p):
            part = _vertex_cut(g, p, method=method, lam=lam, seed=seed,
                               backend=backend, device=dev)
        with obs.span("pipeline.map", cat="section", backend=map_backend):
            comm, shared = cluster_interaction_graphs(
                part, p, vertex_bytes_model(g), backend=map_backend,
                device=dev)
            mapping = memory_centric_mapping(comm, shared, machine,
                                             backend=map_backend)
    elif method in EDGE_CUT_METHODS:
        with obs.span("pipeline.partition", cat="section", backend=backend,
                      method=method, p=p):
            part = _edge_cut(g, p, method=method, seed=seed)
        with obs.span("pipeline.map", cat="section", backend=map_backend):
            # inter-cluster comm graph from cut edges (one line per
            # dependency)
            comm = np.zeros((p, p))
            cu, cv = part.parts[g.src], part.parts[g.dst]
            cross = cu != cv
            np.add.at(comm, (cu[cross], cv[cross]), CACHE_LINE)
            comm = comm + comm.T
            mapping = memory_centric_mapping(comm, np.zeros_like(comm),
                                             machine, backend=map_backend)
    else:
        raise ValueError(f"unknown method {method!r}")
    with obs.span("pipeline.simulate", cat="section", backend=map_backend):
        report = simulate(g, part, mapping, backend=map_backend, device=dev)
    return part, mapping, report
