"""Memory-centric run-time mapping — paper §5 (Algorithm 2).

Maps partitioner clusters onto a multi-core NUMA platform modelled as a
2-D mesh NoC (paper Table 2: mesh topology, XY routing).  The three
factors of Fig. 7 drive the greedy decisions:

  factor 1 — clusters referencing the same data structures -> same core
             (avoids cache-coherence fetches and block memory ops),
             capped by a per-core cluster threshold (=4 in the paper);
  factor 2 — communicating clusters -> adjacent cores (short XY routes);
  factor 3 — independent clusters  -> different mesh regions
             (architecture decomposition spreads traffic), avoiding the
             region of the cluster's strongest (weak) interaction peer.

Like `vertex_cut`, the layer runs on one of three engines selected with
`backend=`:

  reference — the original per-cluster Python scans over every core and
              the per-vertex replica-set loop of
              `cluster_interaction_graphs`; kept as the readable oracle.
  fast      — array-native: interaction graphs are
              vectorized segment ops over the replica CSR
              (`_arrayops.interaction_from_csr`), and the greedy
              placement replaces its `for c in range(n_cores)` candidate
              scans with precomputed hop-distance/region arrays and
              masked argmin selection.  Bit-identical `core_of` to the
              reference: same greedy order, same (occupancy, hops)
              lexicographic keys, same lowest-index tie-breaking.
  cuda      — the default of `cluster_interaction_graphs` (Algorithm 2
              defaults to "fast", the same placement): interaction
              graphs run on `device` through the segment-sum
              layer (`cuda.metrics`: the CUDA kernel on the card, its
              plain version on the host), bit-identical to the fast path;
              the greedy placement itself is an inherently sequential
              scalar loop and reuses the fast engine, so `core_of` stays
              bit-identical too.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .. import obs
from ._arrayops import interaction_from_csr
from .cuda import metrics as cuda_metrics, resolve_device
from .vertex_cut import BACKENDS as _PARTITIONER_BACKENDS

__all__ = ["Machine", "MappingResult", "memory_centric_mapping",
           "cluster_interaction_graphs", "round_robin_mapping",
           "MAPPING_BACKENDS", "resolve_mapping_backend"]

MAPPING_BACKENDS = ("fast", "reference", "cuda")


def resolve_mapping_backend(backend: str) -> str:
    """Map a pipeline-level backend choice onto a mapping/sim engine.

    The partitioner distinguishes "native"/"python" fast engines (plus
    the sharded "dist" mode of `repro_torch.dist`, which runs on the
    host); the mapping and simulator layers keep "reference" and "cuda"
    and run everything else on the numpy fast path.
    """
    if backend != "dist" and backend not in _PARTITIONER_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from "
                         f"{_PARTITIONER_BACKENDS + ('dist',)}")
    return backend if backend in ("reference", "cuda") else "fast"


@dataclasses.dataclass(frozen=True)
class Machine:
    """A rows×cols mesh of cores with NUMA regions (quadrant decomposition).

    Latency/bandwidth defaults follow paper Table 2 scaled to seconds:
    2.4 GHz cores, 8 GB/s memory bandwidth, per-hop NoC latency.
    """
    rows: int
    cols: int
    n_regions: int = 4
    hop_latency: float = 5e-9          # per-hop wire+router latency (s)
    link_bw: float = 8e9               # NoC link bandwidth (B/s)
    local_mem_bw: float = 8e9          # DRAM bandwidth (B/s), Table 2
    coherence_penalty: float = 60e-9   # cache-line fetch from remote L1/L2
    mshr_overlap: int = 16             # outstanding misses (Table 2: 16 MSHRs)
    cluster_threshold: int = 4         # max clusters per core (paper §5.2)

    @property
    def n_cores(self) -> int:
        return self.rows * self.cols

    def coords(self, core: int) -> tuple[int, int]:
        return divmod(core, self.cols)

    def hops(self, a: int, b: int) -> int:
        """XY-routing hop count between cores a and b."""
        ra, ca = self.coords(a)
        rb, cb = self.coords(b)
        return abs(ra - rb) + abs(ca - cb)

    def region_grid(self) -> tuple[int, int]:
        """(row_bands, col_bands) with row_bands·col_bands == n_regions.

        The factor pair closest to square (largest divisor <= sqrt), with
        the longer band axis along the longer mesh axis so every region
        id is realisable whenever the mesh has enough rows/cols — a
        non-perfect-square n_regions (6, 5, ...) must not silently drop
        regions.
        """
        n = max(1, self.n_regions)
        small = max(d for d in range(1, int(np.sqrt(n)) + 1) if n % d == 0)
        big = n // small
        return (big, small) if self.rows >= self.cols else (small, big)

    def region_of(self, core: int) -> int:
        """Grid-style architecture decomposition (factor 3)."""
        r, c = self.coords(core)
        rb, cb = self.region_grid()
        return (r * rb // self.rows) * cb + (c * cb // self.cols)

    # -- vectorized views (the fast mapping backend's precomputation) --- #
    def hop_matrix(self) -> np.ndarray:
        """int64[n_cores, n_cores] all-pairs XY hop counts."""
        ids = np.arange(self.n_cores, dtype=np.int64)
        r, c = np.divmod(ids, self.cols)
        return (np.abs(r[:, None] - r[None, :])
                + np.abs(c[:, None] - c[None, :]))

    def region_array(self) -> np.ndarray:
        """int64[n_cores] region id per core (vectorized `region_of`)."""
        ids = np.arange(self.n_cores, dtype=np.int64)
        r, c = np.divmod(ids, self.cols)
        rb, cb = self.region_grid()
        return (r * rb // self.rows) * cb + (c * cb // self.cols)

    @classmethod
    def for_clusters(cls, p: int, max_cores: int = 64, **kw) -> "Machine":
        """Near-square mesh with min(p, max_cores) cores.

        The paper scales clusters 8→1024 on a *fixed* multi-core platform;
        when p exceeds the core budget, clusters share cores (the per-core
        threshold grows accordingly).
        """
        n = min(p, max_cores)
        rows = int(np.ceil(np.sqrt(n)))
        cols = int(np.ceil(n / rows))
        kw.setdefault("cluster_threshold",
                      max(4, int(np.ceil(p / (rows * cols)))))
        return cls(rows=rows, cols=cols, **kw)


@dataclasses.dataclass
class MappingResult:
    machine: Machine
    core_of: np.ndarray           # int32[P] cluster -> core
    p: int

    def clusters_on(self, core: int) -> np.ndarray:
        return np.nonzero(self.core_of == core)[0]

    @property
    def cores_used(self) -> int:
        return len(np.unique(self.core_of))


# ---------------------------------------------------------------------- #
# interaction graphs from a vertex cut result
# ---------------------------------------------------------------------- #
def _as_replica_csr(replicas) -> tuple[np.ndarray, np.ndarray]:
    """Replica CSR (indptr, members) from a VertexCutResult or list[set]."""
    csr = getattr(replicas, "replica_csr", None)
    if csr is not None:
        return csr()
    sizes = np.fromiter((len(a) if a else 0 for a in replicas),
                        dtype=np.int64, count=len(replicas))
    indptr = np.zeros(len(replicas) + 1, dtype=np.int64)
    np.cumsum(sizes, out=indptr[1:])
    flat = np.fromiter((c for a in replicas if a for c in sorted(a)),
                       dtype=np.int32, count=int(indptr[-1]))
    return indptr, flat


def _as_replica_list(replicas) -> list:
    rep = getattr(replicas, "replicas", None)
    return rep if rep is not None else replicas


def cluster_interaction_graphs(replicas, p: int,
                               vertex_bytes: np.ndarray | None = None,
                               pairwise_cap: int = 64,
                               backend: str = "cuda",
                               device: str = "cuda"
                               ) -> tuple[np.ndarray, np.ndarray]:
    """Derive (comm[P,P], shared_mem[P,P]) from the replica sets A(v).

    Replica synchronisation is star-shaped from the owner (lowest cluster id
    in A(v)) to each replica — the only inter-cluster traffic of a vertex
    cut.  `shared_mem` counts vertices whose data both clusters reference
    (drives factor 1).  Vertices replicated to more than `pairwise_cap`
    clusters are effectively global data structures; their O(|A|^2) shared
    pairs are skipped (every core shares them anyway) while their star
    traffic is still counted.

    `replicas` is a `VertexCutResult` (preferred — its replica CSR feeds
    the vectorized fast path directly) or the legacy list-of-sets view.
    `backend` is "cuda" (the default), "fast" or "reference"; `device` is
    where the "cuda" backend's reductions run ("cuda", the default,
    raises when no card is present; "cpu" runs the plain versions).  The
    host backends ignore it.
    """
    backend = resolve_mapping_backend(backend)
    with obs.span("map.cluster_graphs", engine=backend, p=p):
        if backend == "cuda":
            dev = resolve_device(device)
            indptr, members = _as_replica_csr(replicas)
            comm, shared = cuda_metrics.interaction_from_csr(
                indptr, members, p, vertex_bytes, pairwise_cap, dev)
            return comm.cpu().numpy(), shared.cpu().numpy()
        if backend == "fast":
            indptr, members = _as_replica_csr(replicas)
            return interaction_from_csr(indptr, members, p, vertex_bytes,
                                        pairwise_cap)
        return _interaction_reference(_as_replica_list(replicas), p,
                                      vertex_bytes, pairwise_cap)


def _interaction_reference(replicas: list, p: int,
                           vertex_bytes: np.ndarray | None,
                           pairwise_cap: int
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Oracle: the original per-vertex loop over `set` replica sets."""
    comm = np.zeros((p, p))
    shared = np.zeros((p, p))
    for v, a in enumerate(replicas):
        if not a:
            continue
        members = sorted(a)
        # diagonal: total vertices each cluster references (overlap denom.)
        for x in members:
            shared[x, x] += 1
        if len(members) < 2:
            continue
        b = 1.0 if vertex_bytes is None else float(vertex_bytes[v])
        owner = members[0]
        for r in members[1:]:
            comm[owner, r] += b
            comm[r, owner] += b
        if len(members) <= pairwise_cap:
            for i, x in enumerate(members):
                for y in members[i + 1:]:
                    shared[x, y] += 1
                    shared[y, x] += 1
    return comm, shared


# ---------------------------------------------------------------------- #
# Algorithm 2
# ---------------------------------------------------------------------- #
def memory_centric_mapping(comm: np.ndarray, shared: np.ndarray,
                           machine: Machine | None = None,
                           cluster_order: np.ndarray | None = None,
                           colocate_min_overlap: float = 0.5,
                           backend: str = "fast"
                           ) -> MappingResult:
    """Greedy cluster→core mapping per Algorithm 2 (O(P·k), k = peers).

    Args:
      comm:   [P,P] inter-cluster communication volume (factor 2 signal).
      shared: [P,P] shared-data-structure counts (factor 1 signal); the
        diagonal holds each cluster's own referenced-vertex count.
      machine: target platform; default smallest mesh with >= P cores.
      cluster_order: schedulable order (run queue); default by descending
        total interaction so hub clusters anchor placement.
      colocate_min_overlap: factor-1 colocation (same core) only fires when
        the shared-data overlap exceeds this fraction of the smaller
        cluster's references — `ClusterFromMem` in Algorithm 2 targets
        clusters working on the *same data structure*, not any two clusters
        that happen to share a replica of a hub vertex.
      backend: "fast" (masked-argmin placement over precomputed hop and
        region arrays) or "reference" (per-core Python scans, the oracle).
        Both produce bit-identical `core_of`; the partitioner-level
        engine names "native"/"python" resolve to "fast", and "cuda"
        also places on the fast engine (the greedy loop is an inherently
        sequential scalar scan — only the interaction reductions have a
        device version).
    """
    backend = resolve_mapping_backend(backend)
    p = comm.shape[0]
    machine = machine or Machine.for_clusters(p)

    off_diag = shared.copy()
    np.fill_diagonal(off_diag, 0.0)
    if cluster_order is None:
        cluster_order = np.argsort(-(comm.sum(1) + off_diag.sum(1)),
                                   kind="stable")
    own = np.maximum(np.diagonal(shared), 1.0)

    place = _place_reference if backend == "reference" else _place_fast
    with obs.span("map.place", backend=backend, p=p):
        core_of = place(comm, off_diag, own, machine, cluster_order,
                        colocate_min_overlap)
    return MappingResult(machine=machine, core_of=core_of, p=p)


def _select_peers(cl: int, placed: np.ndarray, comm: np.ndarray,
                  off_diag: np.ndarray, own: np.ndarray,
                  colocate_min_overlap: float) -> tuple[int, int]:
    """(mem_peer, ipc_peer) for cluster `cl`; -1 when a factor is silent."""
    mem_peer = ipc_peer = -1
    if placed.any():
        # factor 1: already-placed peer sharing a dominant data structure
        srow = np.where(placed, off_diag[cl], -1.0)
        j = int(np.argmax(srow))
        if srow[j] > colocate_min_overlap * min(own[cl], own[j]):
            mem_peer = j
        # factor 2: strongest already-placed communication peer
        crow = np.where(placed, comm[cl], -1.0)
        j = int(np.argmax(crow))
        if crow[j] > 0:
            ipc_peer = j
    return mem_peer, ipc_peer


def _weak_peer(cl: int, placed: np.ndarray, comm: np.ndarray,
               off_diag: np.ndarray) -> int:
    """Strongest already-placed interaction peer by the combined signal
    (factor 3 avoids its region); -1 if nothing placed interacts at all."""
    if not placed.any():
        return -1
    irow = np.where(placed, comm[cl] + off_diag[cl], -1.0)
    j = int(np.argmax(irow))
    return j if irow[j] > 0 else -1


def _place_reference(comm: np.ndarray, off_diag: np.ndarray, own: np.ndarray,
                     machine: Machine, cluster_order: np.ndarray,
                     colocate_min_overlap: float) -> np.ndarray:
    """Oracle placement: per-core Python scans (the original engine)."""
    p = comm.shape[0]
    n_cores = machine.n_cores
    core_of = np.full(p, -1, dtype=np.int32)
    core_count = np.zeros(n_cores, dtype=np.int64)
    regions = [machine.region_of(c) for c in range(n_cores)]
    n_regions = max(regions) + 1
    region_rr = 0  # round-robin cursor for architecture decomposition

    def nearby_core(anchor: int) -> int:
        """Least-occupied *other* core, ties broken by distance to `anchor`
        (factor 2: communicating clusters on adjacent processors).  Occupancy
        is the primary key — a core executing another cluster serializes it,
        which costs orders of magnitude more than a NoC hop, so "nearby"
        means the closest *available* processor."""
        best, best_key = anchor, None
        for c in range(n_cores):
            if c == anchor or core_count[c] >= machine.cluster_threshold:
                continue
            key = (core_count[c], machine.hops(anchor, c))
            if best_key is None or key < best_key:
                best, best_key = c, key
        return best if best_key is not None else int(np.argmin(core_count))

    def diff_region_core(avoid_region: int | None) -> int:
        """Least-utilised core in a different region (factor 3)."""
        nonlocal region_rr
        for off in range(n_regions):
            reg = (region_rr + off) % n_regions
            if avoid_region is not None and reg == avoid_region:
                continue
            cands = [c for c in range(n_cores) if regions[c] == reg]
            cands = [c for c in cands
                     if core_count[c] < machine.cluster_threshold]
            if cands:
                region_rr = (reg + 1) % n_regions
                return min(cands, key=lambda c: core_count[c])
        return int(np.argmin(core_count))

    for cl in cluster_order:
        cl = int(cl)
        placed = core_of >= 0
        mem_peer, ipc_peer = _select_peers(cl, placed, comm, off_diag, own,
                                           colocate_min_overlap)
        if mem_peer >= 0:
            tgt = int(core_of[mem_peer])
            if core_count[tgt] < machine.cluster_threshold:
                core_of[cl] = tgt           # factor 1: colocate
            else:
                core_of[cl] = nearby_core(tgt)
        elif ipc_peer >= 0:
            core_of[cl] = nearby_core(int(core_of[ipc_peer]))  # factor 2
        else:
            # factor 3: spread away from the strongest (weak) peer's region
            peer = _weak_peer(cl, placed, comm, off_diag)
            avoid = regions[int(core_of[peer])] if peer >= 0 else None
            core_of[cl] = diff_region_core(avoid)
        core_count[core_of[cl]] += 1

    return core_of


def _place_fast(comm: np.ndarray, off_diag: np.ndarray, own: np.ndarray,
                machine: Machine, cluster_order: np.ndarray,
                colocate_min_overlap: float) -> np.ndarray:
    """Array-native placement: masked argmin over precomputed hop/region
    arrays.  The greedy loop over clusters is inherently sequential; every
    per-core scan inside it is a vectorized argmin whose lowest-index
    tie-breaking matches the reference scans exactly, and the per-cluster
    peer selection reuses one preallocated masked buffer instead of fresh
    np.where temporaries."""
    p = comm.shape[0]
    n_cores = machine.n_cores
    thr = machine.cluster_threshold
    hops = machine.hop_matrix()
    regions = machine.region_array()
    n_regions = int(regions.max()) + 1
    # lexicographic (occupancy, hops) packed into one integer key
    key_scale = np.int64(hops.max() + 1)
    big = np.iinfo(np.int64).max

    core_of = np.full(p, -1, dtype=np.int32)
    core_count = np.zeros(n_cores, dtype=np.int64)
    free = core_count < thr               # maintained incrementally
    # occupancy part of the (occupancy, hops) key, maintained incrementally
    count_key = core_count * key_scale
    n_placed = 0
    region_rr = 0
    # multiply-masking: masked(row) = row * placed01 + (placed01 - 1)
    # keeps placed entries (row >= 0) and maps unplaced ones to exactly
    # -1.0, the reference oracle's np.where sentinel — three contiguous
    # vector ops per lookup, no boolean fancy indexing
    placed01 = np.zeros(p)
    neg = placed01 - 1.0
    srow = np.empty(p)
    crow = np.empty(p)

    def nearby_core(anchor: int) -> int:
        key = np.where(free, count_key + hops[anchor], big)
        key[anchor] = big
        c = int(np.argmin(key))
        return c if key[c] < big else int(np.argmin(core_count))

    def diff_region_core(avoid_region: int | None) -> int:
        nonlocal region_rr
        for off in range(n_regions):
            reg = (region_rr + off) % n_regions
            if avoid_region is not None and reg == avoid_region:
                continue
            mask = free & (regions == reg)
            if mask.any():
                region_rr = (reg + 1) % n_regions
                return int(np.argmin(np.where(mask, core_count, big)))
        return int(np.argmin(core_count))

    for cl in cluster_order:
        cl = int(cl)
        mem_peer = ipc_peer = -1
        if n_placed:
            np.multiply(off_diag[cl], placed01, out=srow)
            srow += neg
            np.multiply(comm[cl], placed01, out=crow)
            crow += neg
            j0 = int(np.argmax(srow))
            j1 = int(np.argmax(crow))
            # factor 1: already-placed peer sharing a dominant data structure
            if srow[j0] > colocate_min_overlap * min(own[cl], own[j0]):
                mem_peer = j0
            # factor 2: strongest already-placed communication peer
            if crow[j1] > 0:
                ipc_peer = j1
        if mem_peer >= 0:
            tgt = int(core_of[mem_peer])
            if core_count[tgt] < thr:
                core_of[cl] = tgt           # factor 1: colocate
            else:
                core_of[cl] = nearby_core(tgt)
        elif ipc_peer >= 0:
            core_of[cl] = nearby_core(int(core_of[ipc_peer]))  # factor 2
        else:
            # factor 3: spread away from the strongest (weak) peer's region
            avoid = None
            if n_placed:
                # masked entries sum to -2 < 0, so they never win the argmax
                irow = srow + crow
                j = int(np.argmax(irow))
                if irow[j] > 0:
                    avoid = int(regions[core_of[j]])
            core_of[cl] = diff_region_core(avoid)
        tgt = int(core_of[cl])
        core_count[tgt] += 1
        count_key[tgt] += key_scale
        free[tgt] = core_count[tgt] < thr
        placed01[cl] = 1.0
        neg[cl] = 0.0
        n_placed += 1

    return core_of


def round_robin_mapping(p: int, machine: Machine | None = None
                        ) -> MappingResult:
    """Locality-oblivious baseline mapping (for ablations)."""
    machine = machine or Machine.for_clusters(p)
    core_of = (np.arange(p) % machine.n_cores).astype(np.int32)
    return MappingResult(machine=machine, core_of=core_of, p=p)
