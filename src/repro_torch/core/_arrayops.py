"""Shared vectorized edge-array helpers for the partitioners.

Used by `graph.IRGraph.csr`, the METIS-like coarsener in `edge_cut`, the
vectorized `_finalize` of `vertex_cut`, and the array-native
mapping/simulator fast paths — one implementation of the sort-based
grouping and segment primitives instead of several hand-rolled loops.
"""
from __future__ import annotations

import numpy as np

__all__ = ["csr_adjacency", "dedup_edges", "replica_csr",
           "masks_to_replica_csr", "segment_entries",
           "interaction_from_csr", "star_triples",
           "merge_limb_masks", "merge_deltas"]


def csr_adjacency(n: int, src: np.ndarray, dst: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Undirected CSR adjacency: (indptr, neighbor ids, edge ids)."""
    m = len(src)
    ends = np.concatenate([src, dst])
    other = np.concatenate([dst, src])
    eid = np.concatenate([np.arange(m), np.arange(m)])
    order = np.argsort(ends, kind="stable")
    ends, other, eid = ends[order], other[order], eid[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, ends + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, other.astype(np.int32), eid.astype(np.int64)


def dedup_edges(n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge parallel edges, summing their weights."""
    key = src.astype(np.int64) * n + dst
    order = np.argsort(key, kind="stable")
    key, src, dst, w = key[order], src[order], dst[order], w[order]
    first = np.ones(len(key), dtype=bool)
    first[1:] = key[1:] != key[:-1]
    idx = np.cumsum(first) - 1
    ws = np.zeros(int(first.sum()))
    np.add.at(ws, idx, w)
    return src[first], dst[first], ws


def replica_csr(n: int, p: int, src: np.ndarray, dst: np.ndarray,
                assignment: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-vertex replica sets A(v) as a CSR over sorted cluster ids.

    A vertex's replica set is the set of clusters hosting an incident
    edge; vectorized as a unique-sort over (vertex, cluster) pairs.
    Returns (indptr int64[n+1], flat int32[sum |A(v)|]).  The device
    version is `cuda.metrics.replica_csr` (bit-identical).
    """
    v = np.concatenate([src, dst]).astype(np.int64)
    c = np.concatenate([assignment, assignment]).astype(np.int64)
    key = np.unique(v * p + c)
    indptr = np.searchsorted(key, np.arange(n + 1, dtype=np.int64) * p)
    return indptr.astype(np.int64), (key % p).astype(np.int32)


def _masks_block_nonzero(rows: np.ndarray, p: int
                         ) -> tuple[np.ndarray, np.ndarray]:
    """(local vertex ids, cluster ids) of the set bits in one block of
    bitmask limb rows, in (vertex, cluster)-sorted order."""
    k, limbs = rows.shape
    # '<u8' pins the limb byte layout so bit j of limb l is cluster
    # 64*l + j on any host endianness
    bits = np.unpackbits(rows.astype("<u8").view(np.uint8).reshape(k, -1),
                         axis=1, bitorder="little")
    vs, cs = np.nonzero(bits[:, :p])
    return vs, cs.astype(np.int32)


def masks_to_replica_csr(masks: np.ndarray, n: int, limbs: int, p: int,
                         executor=None, shards: int = 1
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Replica CSR decoded straight from bitmask limb rows.

    The streaming engines maintain `uint64[n*limbs]` A(v) rows as they
    place edges — after the final shard merge those rows ARE the replica
    sets, so the finalize can skip the sort-based `replica_csr` over all
    2|E| endpoints and decode n*limbs words instead.  Bit-identical to
    `replica_csr(n, p, src, dst, assignment)` whenever `masks` equals
    the assignment-derived sets (row-major `np.nonzero` yields each
    vertex's clusters in ascending order, exactly the sorted-CSR
    contract).  `masks` shorter than `n*limbs` is padded with empty
    rows (vertices the stream never grew to have empty replica sets).

    With `executor`/`shards` the decode fans out over contiguous vertex
    ranges (numpy releases the GIL in the unpack/nonzero passes), and
    the per-shard results concatenate in range order — the output is
    independent of `executor`, `shards`, and scheduling.
    """
    if len(masks) < n * limbs:
        padded = np.zeros(n * limbs, dtype=np.uint64)
        padded[:len(masks)] = masks
        masks = padded
    rows = masks[:n * limbs].reshape(n, limbs)
    shards = max(1, min(int(shards), max(1, n)))
    bounds = [n * s // shards for s in range(shards + 1)]
    blocks = [rows[a:b] for a, b in zip(bounds[:-1], bounds[1:]) if a < b]
    if executor is not None and len(blocks) > 1:
        parts = list(executor.map(lambda blk: _masks_block_nonzero(blk, p),
                                  blocks))
    else:
        parts = [_masks_block_nonzero(blk, p) for blk in blocks]
    counts = np.zeros(n, dtype=np.int64)
    flats = []
    for (vs, cs), a in zip(parts, bounds[:-1]):
        if len(vs):
            counts[a:a + int(vs[-1]) + 1] = np.bincount(vs)
        flats.append(cs)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    flat = (np.concatenate(flats) if flats
            else np.zeros(0, dtype=np.int32))
    return indptr, flat


# ---------------------------------------------------------------------- #
# shard-merge primitives (repro.dist periodic state merges)
# ---------------------------------------------------------------------- #
def merge_limb_masks(masks: "list[np.ndarray]") -> np.ndarray:
    """OR-combine per-shard replica bitmask limb arrays into one.

    Every shard keeps its own `uint64[n*limbs]` A(v) bitmask rows (the
    chunked-limb layout is shard-local by construction); the merged
    array is their element-wise union — order-free, so any combine
    order yields the identical result.
    """
    if not masks:
        raise ValueError("need at least one mask array to merge")
    out = masks[0].copy()
    for m in masks[1:]:
        np.bitwise_or(out, m, out=out)
    return out


def merge_deltas(snapshot: np.ndarray,
                 locals_: "list[np.ndarray]") -> np.ndarray:
    """Reduce per-shard accumulator views against their common snapshot.

    Each shard's `local` equals `snapshot + (its own contributions)`;
    the merged value is `snapshot + sum_s (local_s - snapshot)`,
    accumulated in shard order so the result is deterministic for a
    fixed shard list (exact for integer arrays, fixed-rounding for
    float loads).  Used for the periodic `load` / remaining-degree
    merges of the distributed partitioner.
    """
    out = snapshot.copy()
    for loc in locals_:
        out += loc - snapshot
    return out


# ---------------------------------------------------------------------- #
# segment primitives over a replica CSR (indptr, members)
# ---------------------------------------------------------------------- #
def segment_entries(indptr: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-entry segment bookkeeping for a CSR.

    Returns (seg_id, first_pos, sizes): for every flat entry its segment
    (vertex) id and the flat position of that segment's first entry, plus
    the per-segment sizes.  `first_pos[i] == i` marks segment heads.
    """
    sizes = np.diff(indptr)
    seg_id = np.repeat(np.arange(len(sizes), dtype=np.int64), sizes)
    return seg_id, indptr[seg_id], sizes


def star_triples(indptr: np.ndarray, members: np.ndarray,
                 vertex_bytes: np.ndarray | None = None
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(owner, replica, bytes) triples of the replica-sync star pattern.

    The owner of a vertex is the lowest cluster id in A(v) (members are
    sorted per vertex); every other member receives one synchronisation
    message of `vertex_bytes[v]` bytes.  Triples come out grouped by
    vertex in member order — the exact order the reference loops emit.
    """
    seg_id, first_pos, _ = segment_entries(indptr)
    non_owner = np.arange(len(members), dtype=np.int64) != first_pos
    owners = members[first_pos[non_owner]]
    replicas = members[non_owner]
    if vertex_bytes is None:
        b = np.ones(len(replicas))
    else:
        b = np.asarray(vertex_bytes, dtype=np.float64)[seg_id[non_owner]]
    return owners, replicas, b


def interaction_from_csr(indptr: np.ndarray, members: np.ndarray, p: int,
                         vertex_bytes: np.ndarray | None = None,
                         pairwise_cap: int = 64
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized (comm[P,P], shared[P,P]) from a replica CSR.

    Same semantics as the reference loop in
    `mapping.cluster_interaction_graphs`: star-shaped owner->replica comm,
    diagonal reference counts, and capped pairwise shared counts (vertices
    replicated to more than `pairwise_cap` clusters skip the O(|A|^2)
    pairs but keep their star traffic).
    """
    comm = np.zeros((p, p))
    shared = np.zeros((p, p))
    if len(members) == 0:
        return comm, shared
    mem = members.astype(np.int64)
    # diagonal: vertices referencing each cluster (members unique per seg)
    diag = np.bincount(mem, minlength=p).astype(np.float64)
    shared.flat[:: p + 1] = diag

    # star comm as a sparse flat scatter of unique (owner, replica) keys —
    # the interaction pattern is sparse, so never materialise O(p^2)
    # temporaries (a dense bincount/transpose costs more than the whole
    # mapping at p >= 1024)
    owners, replicas, b = star_triples(indptr, members, vertex_bytes)
    if len(owners):
        key = owners.astype(np.int64) * p + replicas
        uq, inv = np.unique(key, return_inverse=True)
        sums = np.bincount(inv, weights=b)
        comm.flat[uq] += sums            # owner != replica: off-diagonal
        comm.flat[(uq % p) * p + uq // p] += sums

    sizes = np.diff(indptr)
    keys = []
    for s in np.unique(sizes):
        s = int(s)
        if s < 2 or s > pairwise_cap:
            continue
        base = indptr[:-1][sizes == s]
        iu, ju = np.triu_indices(s, k=1)
        x = mem[(base[:, None] + iu[None, :]).ravel()]
        y = mem[(base[:, None] + ju[None, :]).ravel()]
        keys.append(x * p + y)           # members sorted, so x < y always
    if keys:
        uq, cnt = np.unique(np.concatenate(keys), return_counts=True)
        shared.flat[uq] += cnt
        shared.flat[(uq % p) * p + uq // p] += cnt
    return comm, shared
