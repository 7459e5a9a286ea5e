"""FLOP / byte costs of the `cuda` stages of the partitioner's device path.

The port of `repro.core.pallas.cost`.  The JAX package lowers each jitted
stage at the pipeline's pow2-bucketed shapes and reads the compiled HLO's
loop-aware cost; the port has no HLO, so the counts here are analytic:
the bytes each stage's operators read and write once and the additions
the segment sum makes, at the same pow2 buckets (`_bucket`, as the JAX
helper's) and summed the same way.  Every key and index is int64, every
value float64, as `core/cuda/segsum.py` and `core/cuda/metrics.py` run
them.

`segment_sum_work` is the function's own work at its exact size: what
`chip_smoke.py` divides by the card's peaks for the segment-sum kernel's
bound, and what `analysis.hlo_cost` charges a `segment_sum` region.
"""
from __future__ import annotations

__all__ = ["keyed_sum_cost", "replica_csr_cost",
           "partitioner_finalize_cost", "interaction_cost",
           "segment_sum_work"]

_MIN_PAD = 8
_I64 = _F64 = 8


def _next_pow2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length() if x > 1 else 1


def _bucket(x: int, floor: int = _MIN_PAD) -> int:
    return max(_next_pow2(max(int(x), 1)), floor)


def _merge(*costs: dict) -> dict:
    return {"flops": sum(c["flops"] for c in costs),
            "hbm_bytes": sum(c["hbm_bytes"] for c in costs)}


def segment_sum_work(m: int, num_segments: int, value_size: int = _F64,
                     id_size: int = _I64) -> tuple[int, int]:
    """(operations, bytes) of one sorted-segment sum over `m` values into
    `num_segments`: one addition a value; the values and their ids read
    once, the sums written once."""
    return m, value_size * m + id_size * m + value_size * num_segments


def _keyed_sum(m: int, num_keys: int) -> dict:
    # the stable sort (keys read, sorted keys and the order written), the
    # gather of the values by the order, then the segment sum
    ops, seg_bytes = segment_sum_work(m, num_keys)
    return {"flops": float(ops),
            "hbm_bytes": float(3 * _I64 * m + 3 * _F64 * m + seg_bytes)}


def keyed_sum_cost(m: int, num_keys: int) -> dict:
    """Cost of one ``keyed_sum`` over an ``m``-element stream into
    ``num_keys`` buckets, at the pow2 bucket of both."""
    if m <= 0 or num_keys <= 0:
        return {"flops": 0.0, "hbm_bytes": 0.0}
    return _keyed_sum(_bucket(m), _bucket(num_keys, 1))


def _csr(klen: int, pn: int) -> dict:
    # keys v*p + c: src, dst and the assignment (twice) read, the keys
    # written, a multiply and an add a key; the sorted unique keys (a sort
    # and a pass, each reading and writing them); the n+1 bounds (a
    # multiply each) and their binary searches (bounds read, indptr
    # written); the members as key % p, cast to int32
    flops = 2 * klen + pn + klen
    nbytes = (3 * _I64 * klen + 4 * _I64 * klen + 3 * _I64 * pn
              + _I64 * klen + 4 * klen)
    return {"flops": float(flops), "hbm_bytes": float(nbytes)}


def replica_csr_cost(n: int, p: int, n_edges: int) -> dict:
    """Cost of `replica_csr`'s device stages for an ``n``-vertex graph
    with ``n_edges`` edges cut into ``p`` parts (2 keys an edge)."""
    if n_edges <= 0:
        return {"flops": 0.0, "hbm_bytes": 0.0}
    return _csr(_bucket(2 * n_edges), _bucket(n))


def partitioner_finalize_cost(n: int, m: int, p: int) -> dict:
    """Device work in `vertex_cut`'s `cuda` finalize: the replica CSR
    plus the two per-part reductions (loads, edge counts) over the
    ``m``-edge assignment stream."""
    return _merge(replica_csr_cost(n, p, m),
                  keyed_sum_cost(m, p), keyed_sum_cost(m, p))


def interaction_cost(n_members: int, p: int) -> dict:
    """Device work in `interaction_from_csr` for a replica set of
    ``n_members`` entries: the diagonal reference counts (p+1 keys) and
    the symmetrised star-comm reduction (p^2+1 keys), both streaming the
    member list.  The capped pairwise pass is size-class dependent and
    small next to these two; it is deliberately not modelled, as in the
    JAX package."""
    return _merge(keyed_sum_cost(n_members, p + 1),
                  keyed_sum_cost(n_members, p * p + 1))
