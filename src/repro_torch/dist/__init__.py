"""Distributed sharded streaming partitioner (pipelined parse→cut
dataflow + periodic merges), on the host.

The scale-out front end for the vertex-cut framework: NDJSON dynamic
traces are parsed over W byte-range shards in parallel (`parse.py`,
with incremental cross-shard def-table resolution — `ShardMerger` /
`open_shard_parses`), and the greedy streaming cut runs on W resident
shard workers whose replica/load views are merged PowerGraph-oblivious
style at round barriers (`engine.py`, built on
`core.vertex_cut.ShardCutState`).

For NDJSON trace paths with `workers>1` the two stages *pipeline*:
merged parse shards stream straight into the cut workers, so cutting
starts while later shards are still parsing instead of behind a
whole-file parse barrier.  Merges are fixed-period or adaptive
(`divergence=` defers the expensive replica-mask merge until the
per-cluster load drift trips a bound), and workers run on a thread
pool (native kernel, GIL-released) or resident processes (pure-Python
engine on no-compiler hosts).

Contract: `workers=1` is bit-identical to the single-stream fast
engine; `workers>1` is deterministic for a fixed (W, seed,
merge_period, divergence) regardless of pool/parse scheduling, and its
cut quality and scaling are measured on the card's machine by
`chip_smoke.py` (phase 4c).
Consumed through `run_pipeline(..., backend="dist", workers=W)`,
`plan_graph`, the `repro_torch.trace` CLI (`--workers`, `--divergence`), or
directly:

    from repro_torch.dist import dist_ingest, dist_vertex_cut
    cut = dist_vertex_cut("trace.ndjson", p=64, workers=4)  # pipelined
    g = dist_ingest("trace.ndjson", workers=4)
    cut = dist_vertex_cut(g, p=64, workers=4, divergence=0.05)
"""
from .engine import (DEFAULT_MERGE_PERIOD, WORKER_POOLS, dist_vertex_cut,
                     shard_bounds)
from .parse import (ShardMerger, ShardParse, dist_ingest,
                    dist_ingest_with_stats, open_shard_parses,
                    shard_byte_ranges)

__all__ = [
    "DEFAULT_MERGE_PERIOD", "WORKER_POOLS", "dist_vertex_cut",
    "shard_bounds", "ShardMerger", "ShardParse", "dist_ingest",
    "dist_ingest_with_stats", "open_shard_parses", "shard_byte_ranges",
]
