"""Dynamic-trace ingestion front end (NDJSON traces -> streaming IRGraphs).

The JAX package's `trace`, ported: the paper's pipeline starts from
instrumented dynamic LLVM traces (§3: basic-block execution order +
per-memory-op timing).  This package adopts the ct-publicness NDJSON
TRACE/CFG schemas (v0) as the interchange format, streams million-line
traces into `IRGraph`s with constant per-chunk memory (`ingest.py`),
replays static listings along CFG paths (`replay_trace`) and derives
edge weights through pluggable models (`weights.py`), and writes the
same schema back out from captured PyTorch programs (`record.py`) —
giving a round-trip oracle against `core.op_graph.trace_to_graph`.
Graphs are array-identical to the JAX package's for the same input, and
`.rtb` containers move between the two packages unchanged.

Two fast paths sit in front of the sequential interpreter:

  * `scan.py` — a vectorized structural-index NDJSON scanner that
    parses compact machine-written traces with numpy byte passes and
    falls back to the sequential path on anything outside its subset,
    or past the size budget where its batch passes stop winning
    (``REPRO_TRACE_SCAN_MAX_MB``, default 24; ``REPRO_TRACE_SCANNER=0``
    disables it, ``=1`` forces it at any size);
  * `binfmt.py` — the `.rtb` binary columnar trace container v1 written
    by ``python -m repro_torch.trace convert``; `.rtb` paths are accepted
    everywhere NDJSON paths are and load at memory speed.

CLI: ``python -m repro_torch.trace {inspect,convert,partition,record,synth}``.
"""
from .schema import SCHEMA_VERSION, TraceFormatError, type_bytes
from .weights import (WEIGHT_MODELS, register_weight_model,
                      resolve_weight_model)
from .ingest import (CFG, TraceStats, ingest_trace, ingest_trace_with_stats,
                     load_cfg, load_graph, replay_trace)
from .binfmt import (BINARY_MAGIC, BINARY_VERSION, BinaryFormatError,
                     is_binary_trace_path, iter_trace_bin_chunks,
                     read_trace_bin, read_trace_bin_header, write_trace_bin)
from .scan import (SCAN_MAX_MB_ENV, SCANNER_ENV, scanner_enabled,
                   scanner_mode, try_scan_ingest)
from .record import DEMO_PROGRAMS, demo_program, record_fn, record_graph
from .synth import iter_synthetic_trace, synthesize_trace

__all__ = [
    "SCHEMA_VERSION", "TraceFormatError", "type_bytes",
    "WEIGHT_MODELS", "register_weight_model", "resolve_weight_model",
    "CFG", "TraceStats", "ingest_trace", "ingest_trace_with_stats",
    "load_cfg", "load_graph", "replay_trace",
    "BINARY_MAGIC", "BINARY_VERSION", "BinaryFormatError",
    "is_binary_trace_path", "iter_trace_bin_chunks", "read_trace_bin",
    "read_trace_bin_header", "write_trace_bin",
    "SCAN_MAX_MB_ENV", "SCANNER_ENV", "scanner_enabled", "scanner_mode",
    "try_scan_ingest",
    "DEMO_PROGRAMS", "demo_program", "record_fn", "record_graph",
    "iter_synthetic_trace", "synthesize_trace",
]
