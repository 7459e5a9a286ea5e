"""TRACE_SCHEMA v0 — NDJSON dynamic-trace interchange format.

One JSON object per line.  Instruction records (the dynamic trace; one
line per *executed* IR instruction, in program order):

  fn       function name (string)
  bb       basic-block label (string, stable per function)
  pp       program point "fn:bb:i<index>" (string; <index> is the
           instruction's position inside the block)
  op       opcode name (string; LLVM names for real traces, jaxpr
           primitive names for recorded jaxprs — ingest treats it as an
           opaque label except for weight-model classification)
  def      SSA value id defined by the instruction, or null for
           void-typed instructions (store, br, ...)
  uses     array of SSA value ids read by the instruction
  def_ty   optional type string for def (see `type_bytes`)
  use_tys  optional type strings parallel to `uses`

SSA value ids:
  const:*  constants (const:i32:7, const:fp:1.5, const:null, ...) —
           every *use* of a const id materialises a fresh graph vertex,
           mirroring how literals appear per-use in an SSA trace;
  v<N> / arg<N> / anything else — interned through a rolling def-table:
           a use binds to the most recent def of that id (re-executed
           blocks overwrite their defs, so loop-carried dependencies
           resolve to the previous iteration), and a use of a
           never-defined id materialises and registers a vertex (an
           incoming argument / live-in).

CFG records (optional, same file or a side file) carry a `kind` field
and describe the *static* control-flow graph plus enumerated paths:

  {"kind":"block","fn":..,"bb":..,"succs":[..]}
  {"kind":"edge","fn":..,"from":..,"to":..}
  {"kind":"path","fn":..,"path_id":N,"bbs":[..]}

`block`/`edge` records let the ingester check basic-block ordering of a
dynamic trace; `path` records let `replay_trace` expand a *static*
per-block instruction listing into a dynamic trace by walking the
recorded block sequence (the paper's instrumented execution order).

The schema is adopted verbatim from the ct-publicness repo's
TRACE_SCHEMA.md / CFG_SCHEMA.md (v0) so traces produced by its LLVM
instrumentation pass load unchanged.
"""
from __future__ import annotations

import functools
import re

__all__ = ["SCHEMA_VERSION", "TraceFormatError", "type_bytes",
           "encode_bytes_type", "CFG_KINDS"]

SCHEMA_VERSION = 0

# record kinds that belong to the CFG side-channel, not the instruction
# stream (CFG_SCHEMA v0)
CFG_KINDS = frozenset({"func_summary", "block", "edge", "path",
                       "pp_coverage", "path_summary", "trace_index"})

class TraceFormatError(ValueError):
    """A malformed trace/CFG record.

    Raised with the 1-based line number so a million-line trace is
    debuggable; `ingest_trace(on_error="skip")` counts these instead.
    """

    def __init__(self, lineno: int, message: str):
        super().__init__(f"trace line {lineno}: {message}")
        self.lineno = lineno


# ---------------------------------------------------------------------- #
# LLVM-ish type strings -> byte sizes (the `bytes` weight model)
# ---------------------------------------------------------------------- #
_SCALAR_BYTES = {
    "half": 2.0, "bfloat": 2.0, "float": 4.0, "double": 8.0,
    "fp128": 16.0, "x86_fp80": 16.0, "ppc_fp128": 16.0,
    "ptr": 8.0, "void": 0.0, "label": 0.0, "token": 0.0, "metadata": 0.0,
}
_VEC_OR_ARRAY = re.compile(r"^[<\[]\s*(\d+)\s+x\s+(.*?)\s*[>\]]$")


@functools.lru_cache(maxsize=4096)
def type_bytes(ty: str | None, default: float = 8.0) -> float:
    """Byte size of an LLVM-style type string.

    Handles iN integers, the floating/pointer scalars, `<N x T>` vectors
    and `[N x T]` arrays (recursively); `T*` pointer spellings map to 8.
    Unknown types (opaque structs, ...) fall back to `default` — a trace
    with exotic types still ingests, it just loses weight precision.
    """
    if ty is None:
        return default
    ty = ty.strip()
    if ty.endswith("*"):
        return 8.0
    if ty in _SCALAR_BYTES:
        return _SCALAR_BYTES[ty]
    if ty.startswith("i") and ty[1:].isdigit():
        return max(float((int(ty[1:]) + 7) // 8), 1.0)
    m = _VEC_OR_ARRAY.match(ty)
    if m:
        return float(m.group(1)) * type_bytes(m.group(2), default=default)
    return default


def encode_bytes_type(nbytes: float) -> str:
    """Inverse of `type_bytes` for integral byte counts: the recorder
    writes weights as `[N x i8]` so any NDJSON consumer reads them back
    with plain v0 type parsing (`i8` when N == 1)."""
    n = int(round(nbytes))
    return "i8" if n <= 1 else f"[{n} x i8]"
