"""Pluggable edge-weight models for trace ingestion.

The paper weights each dynamic dependence edge with the measured time of
the memory operation behind it (§3, rdtsc instrumentation).  Real traces
rarely ship timings, so ingestion derives weights from what the schema
does carry:

  bytes          — bytes of the value moved, from `use_tys[i]` (falling
                   back to the producer's `def_ty`, then 8).  This is the
                   same cost stand-in the JAX package's `jaxpr_to_graph`
                   uses, which is what makes its record->ingest
                   round trip exact.
  memop-latency  — classify the *consuming* opcode into the paper's
                   measured memory-op classes and charge every incoming
                   edge that class's latency in cycles (loads/stores/
                   RMWs dominate; ALU ops get the 1-cycle floor).

Both models clamp to >= 1.0, matching the JAX package's
`jaxpr_graph.add_edge`.  Register
new models with `register_weight_model`, or pass any callable with the
same signature straight to `ingest_trace`.
"""
from __future__ import annotations

from typing import Callable

from .schema import type_bytes

__all__ = ["WEIGHT_MODELS", "resolve_weight_model", "register_weight_model"]

# weight_fn(op, use_ty, producer_def_bytes) -> float
WeightFn = Callable[[str, "str | None", "float | None"], float]

_DEFAULT_BYTES = 8.0

# cycles per memory-op class (paper Table 2 machine: 2.4 GHz OoO cores,
# NUMA mesh; values are the usual measured orders: L2/remote-latency
# loads, store-buffer drains, call overhead incl. spills)
MEMOP_LATENCY_CYCLES = {
    "load": 200.0,
    "store": 100.0,
    "atomicrmw": 300.0,
    "cmpxchg": 300.0,
    "fence": 100.0,
    "call": 250.0,
    "invoke": 250.0,
    "getelementptr": 4.0,
    "alloca": 20.0,
}
_ALU_LATENCY = 1.0


def _bytes_model(op: str, use_ty: str | None,
                 producer_bytes: float | None) -> float:
    if use_ty is not None:
        return max(type_bytes(use_ty), 1.0)
    if producer_bytes is not None:
        return max(producer_bytes, 1.0)
    return _DEFAULT_BYTES


def _memop_latency_model(op: str, use_ty: str | None,
                         producer_bytes: float | None) -> float:
    return MEMOP_LATENCY_CYCLES.get(op, _ALU_LATENCY)


WEIGHT_MODELS: dict[str, WeightFn] = {
    "bytes": _bytes_model,
    "memop-latency": _memop_latency_model,
}


def register_weight_model(name: str, fn: WeightFn) -> None:
    WEIGHT_MODELS[name] = fn


def resolve_weight_model(model: "str | WeightFn") -> WeightFn:
    if callable(model):
        return model
    try:
        return WEIGHT_MODELS[model]
    except KeyError:
        raise ValueError(
            f"unknown weight model {model!r}; choose from "
            f"{sorted(WEIGHT_MODELS)} or pass a callable") from None
