"""The benchmark's arithmetic: the card's peaks, the operations and bytes
of a flash-attention call, a model's FLOPs from its shapes, and the
device's busy time as a union of intervals.

Nothing here reads the program.  The counts follow from the shapes and
masks alone, so a share of a roofline reads the same work whatever
implements the kernel.

Peaks (NVIDIA H100 SXM data sheet, dense): 495 TFLOP/s TF32, so 165
TFLOP/s for float32 computed as three TF32 products, the fastest route on
the card that keeps float32's accuracy; HBM3 at 3.35 TB/s.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PEAK_FLOPS", "PEAK_BYTES_PER_S", "AttnCall", "attention_pairs",
           "fa_fwd_work", "fa_bwd_work", "least_seconds", "UnitWork",
           "unit_work", "union_seconds", "gaps"]

PEAK_FLOPS = 495e12 / 3          # float32 as three TF32 products
PEAK_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class AttnCall:
    """One attention call: q [B, Sq, Hq, Dqk], k [B, Sk, Hkv, Dqk],
    v [B, Sk, Hkv, Dv], the output [B, Sq, Hq, Dv]; `causal` masks keys
    after the query's position, `window` keeps the last `window` keys."""
    B: int
    Sq: int
    Sk: int
    Hq: int
    Hkv: int
    Dqk: int
    Dv: int
    causal: bool
    window: int | None = None
    q_offset: int = 0
    elt: int = 4                 # bytes an element


def attention_pairs(Sq: int, Sk: int, causal: bool,
                    window: int | None = None, q_offset: int = 0) -> int:
    """The (query, key) pairs the mask keeps, for one (batch, head):
    query i sits at position i + q_offset and sees key j when j <= its
    position (causal) and j > its position - window (a window)."""
    pos = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(pos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = (np.maximum(pos - window + 1, 0) if window is not None
          else np.zeros(Sq, dtype=np.int64))
    return int(np.maximum(hi - lo + 1, 0).sum())


def _pairs(c: AttnCall) -> int:
    return c.B * c.Hq * attention_pairs(c.Sq, c.Sk, c.causal, c.window,
                                        c.q_offset)


def fa_fwd_work(c: AttnCall) -> tuple[int, int]:
    """(operations, bytes) of the forward: S = QK^T and O = PV, 2·Dqk +
    2·Dv a kept pair; q, k, v read once and the output written once."""
    ops = _pairs(c) * (2 * c.Dqk + 2 * c.Dv)
    q = c.B * c.Sq * c.Hq * c.Dqk
    k = c.B * c.Sk * c.Hkv * c.Dqk
    v = c.B * c.Sk * c.Hkv * c.Dv
    o = c.B * c.Sq * c.Hq * c.Dv
    return ops, (q + k + v + o) * c.elt


def fa_bwd_work(c: AttnCall) -> tuple[int, int]:
    """(operations, bytes) of the backward as the function needs it: dP =
    dO V^T, dV = P^T dO, dQ = dS K and dK = dS^T Q, 4·Dqk + 4·Dv a kept
    pair, and no recompute of S; q, k, v, the output, its gradient and
    the rows' float32 log-sum-exp read once, dq, dk and dv written once."""
    ops = _pairs(c) * (4 * c.Dqk + 4 * c.Dv)
    q = c.B * c.Sq * c.Hq * c.Dqk
    k = c.B * c.Sk * c.Hkv * c.Dqk
    v = c.B * c.Sk * c.Hkv * c.Dv
    o = c.B * c.Sq * c.Hq * c.Dv
    lse = c.B * c.Hq * c.Sq * 4
    return ops, (2 * (q + k + v) + 2 * o) * c.elt + lse


def least_seconds(work: tuple[int, int]) -> float:
    """The least time of (operations, bytes): the larger of the
    operations at the peak rate and the bytes at the memory rate."""
    ops, nbytes = work
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


@dataclasses.dataclass(frozen=True)
class UnitWork:
    """The model's work in one unit (a train step or a request): its
    FLOPs as the mathematics needs them, those of its dense matrix
    products among them, and the attention calls of the forward and of
    the backward."""
    flops: float
    fwd_calls: tuple
    bwd_calls: tuple
    dense_flops: float = 0.0


def unit_work(forward: dict, training: bool) -> UnitWork:
    """`forward`, as a reference model's `forward_work` gives it:
    "dense", a list of (parameters, positions) of the matrix products
    (each parameter a multiply and an add at each position), and
    "attention", the list of `AttnCall`s.  A training step is three
    times the forward's FLOPs (the forward, and the backward's two
    products a product) and runs each attention call's backward."""
    dense = sum(2.0 * n * pos for n, pos in forward["dense"])
    flops = dense + sum(fa_fwd_work(c)[0] for c in forward["attention"])
    calls = tuple(forward["attention"])
    if training:
        return UnitWork(3.0 * flops, calls, calls, 3.0 * dense)
    return UnitWork(flops, calls, (), dense)


def union_seconds(intervals, lo: float, hi: float) -> float:
    """The length of the union of (start, end) intervals inside
    [lo, hi]: the time in which at least one of them runs, never a sum,
    so that overlapping intervals count once."""
    return sum(e - s for s, e in _merged(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in _merged(intervals, lo, hi):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def _merged(intervals, lo: float, hi: float) -> list:
    spans = sorted((max(s, lo), min(e, hi)) for s, e in intervals
                   if e > lo and s < hi)
    merged: list = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged
