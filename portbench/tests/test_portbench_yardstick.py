"""The yardstick's arithmetic: attention pairs by enumeration, the model
FLOPs' products against `FlopCounterMode` on the reference, and the
busy time as a union of overlapping intervals."""
import itertools

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, yardstick
from portbench.tests.conftest import small_cell
from portbench.weights import Weights


def _enumerate_pairs(Sq, Sk, causal, window, q_offset):
    n = 0
    for i, j in itertools.product(range(Sq), range(Sk)):
        pos = i + q_offset
        if causal and j > pos:
            continue
        if window is not None and j <= pos - window:
            continue
        n += 1
    return n


@pytest.mark.parametrize("Sq,Sk,causal,window,q_offset", [
    (37, 37, True, None, 0),          # causal, square
    (37, 37, False, None, 0),         # no mask
    (29, 13, False, None, 0),         # cross attention, Sq != Sk
    (13, 29, False, None, 0),
    (40, 40, True, 7, 0),             # a window
    (5, 40, True, None, 35),          # queries after a prefix
    (6, 20, True, 4, 14),
])
def test_attention_pairs_equal_enumeration(Sq, Sk, causal, window, q_offset):
    assert yardstick.attention_pairs(Sq, Sk, causal, window, q_offset) == \
        _enumerate_pairs(Sq, Sk, causal, window, q_offset)


def test_fa_work_counts_the_published_pair_costs():
    c = yardstick.AttnCall(4, 2048, 2048, 15, 5, 64, 64, causal=True)
    pairs = 4 * 15 * 2048 * 2049 // 2
    assert yardstick.fa_fwd_work(c)[0] == pairs * (2 * 64 + 2 * 64)
    assert yardstick.fa_bwd_work(c)[0] == pairs * (4 * 64 + 4 * 64)
    # path A's forward bound (PERF.md): 0.19532 ms, operations
    assert yardstick.least_seconds(yardstick.fa_fwd_work(c)) == \
        pytest.approx(0.19532111e-3, rel=1e-6)


def _full_square_flops(c):
    # the reference computes every (query, key) pair and masks after
    return 2 * c.B * c.Hq * c.Sq * c.Sk * (c.Dqk + c.Dv)


@pytest.mark.parametrize("name", ["smollm-360m.train",
                                  "smollm-360m.prefill"])
def test_model_flops_match_flop_counter_on_the_reference(name):
    run = harness.Run(small_cell(name), 3, "cpu")
    m, tr = run.model, run.traffic
    W = Weights(run.ref.param_spec(m), 1, "cpu")
    P = W.views()
    S = tr["seq_len"]
    tokens = torch.randint(0, m["vocab_size"], (S,))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        run.ref.logits(P, m, run.ref.hidden(P, m, tokens))
    work = run.ref.forward_work(m, 1, S)
    dense = sum(2 * n * pos for n, pos in work["dense"])
    square = sum(_full_square_flops(c) for c in work["attention"])
    assert counter.get_total_flops() == dense + square
    kept = sum(yardstick.fa_fwd_work(c)[0] for c in work["attention"])
    assert yardstick.unit_work(work, training=False).flops == dense + kept
    assert yardstick.unit_work(work, training=True).flops == \
        3 * (dense + kept)


def test_published_step_flops():
    """smollm-360m's step, ~41.8 TFLOP: 6·N·16,384 + 3 × its attention,
    N the 361,821,120 parameters less the 62,400 of its norms (the table
    is in a product as the unembedding)."""
    cell = harness.load_cell("smollm-360m.train")
    run = harness.Run(cell, 1, "cpu")
    work = run.ref.forward_work(run.model, 4, 2048)
    step = {"dense": [(n, pos * 2) for n, pos in work["dense"]],
            "attention": work["attention"] * 2}
    flops = yardstick.unit_work(step, training=True).flops
    attn = 3 * 64 * (4 * 15 * 2048 * 2049 // 2) * 256   # 64 causal calls
    assert flops == 6 * (361_821_120 - 62_400) * 16_384 + attn
    assert flops == pytest.approx(41.8e12, rel=2e-3)


def test_union_counts_overlap_once():
    spans = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 45), (44, 50)]
    assert yardstick.union_seconds(spans, 0, 60) == 15 + 10 + 10
    assert yardstick.union_seconds(spans, 8, 42) == 7 + 10 + 2
    assert yardstick.gaps(spans, 0, 60) == [(15, 20), (30, 40), (50, 60)]
    assert yardstick.gaps(spans, -5, 12) == [(-5, 0)]
    # a sum of the spans' lengths would count the overlaps twice
    assert sum(e - s for s, e in spans) > yardstick.union_seconds(spans, 0, 60)
