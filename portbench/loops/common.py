"""What the drive loops share: inputs made from the seed, and the
numbers that compare the program with the reference."""
from __future__ import annotations

import statistics

import torch

from ..textgen import TextGen

__all__ = ["make_inputs", "rel_gap", "worst_leaf_gap"]


def make_inputs(run, count: int, shape: tuple) -> dict:
    """`count` units of inputs on the device: "tokens" int32 [count,
    *shape, seq], unit u's rows batch u of the text generator."""
    tr, m = run.traffic, run.model
    gen = TextGen(m["vocab_size"], tr["seq_len"], run.seeds["text"],
                  **tr.get("text", {}))
    rows = 1
    for n in shape:
        rows *= n
    tokens = torch.stack([torch.from_numpy(gen.batch(u, rows))
                          for u in range(count)])
    return {"tokens": tokens.reshape(count, *shape, tr["seq_len"])
            .to(run.device)}


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def worst_leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The largest gap between the program's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    keep = list(ref) if keep is None else keep
    med = statistics.median(ref[p] for p in keep)
    return max(abs(prog[p] - ref[p]) / max(ref[p], med) for p in keep)
