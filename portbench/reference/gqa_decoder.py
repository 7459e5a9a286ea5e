"""A decoder-only transformer with grouped-query attention (SmolLM's
Llama-style block): token embeddings; in each layer RMSNorm, causal GQA
self-attention with RoPE and a residual, RMSNorm, a gated MLP and a
residual; a final RMSNorm; the unembedding, tied to the embedding table
where the configuration says so.  Positions 0..S-1 of each sequence.
"""
from __future__ import annotations

import torch

from .common import (attn_spec, gated_mlp, head_dim, mlp_spec, rms_norm,
                     self_attention)

__all__ = ["param_spec", "forward_work", "hidden", "logits"]


def param_spec(m: dict) -> list:
    """(path, shape, std) of every weight, std None for a norm's scale
    (zeros); the paths name the tree that the program's model takes."""
    d, V = m["d_model"], m["vocab_size"]
    spec = [(("embed", "table"), (V, d), 0.02)]
    if not m["tie_embeddings"]:
        spec.append((("embed", "unembed"), (d, V), 0.02))
    spec.append((("final_ln", "scale"), (d,), None))
    for i in range(m["n_layers"]):
        L = ("layers", i)
        spec += [(L + ("ln1", "scale"), (d,), None),
                 (L + ("ln2", "scale"), (d,), None)]
        spec += attn_spec(L + ("attn",), d, m["n_heads"], m["n_kv_heads"],
                          head_dim(m))
        spec += mlp_spec(L + ("mlp",), d, m["d_ff"])
    return spec


def block_params(m: dict) -> int:
    """Parameters of one block's matrix products."""
    d, hd = m["d_model"], head_dim(m)
    attn = d * hd * (2 * m["n_heads"] + 2 * m["n_kv_heads"])
    return attn + 3 * d * m["d_ff"]


def forward_work(m: dict, rows: int, seq: int) -> dict:
    """The forward's matrix products as (parameters, positions) and its
    attention calls, for `rows` sequences of `seq` tokens."""
    from ..yardstick import AttnCall
    tokens = rows * seq
    dense = [(m["n_layers"] * block_params(m), tokens),
             (m["d_model"] * m["vocab_size"], tokens)]   # the unembedding
    hd = head_dim(m)
    call = AttnCall(rows, seq, seq, m["n_heads"], m["n_kv_heads"], hd, hd,
                    causal=True)
    return {"dense": dense, "attention": [call] * m["n_layers"]}


def hidden(P, m: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The final normed hidden states [S, d] of one sequence."""
    eps, act = m["norm_eps"], m["hidden_act"]
    h = P[("embed", "table")][tokens]
    for i in range(m["n_layers"]):
        L = ("layers", i)
        h = h + self_attention(P, L + ("attn",),
                               rms_norm(h, P[L + ("ln1", "scale")], eps),
                               m, causal=True)
        x = rms_norm(h, P[L + ("ln2", "scale")], eps)
        h = h + gated_mlp(x, P[L + ("mlp", "w_in", "w")],
                          P[L + ("mlp", "w_gate", "w")],
                          P[L + ("mlp", "w_out", "w")], act)
    return rms_norm(h, P[("final_ln", "scale")], eps)


def logits(P, m: dict, h: torch.Tensor) -> torch.Tensor:
    """The unembedding of hidden states h [..., d]."""
    if m["tie_embeddings"]:
        return h @ P[("embed", "table")].T
    return h @ P[("embed", "unembed")]
