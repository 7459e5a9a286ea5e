"""The layers the reference models share, on one sequence at a time.

A weight `w` of a dense layer is [d_in, d_out] and applies as `x @ w`.
RMSNorm scales by (1 + scale), the scale stored as an offset from one.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = float("-inf")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """x [S, d]: x / sqrt(mean(x^2) + eps) * (1 + scale)."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x [S, H, D] at positions 0..S-1: the first and
    second halves of each head are the two coordinates of D/2 rotations,
    rotation i turning at theta^(-2i/D) a position."""
    S, _, D = x.shape
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float32,
                                  device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    sin, cos = ang.sin()[:, None, :], ang.cos()[:, None, :]
    a, b = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> torch.Tensor:
    """Softmax attention of q [Sq, Hq, D] over k, v [Sk, Hkv, D]; query
    head h reads key head h // (Hq / Hkv); with `causal`, query i sees
    keys 0..i.  Returns [Sq, Hq * D]."""
    Sq, Hq, D = q.shape
    Sk, Hkv, _ = k.shape
    group = Hq // Hkv
    qh = q.reshape(Sq, Hkv, group, D).permute(1, 2, 0, 3)      # [Hkv, g, Sq, D]
    kh = k.permute(1, 0, 2)[:, None]                             # [Hkv, 1, Sk, D]
    vh = v.permute(1, 0, 2)[:, None]
    s = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(D)    # [Hkv, g, Sq, Sk]
    if causal:
        keep = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    o = torch.matmul(torch.softmax(s, dim=-1), vh)               # [Hkv, g, Sq, D]
    return o.permute(2, 0, 1, 3).reshape(Sq, Hq * D)


def act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    raise ValueError(f"unknown activation {name!r}")


def gated_mlp(x, w_in, w_gate, w_out, name: str) -> torch.Tensor:
    """w_out(act(x w_gate) * (x w_in))."""
    return (act(name, x @ w_gate) * (x @ w_in)) @ w_out


def dense_std(d_in: int, d_out: int) -> float:
    return math.sqrt(2.0 / (d_in + d_out))


def attn_spec(prefix: tuple, d: int, hq: int, hkv: int, hd: int) -> list:
    """(path, shape, std) of an attention block's four projections."""
    return [(prefix + ("wq", "w"), (d, hq * hd), dense_std(d, hq * hd)),
            (prefix + ("wk", "w"), (d, hkv * hd), dense_std(d, hkv * hd)),
            (prefix + ("wv", "w"), (d, hkv * hd), dense_std(d, hkv * hd)),
            (prefix + ("wo", "w"), (hq * hd, d), dense_std(hq * hd, d))]


def mlp_spec(prefix: tuple, d: int, ff: int) -> list:
    return [(prefix + ("w_in", "w"), (d, ff), dense_std(d, ff)),
            (prefix + ("w_gate", "w"), (d, ff), dense_std(d, ff)),
            (prefix + ("w_out", "w"), (ff, d), dense_std(ff, d))]


def self_attention(P, prefix: tuple, x: torch.Tensor, m: dict,
                   causal: bool) -> torch.Tensor:
    """GQA self-attention of x [S, d] with RoPE on q and k."""
    S = x.shape[0]
    hd = head_dim(m)
    q = (x @ P[prefix + ("wq", "w")]).reshape(S, m["n_heads"], hd)
    k = (x @ P[prefix + ("wk", "w")]).reshape(S, m["n_kv_heads"], hd)
    v = (x @ P[prefix + ("wv", "w")]).reshape(S, m["n_kv_heads"], hd)
    q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    return attention(q, k, v, causal) @ P[prefix + ("wo", "w")]


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]
