"""Mixture-of-Experts layer with capacity-based scatter dispatch.

The port of `repro.models.moe`.  Routing is a softmax top-k; per token
group (the leading batch row), each (token, slot) takes the next free
position of its expert, and tokens past an expert's capacity C are
dropped.  Kept tokens are scattered into [E, G, C, d] expert buffers,
the experts run as batched matrix products over E (cuBLAS on the card),
and the outputs are gathered back and weighted by the renormalised
router probabilities.  The JAX package computes the same buffers as
[G, E, C, d]; here E leads, so the expert products batch over it without
a copy of the buffers or the weights.

The JAX package's semantics kept exactly:
  * ties in the router's top k go to the lower expert index (as
    `jax.lax.top_k`): a stable descending sort gives that order on the
    host and on the card alike;
  * a dropped (token, slot) is added, multiplied by 0, to (E-1, C-1);
    kept slots are unique, so the scatter-add gives the same bits in any
    order of its adds;
  * the combine reads a dropped slot at position C-1 (the reference's
    gather clamps an out-of-range index) and weights it by 0.

Under a mesh the routing, the dispatch by index and the combine run on
each rank's own token groups (`parallel.sharding.local_region`; no
DTensor rule covers `index_put` or a sort), and `maybe_shard` puts E over
'model' for the expert products and the groups back over 'data' after
them: the JAX package's call sites, its axes permuted to this layout.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..parallel.sharding import local_region, maybe_shard
from .layers import _normal, act_fn, init_dense, init_mlp, mlp

__all__ = ["MoE"]


def _router_probs(p, x: torch.Tensor) -> torch.Tensor:
    """[G, S, E] float32: the logits in x's dtype, the softmax in float32."""
    logits = x @ p["router"]["w"].to(x.dtype)
    return torch.softmax(logits.float(), dim=-1)


def _top_k(probs: torch.Tensor, k: int):
    """(top_p, top_e) of `jax.lax.top_k`: largest first, ties to the
    lower index."""
    top_e = torch.sort(probs, dim=-1, descending=True,
                       stable=True).indices[..., :k]
    return probs.gather(-1, top_e), top_e


class MoE:

    @staticmethod
    def init(gen: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32) -> dict:
        d = cfg.d_model
        ff = cfg.moe_d_ff or cfg.d_ff
        E = cfg.n_experts
        scale = (2.0 / (d + ff)) ** 0.5
        p = {
            "router": init_dense(gen, d, E, dtype),
            "w_in": _normal((E, d, ff), gen, dtype, scale),
            "w_gate": _normal((E, d, ff), gen, dtype, scale),
            "w_out": _normal((E, ff, d), gen, dtype, scale),
        }
        if cfg.n_shared_experts:
            p["shared"] = init_mlp(gen, d, ff * cfg.n_shared_experts, dtype)
        return p

    @staticmethod
    def apply(p, cfg: ModelConfig, x: torch.Tensor,
              capacity_factor: float | None = None) -> torch.Tensor:
        """x [G, S, d] (G token groups; in decode each token is a group)."""
        G, S, d = x.shape
        E, k = cfg.n_experts, cfg.experts_per_token
        cf = capacity_factor or cfg.capacity_factor
        C = max(int(S * k * cf / E), 4)
        grp = ("data", None, None)          # each group on its own rank
        top_p, top_e, pos, keep = local_region(
            lambda probs: _route(probs, k, C), (_router_probs(p, x),),
            (grp,), [grp] * 4)
        buffers = local_region(lambda x, e, q, m: _dispatch(x, e, q, m, E, C),
                               (x, top_e, pos, keep), (grp,) * 4,
                               (None, "data", None, None))
        # the expert products want E over 'model' ([E, G, C, d] here,
        # [G, E, C, d] in the JAX package)
        buffers = maybe_shard(buffers, "model", "data", None, None)

        # expert compute, batched over E: [E, G*C, d] x [E, d, ff]
        xb = buffers.view(E, G * C, d)
        h_in = torch.bmm(xb, p["w_in"].to(x.dtype))
        h_gate = torch.bmm(xb, p["w_gate"].to(x.dtype))
        h = act_fn(cfg.hidden_act, h_gate) * h_in
        del h_in, h_gate
        out = torch.bmm(h, p["w_out"].to(x.dtype)).view(E, G, C, d)
        del h

        # back to the tokens' owners
        out = maybe_shard(out, None, "data", None, None)
        y = local_region(_combine, (out, top_e, pos, keep, top_p),
                         ((None, "data", None, None),) + (grp,) * 4, grp)
        y = maybe_shard(y, "data", None, None)
        if cfg.n_shared_experts:
            y = y + mlp(p["shared"], x, cfg.hidden_act)
        return y

    @staticmethod
    def aux_loss(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
        """Load-balancing auxiliary loss (Switch-style), float32."""
        probs = _router_probs(p, x)
        E = cfg.n_experts
        onehot = local_region(
            lambda pr: torch.nn.functional.one_hot(
                _top_k(pr, cfg.experts_per_token)[1], E).float(),
            (probs,), (("data", None, None),), ("data", None, None, None))
        frac = onehot.mean((0, 1, 2))
        imp = probs.mean((0, 1))
        return cfg.n_experts * torch.sum(frac * imp)


def _route(probs: torch.Tensor, k: int, C: int):
    """(top_p renormalised, top_e, pos, keep), each [G, S, k]: each
    (token, slot)'s position within its expert, per group, counted in
    token-major (token, slot) order, and whether it is below C."""
    G, S, E = probs.shape
    top_p, top_e = _top_k(probs, k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    onehot = torch.nn.functional.one_hot(top_e, E)      # [G, S, k, E]
    pos_in_e = onehot.reshape(G, S * k, E).cumsum(1).reshape(
        G, S, k, E) - 1
    pos = pos_in_e.gather(-1, top_e[..., None])[..., 0]
    return top_p, top_e, pos, pos < C


def _dispatch(x, top_e, pos, keep, E: int, C: int) -> torch.Tensor:
    """The [E, G, C, d] expert buffers; dropped rows are zeroed before
    the add."""
    G, S, k = top_e.shape
    g_idx = torch.arange(G, device=x.device)[:, None, None].expand(G, S, k)
    e_idx = torch.where(keep, top_e, E - 1)
    p_idx = torch.where(keep, pos, C - 1)
    rows = x[:, :, None, :] * keep[..., None].to(x.dtype)
    return x.new_zeros((E, G, C, x.shape[-1])).index_put(
        (e_idx, g_idx, p_idx), rows, accumulate=True)


def _combine(out, top_e, pos, keep, top_p) -> torch.Tensor:
    """[G, S, d]: the clamped gather from `out` [E, G, C, d], weighted by
    top_p for kept slots."""
    G, S, k = top_e.shape
    C = out.shape[2]
    g_idx = torch.arange(G, device=out.device)[:, None, None].expand(G, S, k)
    vals = out[top_e, g_idx, pos.clamp(max=C - 1)]      # [G, S, k, d]
    w = (top_p * keep).to(vals.dtype)[..., None]
    return (vals * w).sum(dim=2)
