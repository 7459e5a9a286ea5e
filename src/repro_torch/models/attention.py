"""Attention blocks: GQA/MQA (with local windows, softcap, RoPE/M-RoPE).

The port of `repro.models.attention`.  `GQA` provides:
  init(gen, cfg, dtype)                              -> params
  apply(p, cfg, x, positions, window, impl)          -> y          (full seq)
  apply_bidirectional(p, cfg, x, positions, impl)    -> y          (encoder)
  init_cache(cfg, batch, max_len, window, dtype, *, device) -> cache  (decode)
  apply_decode(p, cfg, x, cache, pos, window)        -> y, cache   (one token)

Caches for windowed layers are ring buffers of size min(window, max_len).
Unlike the JAX package's immutable arrays, `apply_decode` writes the new
key and value into the cache in place (one slot per step, no copy of the
cache) and returns the same dict.  Multi-head latent attention and
cross-attention are not ported yet.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from ..kernels.ref import NEG_INF
from .layers import dense, init_dense, mrope, rope

__all__ = ["GQA", "MLA", "CrossAttention"]


def _apply_rope(cfg: ModelConfig, x, positions):
    if cfg.mrope_sections is not None:
        return mrope(x, positions, tuple(cfg.mrope_sections),
                     cfg.rope_theta)
    return rope(x, positions, cfg.rope_theta)


class GQA:
    """Grouped-query attention (covers MHA and MQA)."""

    @staticmethod
    def init(gen: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32) -> dict:
        d, hd = cfg.d_model, cfg.head_dim
        return {
            "wq": init_dense(gen, d, cfg.n_heads * hd, dtype),
            "wk": init_dense(gen, d, cfg.n_kv_heads * hd, dtype),
            "wv": init_dense(gen, d, cfg.n_kv_heads * hd, dtype),
            "wo": init_dense(gen, cfg.n_heads * hd, d, dtype),
        }

    @staticmethod
    def _qkv(p, cfg, x, positions):
        B, S, _ = x.shape
        hd = cfg.head_dim
        q = dense(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
        k = dense(p["wk"], x).reshape(B, S, cfg.n_kv_heads, hd)
        v = dense(p["wv"], x).reshape(B, S, cfg.n_kv_heads, hd)
        q = _apply_rope(cfg, q, positions)
        k = _apply_rope(cfg, k, positions)
        return q, k, v

    @staticmethod
    def apply(p, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, window: int | None = None,
              impl: str = "auto") -> torch.Tensor:
        B, S, _ = x.shape
        q, k, v = GQA._qkv(p, cfg, x, positions)
        o = ops.attention(q, k, v, causal=True, window=window,
                          softcap=cfg.attn_softcap, impl=impl)
        return dense(p["wo"], o.reshape(B, S, -1))

    @staticmethod
    def apply_bidirectional(p, cfg: ModelConfig, x: torch.Tensor,
                            positions: torch.Tensor,
                            impl: str = "auto") -> torch.Tensor:
        """Encoder self-attention: no causal mask."""
        B, S, _ = x.shape
        q, k, v = GQA._qkv(p, cfg, x, positions)
        o = ops.attention(q, k, v, causal=False,
                          softcap=cfg.attn_softcap, impl=impl)
        return dense(p["wo"], o.reshape(B, S, -1))

    # -- decode ---------------------------------------------------------- #
    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   window: int | None = None, dtype=torch.float32, *,
                   device) -> dict:
        W = min(window, max_len) if window else max_len
        shape = (batch, W, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    @staticmethod
    def apply_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: dict,
                     pos: int, window: int | None = None
                     ) -> tuple[torch.Tensor, dict]:
        """x [B, 1, d]; pos: int absolute position."""
        B = x.shape[0]
        hd = cfg.head_dim
        dev = x.device
        if cfg.mrope_sections is not None:
            positions = torch.full((3, B, 1), pos, dtype=torch.int32,
                                   device=dev)           # text mode
        else:
            positions = torch.full((B, 1), pos, dtype=torch.int32,
                                   device=dev)
        q, k, v = GQA._qkv(p, cfg, x, positions)
        ck, cv = cache["k"], cache["v"]
        W = ck.shape[1]
        slot = pos % W  # ring buffer for windowed layers; == pos otherwise
        ck[:, slot] = k[:, 0].to(ck.dtype)
        cv[:, slot] = v[:, 0].to(cv.dtype)
        # positions of ring slots: slot i holds absolute pos p where
        # p % W == i and p <= pos and p > pos - W
        idx = torch.arange(W, device=dev)
        abs_pos = pos - ((pos - idx) % W)
        valid = (abs_pos >= 0) & (abs_pos <= pos)
        if window is not None:
            valid &= abs_pos > pos - window
        logits_mask = torch.where(valid, 0.0, NEG_INF)
        # grouped-query einsum: no repeat of the cache across heads
        Hkv = cfg.n_kv_heads
        G = cfg.n_heads // Hkv
        qg = (q * (hd ** -0.5)).reshape(B, 1, Hkv, G, hd)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), ck.float())
        if cfg.attn_softcap is not None:
            s = torch.tanh(s / cfg.attn_softcap) * cfg.attn_softcap
        s = s + logits_mask[None, None, None, None, :]
        probs = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(cv.dtype).float(),
                         cv.float())
        y = dense(p["wo"], o.reshape(B, 1, -1).to(x.dtype))
        return y, cache


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue 1, item 4 (MLA, the "
        f"encoder and the vision frontend)")


class MLA:
    """Multi-head latent attention (DeepSeek-V3): not ported yet."""

    @staticmethod
    def init(*args, **kw):
        _not_ported("MLA")

    apply = init_cache = apply_decode = init


class CrossAttention:
    """Encoder-decoder cross attention (seamless): not ported yet."""

    @staticmethod
    def init(*args, **kw):
        _not_ported("CrossAttention")

    apply = init
