"""Attention blocks: GQA/MQA (with local windows, softcap, RoPE/M-RoPE),
multi-head latent attention (MLA, DeepSeek-V3) and encoder-decoder cross
attention (seamless).

The port of `repro.models.attention`.  `GQA` and `MLA` provide:
  init(gen, cfg, dtype)                              -> params
  apply(p, cfg, x, positions, window, impl)          -> y          (full seq)
  apply_bidirectional(p, cfg, x, positions, impl)    -> y          (encoder)
  init_cache(cfg, batch, max_len, window, dtype, *, device) -> cache  (decode)
  apply_decode(p, cfg, x, cache, pos, window)        -> y, cache   (one token)

(`apply_bidirectional` is GQA's only.)  Caches for windowed GQA layers
are ring buffers of size min(window, max_len).  Unlike the JAX package's
immutable arrays, `apply_decode` writes the new key and value (MLA: the
latent and the rotary key) into the cache in place (one slot per step,
no copy of the cache) and returns the same dict.  `CrossAttention`
provides `init` (GQA's) and `apply(p, cfg, x, enc, impl)`: queries from
the decoder's x, keys and values from the encoder's output, no mask and
no RoPE, in prefill and decode alike.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from ..kernels.ref import NEG_INF
from ..parallel.sharding import axis_size, maybe_shard, write_at
from .layers import dense, init_dense, init_rms_norm, mrope, rms_norm, rope

__all__ = ["GQA", "MLA", "CrossAttention"]


def _split_heads(x, B: int, S: int, H: int, D: int):
    """x [B, S, H*D] as [B, S, H, D].  Under a mesh whose 'model' axis
    does not divide H the last dim is replicated first: a DTensor cannot
    split a dim sharded over 'model' into heads it does not divide (XLA
    pads them instead)."""
    if H % axis_size("model"):
        x = maybe_shard(x, "data", None, None)
    return x.reshape(B, S, H, D)


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
        q = _split_heads(dense(p["wq"], x), B, S, cfg.n_heads, hd)
        k = _split_heads(dense(p["wk"], x), B, S, cfg.n_kv_heads, hd)
        v = _split_heads(dense(p["wv"], x), B, S, cfg.n_kv_heads, hd)
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
        write_at(ck, 1, slot, k[:, 0].to(ck.dtype))
        write_at(cv, 1, slot, v[:, 0].to(cv.dtype))
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
        # the query's heads whole on each rank (a DTensor cannot split
        # a sharded head dim into (Hkv, G) groups)
        q = maybe_shard(q, "data", None, None, None)
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


class MLA:
    """Multi-head latent attention (DeepSeek-V3).

    The full sequence materialises per-head k and v from the compressed
    latent and runs `ops.attention` with q and k of head dim dn + dr
    (192 at full width) and v of dv (128): the flash-attention kernel's
    (192, 128) instantiation on the card.  Decode uses the *absorbed*
    form, as the JAX package does: scores and values are computed in the
    kv_lora latent space (einsums, no kernel), so the cache holds only
    kv_lora_rank + dr floats a token."""

    @staticmethod
    def init(gen: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32) -> dict:
        d, H = cfg.d_model, cfg.n_heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        p = {}
        if cfg.q_lora_rank:
            p["wq_a"] = init_dense(gen, d, cfg.q_lora_rank, dtype)
            p["q_norm"] = init_rms_norm(cfg.q_lora_rank, gen, dtype)
            p["wq_b"] = init_dense(gen, cfg.q_lora_rank, H * (dn + dr), dtype)
        else:
            p["wq"] = init_dense(gen, d, H * (dn + dr), dtype)
        p["wkv_a"] = init_dense(gen, d, cfg.kv_lora_rank + dr, dtype)
        p["kv_norm"] = init_rms_norm(cfg.kv_lora_rank, gen, dtype)
        p["wk_b"] = init_dense(gen, cfg.kv_lora_rank, H * dn, dtype)
        p["wv_b"] = init_dense(gen, cfg.kv_lora_rank, H * dv, dtype)
        p["wo"] = init_dense(gen, H * dv, d, dtype)
        return p

    @staticmethod
    def _q(p, cfg, x, positions):
        """(q_nope [B, S, H, dn], q_rope [B, S, H, dr], rotated)."""
        B, S, _ = x.shape
        dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        if cfg.q_lora_rank:
            q = dense(p["wq_b"], rms_norm(p["q_norm"], dense(p["wq_a"], x)))
        else:
            q = dense(p["wq"], x)
        q = _split_heads(q, B, S, cfg.n_heads, dn + dr)
        return q[..., :dn], rope(q[..., dn:], positions, cfg.rope_theta)

    @staticmethod
    def _latent(p, cfg, x, positions):
        """(c_kv [B, S, kv_lora_rank] normed, k_rope [B, S, 1, dr]
        rotated)."""
        B, S, _ = x.shape
        L, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        kv = dense(p["wkv_a"], x)
        c_kv = rms_norm(p["kv_norm"], kv[..., :L])
        k_rope = rope(kv[..., L:].reshape(B, S, 1, dr), positions,
                      cfg.rope_theta)
        return c_kv, k_rope

    @staticmethod
    def apply(p, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, window: int | None = None,
              impl: str = "auto") -> torch.Tensor:
        B, S, _ = x.shape
        H = cfg.n_heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        q_nope, q_rope = MLA._q(p, cfg, x, positions)
        c_kv, k_rope = MLA._latent(p, cfg, x, positions)
        k_nope = _split_heads(dense(p["wk_b"], c_kv), B, S, H, dn)
        v = _split_heads(dense(p["wv_b"], c_kv), B, S, H, dv)
        q = torch.cat([q_nope, q_rope], -1)
        k = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], -1)
        o = ops.attention(q, k, v, causal=True, window=window,
                          scale=(dn + dr) ** -0.5, impl=impl)
        return dense(p["wo"], o.reshape(B, S, -1))

    # -- decode ---------------------------------------------------------- #
    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   window: int | None = None, dtype=torch.float32, *,
                   device) -> dict:
        return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                   dtype=dtype, device=device),
                "krope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                     dtype=dtype, device=device)}

    @staticmethod
    def apply_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: dict,
                     pos: int, window: int | None = None
                     ) -> tuple[torch.Tensor, dict]:
        """x [B, 1, d]; pos: int absolute position.  The absorbed form:
        q_nope is taken into the latent space through wk_b, and the
        latent output out of it through wv_b."""
        B = x.shape[0]
        H, L = cfg.n_heads, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x.device)
        q_nope, q_rope = MLA._q(p, cfg, x, positions)       # [B, 1, H, *]
        c_kv, k_rope = MLA._latent(p, cfg, x, positions)
        ckv, krope = cache["ckv"], cache["krope"]
        write_at(ckv, 1, pos, c_kv[:, 0].to(ckv.dtype))
        write_at(krope, 1, pos, k_rope[:, 0, 0].to(krope.dtype))
        wk = p["wk_b"]["w"].reshape(L, H, dn).float()
        q_lat = torch.einsum("bqhd,lhd->bqhl", q_nope.float(), wk)
        s_nope = torch.einsum("bqhl,bkl->bhqk", q_lat, ckv.float())
        s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                              krope.float())
        s = (s_nope + s_rope) * ((dn + dr) ** -0.5)
        valid = torch.arange(ckv.shape[1], device=x.device) <= pos
        s = torch.where(valid[None, None, None, :], s, NEG_INF)
        probs = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhqk,bkl->bqhl", probs, ckv.float())
        wv = p["wv_b"]["w"].reshape(L, H, dv).float()
        o = torch.einsum("bqhl,lhd->bqhd", o_lat, wv)
        y = dense(p["wo"], o.reshape(B, 1, -1).to(x.dtype))
        return y, cache


class CrossAttention:
    """Encoder-decoder cross attention (seamless): the decoder's S rows
    attend to all Se rows of the encoder's output, with no mask (the
    flash-attention kernel at Sq != Sk on the card, Sq = 1 in decode).
    Decode projects the keys and values from `enc` again at every step,
    as the JAX package does."""

    init = staticmethod(GQA.init)

    @staticmethod
    def project_kv(p, cfg: ModelConfig, enc: torch.Tensor):
        """The keys and values [B, Se, Hkv, hd] from the encoder's
        output (no RoPE)."""
        B, Se, _ = enc.shape
        k = _split_heads(dense(p["wk"], enc), B, Se, cfg.n_kv_heads,
                         cfg.head_dim)
        v = _split_heads(dense(p["wv"], enc), B, Se, cfg.n_kv_heads,
                         cfg.head_dim)
        return k, v

    @staticmethod
    def apply(p, cfg: ModelConfig, x: torch.Tensor, enc: torch.Tensor,
              impl: str = "auto") -> torch.Tensor:
        B, S, _ = x.shape
        q = _split_heads(dense(p["wq"], x), B, S, cfg.n_heads, cfg.head_dim)
        k, v = CrossAttention.project_kv(p, cfg, enc)
        o = ops.attention(q, k, v, causal=False, impl=impl)
        return dense(p["wo"], o.reshape(B, S, -1))
