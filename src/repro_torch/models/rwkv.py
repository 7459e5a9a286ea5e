"""RWKV6 (Finch) block: time-mix (WKV recurrence with data-dependent
decay) + channel-mix, both with token-shift.

The port of `repro.models.rwkv`.  Time-mix per head (the scan runs in
kernels.ops.rwkv6, the CUDA kernel on the card, whose gradient in
training is the backward kernel `csrc/rwkv6_bwd.cu`):

    out_t = r_t (S + u ⊙ k_t^T v_t),   S <- diag(w_t) S + k_t^T v_t

with w_t = exp(-exp(wd_t)) computed from a LoRA on the shifted input —
the data-dependent decay that distinguishes Finch from RWKV5.

One difference from the JAX package: its `apply_decode` calls the scan
with impl="ref"; here decode uses impl="auto", so on the card each
decode step launches the kernel with the cached state as s0, and on the
CPU it runs the same per-step form (auto picks "ref" at S=1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import _normal, dense, init_dense, init_rms_norm, rms_norm

__all__ = ["RWKV6Block"]

_LORA = 64


class RWKV6Block:

    @staticmethod
    def init(gen: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32) -> dict:
        d = cfg.d_model
        dev = gen.device

        def full(value):
            return torch.full((d,), value, dtype=dtype, device=dev)

        return {
            # time-mix
            "mix_r": full(0.5),
            "mix_k": full(0.5),
            "mix_v": full(0.5),
            "mix_w": full(0.5),
            "mix_g": full(0.5),
            "wr": init_dense(gen, d, d, dtype),
            "wk": init_dense(gen, d, d, dtype),
            "wv": init_dense(gen, d, d, dtype),
            "wg": init_dense(gen, d, d, dtype),
            "w_lora_a": init_dense(gen, d, _LORA, dtype),
            "w_lora_b": init_dense(gen, _LORA, d, dtype),
            "w_base": full(-6.0),
            "u": _normal((d,), gen, dtype, 0.1),
            "wo": init_dense(gen, d, d, dtype),
            "ln_x": init_rms_norm(d, gen, dtype),
            # channel-mix
            "cmix_k": full(0.5),
            "cmix_r": full(0.5),
            "ck": init_dense(gen, d, cfg.d_ff, dtype),
            "cv": init_dense(gen, cfg.d_ff, d, dtype),
            "cr": init_dense(gen, d, d, dtype),
        }

    # -- helpers --------------------------------------------------------- #
    @staticmethod
    def _shift(x, last=None):
        """Token shift: x_{t-1} (zeros / `last` for t=0).  x [B,S,d]."""
        if last is None:
            last = torch.zeros_like(x[:, :1])
        else:
            last = last[:, None].to(x.dtype)
        return torch.cat([last, x[:, :-1]], dim=1)

    @staticmethod
    def _time_mix_inputs(p, cfg: ModelConfig, x, shifted):
        def mix(mu):
            m = p[mu].to(x.dtype)
            return x * m + shifted * (1 - m)
        H = cfg.n_heads
        hd = cfg.head_dim
        B, S, d = x.shape
        r = dense(p["wr"], mix("mix_r")).reshape(B, S, H, hd)
        k = dense(p["wk"], mix("mix_k")).reshape(B, S, H, hd)
        v = dense(p["wv"], mix("mix_v")).reshape(B, S, H, hd)
        g = F.silu(dense(p["wg"], mix("mix_g")))
        wd = dense(p["w_lora_b"],
                   torch.tanh(dense(p["w_lora_a"], mix("mix_w"))))
        w = torch.exp(-torch.exp(p["w_base"].float() + wd.float()))
        w = w.reshape(B, S, H, hd)
        return r, k, v, g, w

    @staticmethod
    def _channel_mix(p, y, shifted):
        mk = p["cmix_k"].to(y.dtype)
        mr = p["cmix_r"].to(y.dtype)
        xk = y * mk + shifted * (1 - mk)
        xr = y * mr + shifted * (1 - mr)
        kk = torch.square(F.relu(dense(p["ck"], xk)))
        return y + torch.sigmoid(dense(p["cr"], xr)) * dense(p["cv"], kk)

    @staticmethod
    def apply(p, cfg: ModelConfig, x: torch.Tensor,
              impl: str = "auto") -> torch.Tensor:
        B, S, d = x.shape
        H, hd = cfg.n_heads, cfg.head_dim
        # --- time mix
        shifted = RWKV6Block._shift(x)
        r, k, v, g, w = RWKV6Block._time_mix_inputs(p, cfg, x, shifted)
        u = p["u"].float().reshape(H, hd)
        o, _ = ops.rwkv6(r, k, v, w.to(x.dtype), u, impl=impl)
        o = rms_norm(p["ln_x"], o.reshape(B, S, d))
        y = x + dense(p["wo"], o * g)
        # --- channel mix
        return RWKV6Block._channel_mix(p, y, RWKV6Block._shift(y))

    # -- decode ---------------------------------------------------------- #
    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                   device) -> dict:
        H, hd = cfg.n_heads, cfg.head_dim
        d = cfg.d_model
        return {
            "state": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                                 device=device),
            "last_tm": torch.zeros((batch, d), dtype=dtype, device=device),
            "last_cm": torch.zeros((batch, d), dtype=dtype, device=device),
        }

    @staticmethod
    def apply_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: dict,
                     pos: int) -> tuple[torch.Tensor, dict]:
        B, _, d = x.shape
        H, hd = cfg.n_heads, cfg.head_dim
        shifted = RWKV6Block._shift(x, cache["last_tm"])
        r, k, v, g, w = RWKV6Block._time_mix_inputs(p, cfg, x, shifted)
        u = p["u"].float().reshape(H, hd)
        o, state = ops.rwkv6(r, k, v, w.to(x.dtype), u, s0=cache["state"])
        o = rms_norm(p["ln_x"], o.reshape(B, 1, d))
        y = x + dense(p["wo"], o * g)
        out = RWKV6Block._channel_mix(
            p, y, RWKV6Block._shift(y, cache["last_cm"]))
        return out, {"state": state, "last_tm": x[:, 0],
                     "last_cm": y[:, 0]}
