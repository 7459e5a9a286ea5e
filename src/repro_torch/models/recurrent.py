"""RG-LRU recurrent block (Griffin / RecurrentGemma).

The port of `repro.models.recurrent`.  Structure (per Griffin):
x -> [branch1: dense+gelu] ⊙ [branch2: conv1d(4) -> RG-LRU] -> dense out.
The RG-LRU gate:

    r_t = σ(x W_r + b_r)          (recurrence gate)
    i_t = σ(x W_i + b_i)          (input gate)
    a_t = a^(c·r_t),  a = σ(Λ)    (per-channel learned decay, c = 8)
    h_t = a_t h_{t-1} + sqrt(1-a_t²)·(i_t ⊙ x_t)

The scan itself runs in the CUDA kernel (kernels.ops.rglru) on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import _normal, dense, init_dense

__all__ = ["RGLRUBlock"]

_C = 8.0


class RGLRUBlock:

    @staticmethod
    def init(gen: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32) -> dict:
        d = cfg.d_model
        rw = cfg.rglru_width or d
        W = cfg.conv1d_width
        dev = gen.device
        return {
            "wx": init_dense(gen, d, rw, dtype),      # recurrent branch
            "wy": init_dense(gen, d, rw, dtype),      # gate branch
            "conv_w": _normal((W, rw), gen, dtype, 0.02),
            "conv_b": torch.zeros((rw,), dtype=dtype, device=dev),
            "wr": init_dense(gen, rw, rw, dtype),
            "wi": init_dense(gen, rw, rw, dtype),
            "lam": torch.full((rw,), 3.0, dtype=dtype, device=dev),
            "wo": init_dense(gen, rw, d, dtype),
        }

    # -- helpers --------------------------------------------------------- #
    @staticmethod
    def _conv(p, x, state=None):
        """Causal depthwise conv1d, width W.  x [B,S,rw].
        `state` [B, W-1, rw] carries the left context for decode."""
        W = p["conv_w"].shape[0]
        if state is None:
            pad = torch.zeros((x.shape[0], W - 1, x.shape[2]),
                              dtype=x.dtype, device=x.device)
        else:
            pad = state.to(x.dtype)
        xp = torch.cat([pad, x], dim=1)                  # [B,S+W-1,rw]
        out = sum(xp[:, i:i + x.shape[1], :] * p["conv_w"][i].to(x.dtype)
                  for i in range(W))
        return out + p["conv_b"].to(x.dtype), xp[:, -(W - 1):, :]

    @staticmethod
    def _gates(p, u):
        r = torch.sigmoid(dense(p["wr"], u).float())
        i = torch.sigmoid(dense(p["wi"], u).float())
        log_a = -_C * r * F.softplus(p["lam"].float())
        a = torch.exp(log_a)
        gated = (i * u.float()).to(u.dtype)
        return a.to(u.dtype), gated

    @staticmethod
    def apply(p, cfg: ModelConfig, x: torch.Tensor,
              impl: str = "auto") -> torch.Tensor:
        gate = F.gelu(dense(p["wy"], x), approximate="tanh")
        u = dense(p["wx"], x)
        u, _ = RGLRUBlock._conv(p, u)
        a, gated = RGLRUBlock._gates(p, u)
        h, _ = ops.rglru(gated.contiguous(), a.contiguous(), impl=impl)
        return dense(p["wo"], h * gate)

    # -- decode ---------------------------------------------------------- #
    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                   device) -> dict:
        rw = cfg.rglru_width or cfg.d_model
        return {
            "h": torch.zeros((batch, rw), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.conv1d_width - 1, rw),
                                dtype=dtype, device=device),
        }

    @staticmethod
    def apply_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: dict,
                     pos: int) -> tuple[torch.Tensor, dict]:
        gate = F.gelu(dense(p["wy"], x), approximate="tanh")
        u = dense(p["wx"], x)                              # [B,1,rw]
        u, conv_state = RGLRUBlock._conv(p, u, cache["conv"])
        a, gated = RGLRUBlock._gates(p, u)
        af = a.float()[:, 0]
        bf = (torch.sqrt(torch.clamp(1 - af * af, 0, 1))
              * gated.float()[:, 0])
        h = af * cache["h"] + bf                           # [B,rw]
        y = dense(p["wo"], h[:, None].to(x.dtype) * gate)
        return y, {"h": h, "conv": conv_state}
