"""Step functions: serve_step (greedy decode) and prefill_step (the
prompt forward pass).

The port of `repro.launch.steps`, serving half; `make_train_step` comes
with training (ROADMAP.md queue 1, item 9).  The step functions take the
model where the JAX package's take its params.
"""
from __future__ import annotations

import torch

from .. import models
from ..configs.base import ModelConfig

__all__ = ["make_serve_step", "make_prefill_step"]


def make_serve_step(cfg: ModelConfig):
    """serve_step(model, cache, tokens [B], pos) -> (next_tokens int32
    [B], cache): one greedy decode step with a KV/state cache."""

    @torch.inference_mode()
    def serve_step(model, cache, tokens, pos):
        logits, cache = models.decode_step(model, cache, tokens, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, impl: str = "auto"):
    """prefill_step(model, batch) -> last-position logits [B, V]: the
    prompt forward pass, through the kernels on the card."""

    @torch.inference_mode()
    def prefill_step(model, batch):
        logits, _ = models.forward(model, batch, impl=impl)
        return logits[:, -1].clone()    # frees the [B, S, V] logits

    return prefill_step
