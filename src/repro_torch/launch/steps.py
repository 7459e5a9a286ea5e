"""Step functions: train_step (gradient accumulation + remat), serve_step
(greedy decode) and prefill_step (the prompt forward pass).

The port of `repro.launch.steps`.  The step functions take the model where
the JAX package's take its params; the train step updates the model's
weights and the optimizer state in place (AdamW's in-place form) and
returns them.

Program spans (`repro_torch.obs`; while `torch.profiler` records they land
in its trace on the device trace's clock): `launch.train_step` (a section)
around a train step, inside it `launch.forward` and `launch.backward` for
each microbatch and `launch.accumulate` around the accumulators' zeros,
each microbatch's adds and the final divide (microbatches + 2 a step; none
with one microbatch, which has no accumulator), and `optim.adamw`
(`optim/adamw.py`); `launch.prefill_step` (a section) around a prefill,
and `models.unembed` inside every forward (`models/model.py`).
"""
from __future__ import annotations

import torch

from .. import models, obs
from ..configs.base import ModelConfig, ParallelConfig
from ..optim.adamw import (AdamWConfig, adamw_update, tree_leaves,
                           tree_map, zeros_as)
from ..parallel.sharding import current_mesh, maybe_shard

__all__ = ["make_train_step", "make_serve_step", "make_prefill_step"]


def _no_grad():
    """`inference_mode`, or under a mesh `no_grad` (DTensor's in-place
    writes need the version counters that inference tensors lack)."""
    if current_mesh() is None:
        return torch.inference_mode()
    return torch.no_grad()


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    par: ParallelConfig, impl: str = "auto",
                    accum_dtype=None):
    """Returns train_step(model, opt_state, batch) -> (model, opt_state,
    metrics), metrics holding `loss`, `grad_norm` and `lr` (float32
    scalars on the model's device).

    With `par.microbatches` > 1 the batch's tensors carry a leading
    [n_micro] axis; each microbatch's gradients are added into an
    accumulator in `accum_dtype` (default `opt_cfg.moment_dtype`), and
    the loss and gradients are divided by n_micro.  `par.remat` other
    than "none" checkpoints each layer.  The model's weights must require
    grad (`model.requires_grad_(True)`).
    """
    if accum_dtype is None:
        accum_dtype = opt_cfg.moment_dtype
    remat = par.remat != "none"

    def value_and_grad(model, params, batch):
        with obs.span("launch.forward"):
            loss = models.loss_fn(model, batch, impl=impl, remat=remat)
        with obs.span("launch.backward"):
            grads = torch.autograd.grad(loss, tree_leaves(params))
        return loss.detach(), grads

    def train_step(model, opt_state, batch):
        with obs.span("launch.train_step", cat="section"):
            params = models.param_tree(model)
            n_micro = par.microbatches
            if n_micro > 1:
                with obs.span("launch.accumulate"):
                    tot_l = torch.zeros((), dtype=torch.float32,
                                        device=model.device)
                    acc = [zeros_as(p, accum_dtype)
                           for p in tree_leaves(params)]
                for i in range(n_micro):
                    loss, grads = value_and_grad(
                        model, params, {k: v[i] for k, v in batch.items()})
                    with obs.span("launch.accumulate"):
                        tot_l = tot_l + loss
                        for a, g in zip(acc, grads):
                            a.add_(g.to(accum_dtype))
                    del grads
                with obs.span("launch.accumulate"):
                    loss_val = tot_l / n_micro
                    grads = [a.div_(n_micro) for a in acc]
            else:
                loss_val, grads = value_and_grad(model, params, batch)
                grads = [g.to(accum_dtype) for g in grads]
            it = iter(grads)
            grad_tree = tree_map(lambda p: next(it), params)
            _, opt_state, metrics = adamw_update(params, grad_tree, opt_state,
                                                 opt_cfg, inplace=True)
            metrics["loss"] = loss_val
            return model, opt_state, metrics

    return train_step


def make_serve_step(cfg: ModelConfig):
    """serve_step(model, cache, tokens [B], pos) -> (next_tokens int32
    [B], cache): one greedy decode step with a KV/state cache."""

    def serve_step(model, cache, tokens, pos):
        with _no_grad():
            logits, cache = models.decode_step(model, cache, tokens, pos)
            # the vocab whole on each rank: DTensor's argmax over a
            # sharded dim reads its offsets back from the device
            logits = maybe_shard(logits, "data", None)
            return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, impl: str = "auto"):
    """prefill_step(model, batch) -> last-position logits [B, V]: the
    prompt forward pass, through the kernels on the card."""

    def prefill_step(model, batch):
        with obs.span("launch.prefill_step", cat="section"), _no_grad():
            logits, _ = models.forward(model, batch, impl=impl)
            return logits[:, -1].clone()    # frees the [B, S, V] logits

    return prefill_step
