"""Weights carried across between the JAX package and the port.

The JAX package's parameter tree, as nested dicts of numpy arrays (what
`jax.tree.map(np.asarray, params)` gives), stacks the layers of each
repeat of the layer pattern along a leading `n_stages` axis under
`params["stages"]` (keys `b{i}_{kind}`) and keeps the partial last repeat
under `params["tail"]`.  The port keeps one flat list of layers in layer
order.  Dense weights have the same [d_in, d_out] layout in both, so
nothing is transposed: the conversion only unstacks and restacks.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.cuda import resolve_device
from .model import Model

__all__ = ["from_jax_params", "to_jax_params"]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _stage_keys(cfg: ModelConfig):
    """(pattern, n_stages, tail) as the JAX package's `_stages` has it."""
    pattern = tuple(cfg.layer_pattern)
    n_stages = cfg.n_layers // len(pattern)
    return pattern, n_stages, pattern[: cfg.n_layers % len(pattern)]


def from_jax_params(cfg: ModelConfig, params: dict, *,
                    device="cuda") -> Model:
    """The port's model of `cfg` holding the JAX package's weights, each
    in its own dtype, on `device` (the card by default)."""
    device = resolve_device(device)
    pattern, n_stages, tail = _stage_keys(cfg)

    def tensor(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    layers = []
    for s in range(n_stages):
        for i, kind in enumerate(pattern):
            layers.append(_map(params["stages"][f"b{i}_{kind}"],
                               lambda a, s=s: tensor(a[s])))
    for i, kind in enumerate(tail):
        layers.append(_map(params["tail"][f"b{i}_{kind}"], tensor))
    for key in params:
        if key not in ("embed", "final_ln", "stages", "tail"):
            raise NotImplementedError(
                f"parameters {key!r} belong to a block this slice does not "
                f"run: ROADMAP.md queue 1, item 4")
    tree = {"embed": _map(params["embed"], tensor),
            "final_ln": _map(params["final_ln"], tensor),
            "layers": layers}
    return Model(cfg, device=device, params=tree)


def to_jax_params(model: Model) -> dict:
    """The inverse: the JAX package's tree of numpy arrays, stacked."""
    pattern, n_stages, tail = _stage_keys(model.cfg)

    def array(t):
        return t.detach().cpu().numpy()

    trees = [p.tree() for p in model.layers]
    P = len(pattern)
    out = {"embed": _map(model.embed.tree(), array),
           "final_ln": _map(model.final_ln.tree(), array),
           "stages": {}}
    for i, kind in enumerate(pattern):
        per_stage = [_map(trees[s * P + i], array) for s in range(n_stages)]
        out["stages"][f"b{i}_{kind}"] = _stack(per_stage)
    if tail:
        out["tail"] = {f"b{i}_{kind}": _map(trees[n_stages * P + i], array)
                       for i, kind in enumerate(tail)}
    return out


def _stack(trees: list) -> dict | np.ndarray:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)
