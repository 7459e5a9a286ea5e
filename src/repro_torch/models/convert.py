"""Weights carried across between the JAX package and the port.

The JAX package's parameter tree, as nested dicts of numpy arrays (what
`jax.tree.map(np.asarray, params)` gives), stacks the layers of each
repeat of the layer pattern along a leading `n_stages` axis under
`params["stages"]` (keys `b{i}_{kind}`) and keeps the partial last repeat
under `params["tail"]`; an encoder-decoder config adds the encoder, its
layers stacked under `params["encoder"]["stages"]["b0_attn"]` and its
norm under `params["encoder"]["final_ln"]` (each decoder block carries
its cross attention, `ln_x` and `xattn`); a config with `mtp_depth` adds
the MTP head's blocks, unstacked, under `params["mtp"]` (keys
`b{i}_attn`) and its norm under `params["mtp_ln"]`.  The port keeps one
flat list of layers in layer order, the encoder as {"layers": [...],
"final_ln"}, and the head's blocks as a list under "mtp".  Dense weights
have the same [d_in, d_out] layout in both, so nothing is transposed:
the conversion only unstacks and restacks.

`from_jax_tree` / `to_jax_tree` do this for any tree shaped like the
params (gradients, AdamW's m and v); `from_jax_params` / `to_jax_params`
build a model from one and read one back.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.cuda import resolve_device
from .model import Model, param_tree

__all__ = ["from_jax_params", "to_jax_params", "from_jax_tree",
           "to_jax_tree"]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _stage_keys(cfg: ModelConfig):
    """(pattern, n_stages, tail) as the JAX package's `_stages` has it."""
    pattern = tuple(cfg.layer_pattern)
    n_stages = cfg.n_layers // len(pattern)
    return pattern, n_stages, pattern[: cfg.n_layers % len(pattern)]


def from_jax_tree(cfg: ModelConfig, tree: dict, *, device="cuda") -> dict:
    """A tree in the JAX package's layout (numpy leaves) as the port's
    {"embed", "final_ln", "layers": [...]} (and "encoder", "mtp" and
    "mtp_ln" where the tree has them) of tensors on `device`, each leaf
    in its own dtype.  A key the port has no block for raises."""
    device = resolve_device(device)
    pattern, n_stages, tail = _stage_keys(cfg)

    def tensor(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    layers = []
    for s in range(n_stages):
        for i, kind in enumerate(pattern):
            layers.append(_map(tree["stages"][f"b{i}_{kind}"],
                               lambda a, s=s: tensor(a[s])))
    for i, kind in enumerate(tail):
        layers.append(_map(tree["tail"][f"b{i}_{kind}"], tensor))
    for key in tree:
        if key not in ("embed", "final_ln", "stages", "tail", "encoder",
                       "mtp", "mtp_ln"):
            raise ValueError(f"parameters {key!r} belong to no block of "
                             f"the port's model")
    out = {"embed": _map(tree["embed"], tensor),
           "final_ln": _map(tree["final_ln"], tensor),
           "layers": layers}
    if "encoder" in tree:
        stacked = tree["encoder"]["stages"]["b0_attn"]
        out["encoder"] = {
            "layers": [_map(stacked, lambda a, s=s: tensor(a[s]))
                       for s in range(cfg.n_encoder_layers)],
            "final_ln": _map(tree["encoder"]["final_ln"], tensor)}
    if "mtp" in tree:
        out["mtp"] = [_map(tree["mtp"][f"b{i}_attn"], tensor)
                      for i in range(len(tree["mtp"]))]
        out["mtp_ln"] = _map(tree["mtp_ln"], tensor)
    return out


def to_jax_tree(cfg: ModelConfig, tree: dict) -> dict:
    """The inverse: the port's tree as the JAX package's, numpy leaves,
    the layers of each stage stacked."""
    pattern, n_stages, tail = _stage_keys(cfg)

    def array(t):
        return t.detach().cpu().numpy()

    P = len(pattern)
    layers = tree["layers"]
    out = {"embed": _map(tree["embed"], array),
           "final_ln": _map(tree["final_ln"], array),
           "stages": {}}
    for i, kind in enumerate(pattern):
        per_stage = [_map(layers[s * P + i], array) for s in range(n_stages)]
        out["stages"][f"b{i}_{kind}"] = _stack(per_stage)
    if tail:
        out["tail"] = {f"b{i}_{kind}": _map(layers[n_stages * P + i], array)
                       for i, kind in enumerate(tail)}
    if "encoder" in tree:
        out["encoder"] = {
            "stages": {"b0_attn": _stack([_map(block, array) for block in
                                          tree["encoder"]["layers"]])},
            "final_ln": _map(tree["encoder"]["final_ln"], array)}
    if "mtp" in tree:
        out["mtp"] = {f"b{i}_attn": _map(block, array)
                      for i, block in enumerate(tree["mtp"])}
        out["mtp_ln"] = _map(tree["mtp_ln"], array)
    return out


def from_jax_params(cfg: ModelConfig, params: dict, *,
                    device="cuda") -> Model:
    """The port's model of `cfg` holding the JAX package's weights, each
    in its own dtype, on `device` (the card by default)."""
    device = resolve_device(device)
    return Model(cfg, device=device,
                 params=from_jax_tree(cfg, params, device=device))


def to_jax_params(model: Model) -> dict:
    """The inverse: the JAX package's tree of numpy arrays, stacked."""
    return to_jax_tree(model.cfg, param_tree(model))


def _stack(trees: list) -> dict | np.ndarray:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)
