"""The model stack: GQA, MLA, cross attention, RG-LRU, RWKV6 and MoE
blocks, the encoder, the model as an `nn.Module` with its loss and its
decode cache, and weights (and any params-shaped tree) carried across
from the JAX package."""
from .convert import (from_jax_params, from_jax_tree, to_jax_params,
                      to_jax_tree)
from .model import (Cache, Model, decode_step, forward, init_cache,
                    init_params, loss_fn, param_tree, prefill)

__all__ = ["Model", "Cache", "init_params", "forward", "loss_fn",
           "init_cache", "decode_step", "prefill", "param_tree",
           "from_jax_params", "to_jax_params", "from_jax_tree", "to_jax_tree"]
