"""The model stack's serving half: GQA, RG-LRU and RWKV6 blocks, the model
as an `nn.Module`, and weights carried across from the JAX package."""
from .convert import from_jax_params, to_jax_params
from .model import (Model, decode_step, forward, init_cache, init_params,
                    loss_fn, prefill)

__all__ = ["Model", "init_params", "forward", "loss_fn", "init_cache",
           "decode_step", "prefill", "from_jax_params", "to_jax_params"]
