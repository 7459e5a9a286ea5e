"""Sharding specs and the ambient mesh (the port of `repro.parallel`)."""
from .sharding import (DATA_AXES, batch_specs, cache_specs, maybe_shard,
                       param_specs)
__all__ = ["param_specs", "batch_specs", "cache_specs", "maybe_shard",
           "DATA_AXES"]
