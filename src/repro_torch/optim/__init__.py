"""The optimizer: AdamW with the JAX package's cosine schedule and
global-norm clipping, and int8 error-feedback gradient compression."""
from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    clip_by_global_norm, cosine_schedule)
from .compress import (compress_grads, compressed_bytes, decompress_grads,
                       ef_compress_cycle, init_error_feedback)
__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "clip_by_global_norm", "compress_grads", "decompress_grads",
           "ef_compress_cycle", "init_error_feedback", "compressed_bytes"]
