"""Architecture registry: ``--arch <id>`` resolves here.

The port's own copy of the JAX package's `repro.configs` (pure data).  It
is kept field for field identical, so that both packages build the same
shapes from the same name; `tests/test_torch_models.py` holds the two
registries equal.
"""
from __future__ import annotations

from .base import SHAPES, ModelConfig, ParallelConfig, ShapeConfig
from .granite_3_2b import CONFIG as granite_3_2b
from .gemma2_27b import CONFIG as gemma2_27b
from .gemma_2b import CONFIG as gemma_2b
from .smollm_360m import CONFIG as smollm_360m
from .qwen2_vl_2b import CONFIG as qwen2_vl_2b
from .recurrentgemma_9b import CONFIG as recurrentgemma_9b
from .seamless_m4t_large_v2 import CONFIG as seamless_m4t_large_v2
from .deepseek_v3_671b import CONFIG as deepseek_v3_671b
from .dbrx_132b import CONFIG as dbrx_132b
from .rwkv6_7b import CONFIG as rwkv6_7b

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (
        granite_3_2b, gemma2_27b, gemma_2b, smollm_360m, qwen2_vl_2b,
        recurrentgemma_9b, seamless_m4t_large_v2, deepseek_v3_671b,
        dbrx_132b, rwkv6_7b,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Small same-family config for CPU smoke tests (assignment: reduced
    layers/width/experts/vocab, same structure)."""
    import dataclasses
    pattern = list(cfg.layer_pattern)
    small = dict(
        n_layers=max(len(pattern) * 2, 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
    )
    if cfg.is_moe:
        small.update(n_experts=4, experts_per_token=2,
                     moe_d_ff=64,
                     n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.use_mla:
        small.update(q_lora_rank=32 if cfg.q_lora_rank else 0,
                     kv_lora_rank=32, qk_rope_head_dim=8,
                     qk_nope_head_dim=16, v_head_dim=16, head_dim=16)
    if cfg.rglru_width:
        small.update(rglru_width=64)
    if cfg.n_encoder_layers:
        small.update(n_encoder_layers=2)
    if cfg.local_window:
        small.update(local_window=32)
    if cfg.mrope_sections:
        # sections must sum to head_dim // 2
        hd = small.get("head_dim", 16)
        small.update(mrope_sections=(hd // 2 - 2 * (hd // 8),
                                     hd // 8, hd // 8))
    if cfg.mtp_depth:
        small.update(mtp_depth=1)
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-reduced", **small)


__all__ = ["ARCHS", "get_config", "reduced_config", "ModelConfig",
           "ParallelConfig", "ShapeConfig", "SHAPES"]
