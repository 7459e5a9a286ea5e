"""qwen2-vl-2b — VLM backbone with M-RoPE (temporal/height/width rotary
sections).  The vision frontend is a STUB: `input_specs()` supplies
precomputed patch embeddings (assignment note).  [arXiv:2409.12191; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151_936,
    hidden_act="silu", rope_theta=1_000_000.0,
    frontend="vision", mrope_sections=(16, 24, 24),
)
