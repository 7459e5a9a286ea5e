"""smollm-360m — llama-architecture small dense GQA model.
[hf:HuggingFaceTB/SmolLM-360M; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab_size=49152,
    hidden_act="silu", rope_theta=10_000.0,
)
