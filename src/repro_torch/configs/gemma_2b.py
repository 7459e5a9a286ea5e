"""gemma-2b — dense, MQA (kv=1), GeGLU, head_dim=256.
[arXiv:2403.08295; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab_size=256_000, head_dim=256,
    hidden_act="gelu", embed_scale=True, rope_theta=10_000.0,
)
