"""gemma2-27b — dense GQA, local+global alternating attention with logit
softcapping and GeGLU.  [arXiv:2408.00118; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
    d_ff=36864, vocab_size=256_000, head_dim=128,
    layer_pattern=("local", "global"), local_window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    hidden_act="gelu", embed_scale=True, rope_theta=10_000.0,
)
