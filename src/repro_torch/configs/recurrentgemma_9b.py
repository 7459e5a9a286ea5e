"""recurrentgemma-9b — hybrid: RG-LRU recurrent blocks + local attention
in a 2:1 pattern (two recurrent blocks per local-attention block).
[arXiv:2402.19427; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab_size=256_000, head_dim=256,
    layer_pattern=("rec", "rec", "attn"), local_window=2048,
    hidden_act="gelu", embed_scale=True,
    rglru_width=4096, conv1d_width=4,
)
