"""rwkv6-7b (Finch) — attention-free RNN with data-dependent decay
(time-mix WKV6 + channel-mix).  [arXiv:2404.05892; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
    d_ff=14336, vocab_size=65_536, head_dim=64,
    layer_pattern=("rwkv",), hidden_act="relu",
    tie_embeddings=False,
)
