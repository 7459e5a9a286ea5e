"""seamless-m4t-large-v2 — encoder-decoder multimodal (speech/text)
backbone.  The audio frontend is a STUB: `input_specs()` supplies
precomputed frame embeddings (assignment note).  [arXiv:2308.11596; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_encoder_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256_206,
    hidden_act="gelu", frontend="audio", tie_embeddings=False,
)
