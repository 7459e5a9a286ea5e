"""dbrx-132b — fine-grained MoE, 16 experts top-4, GQA.
[hf:databricks/dbrx-base; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab_size=100_352,
    n_experts=16, n_shared_experts=0, experts_per_token=4,
    moe_d_ff=10752, hidden_act="silu", tie_embeddings=False,
)
