"""deepseek-v3-671b — MoE with Multi-head Latent Attention (MLA),
1 shared + 256 routed experts (top-8), multi-token prediction.
All 61 layers are MoE here (the real model\'s first 3 layers are dense
d_ff=18432 — recorded as a simplification in DESIGN.md).
[arXiv:2412.19437; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432, vocab_size=129_280,
    n_experts=256, n_shared_experts=1, experts_per_token=8,
    moe_d_ff=2048,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
    mtp_depth=1, hidden_act="silu", tie_embeddings=False,
)
