"""Model/run configuration schema for all assigned architectures."""
from __future__ import annotations

import dataclasses
from typing import Sequence

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ParallelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture.  Field values come verbatim from the assignment
    table (public configs); family selects the block structure."""

    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None      # default d_model // n_heads

    # attention features
    rope_theta: float = 10_000.0
    attn_softcap: float | None = None     # gemma2 logit softcapping
    final_softcap: float | None = None
    local_window: int | None = None       # sliding-window size (local attn)
    layer_pattern: Sequence[str] = ("attn",)   # repeating block pattern
    hidden_act: str = "silu"              # silu | gelu (geglu == gated gelu)
    embed_scale: bool = False             # gemma: scale embeddings by sqrt(d)

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int | None = None
    capacity_factor: float = 1.25

    # MLA (DeepSeek-V3)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128

    # multi-token prediction (DeepSeek-V3)
    mtp_depth: int = 0

    # recurrent (RG-LRU) / ssm (RWKV6)
    rglru_width: int | None = None        # recurrence width (d_model default)
    conv1d_width: int = 4

    # encoder-decoder
    n_encoder_layers: int = 0

    # modality frontend stub: None | "vision" | "audio"
    frontend: str | None = None
    mrope_sections: Sequence[int] | None = None   # qwen2-vl M-RoPE

    tie_embeddings: bool = True
    norm_eps: float = 1e-6

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)

    # -- derived sizes -------------------------------------------------- #
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context? (SSM state or bounded
        local window — no full-context attention anywhere.)"""
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            return all(b != "attn" or self.local_window for b in
                       self.layer_pattern) or "global" not in \
                self.layer_pattern
        return False

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), used for
        MODEL_FLOPS = 6·N·D in the roofline analysis."""
        d, hd = self.d_model, self.head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = {}

        if self.use_mla:
            q = (d * self.q_lora_rank + self.q_lora_rank * n_q *
                 (self.qk_nope_head_dim + self.qk_rope_head_dim)) \
                if self.q_lora_rank else \
                d * n_q * (self.qk_nope_head_dim + self.qk_rope_head_dim)
            kv = (d * (self.kv_lora_rank + self.qk_rope_head_dim)
                  + self.kv_lora_rank * n_q *
                  (self.qk_nope_head_dim + self.v_head_dim))
            o = n_q * self.v_head_dim * d
            per_layer["attn"] = q + kv + o
        else:
            per_layer["attn"] = d * hd * (n_q + 2 * n_kv) + n_q * hd * d

        gate_mult = 3  # gated MLP: in, gate, out
        per_layer["mlp"] = gate_mult * d * self.d_ff
        if self.is_moe:
            eff = self.moe_d_ff or self.d_ff
            per_layer["moe"] = (self.n_experts + self.n_shared_experts) \
                * gate_mult * d * eff + d * self.n_experts  # + router
        rw = self.rglru_width or d
        per_layer["rec"] = (2 * d * rw            # in/gate projections
                           + self.conv1d_width * rw + 3 * rw  # conv + lru
                           + rw * d)              # out projection
        per_layer["rwkv"] = 6 * d * d + 2 * d * (int(3.5 * d))
        # encoder/decoder cross attention
        per_layer["xattn"] = d * hd * (n_q + 2 * n_kv) + n_q * hd * d

        total = emb
        pattern = list(self.layer_pattern)
        for i in range(self.n_layers):
            block = pattern[i % len(pattern)]
            if block in ("attn", "local", "global"):
                total += per_layer["attn"] + per_layer[
                    "moe" if self.is_moe else "mlp"]
            elif block == "rec":
                total += per_layer["rec"] + per_layer["mlp"]
            elif block == "rwkv":
                total += per_layer["rwkv"]
        for _ in range(self.n_encoder_layers):
            total += per_layer["attn"] + per_layer["mlp"]
        if self.n_encoder_layers:  # decoder cross-attn
            total += self.n_layers * per_layer["xattn"]
        total += self.mtp_depth * (per_layer["attn"] + per_layer[
            "moe" if self.is_moe else "mlp"])
        return int(total)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k + shared only)."""
        if not self.is_moe:
            return self.param_count()
        eff = self.moe_d_ff or self.d_ff
        inactive = (self.n_experts - self.experts_per_token) \
            * 3 * self.d_model * eff * self.n_layers
        return int(self.param_count() - inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How a (model × mesh) cell is sharded — DESIGN.md §5."""

    fsdp: bool = True          # shard params/opt-state over 'data'
    tp: bool = True            # tensor parallel over 'model'
    ep: bool = False           # experts over 'model' instead of TP inside
    sp: bool = False           # shard sequence over 'model' (long context)
    pod_dp: bool = True        # 'pod' axis is pure data parallel
    # expert-weight layout: "2d" = [E/model, d/data, ff] (ZeRO-3 style,
    # re-gathered per use) | "ep_pod" = [E/(pod*model)] fully resident
    # (multi-pod only; weights never gathered, MoE a2a crosses DCN)
    expert_layout: str = "2d"
    remat: str = "none"        # none | block | full
    microbatches: int = 1      # gradient accumulation steps
    expert_placement: str = "contiguous"  # contiguous | vertex_cut
