"""Plain PyTorch versions of the attention and RG-LRU kernels.

They are the ground truth the tests hold the kernels to, the path every
CPU tensor takes, and what `chip_smoke.py` compares each CUDA kernel
with on the card.  Each mirrors the JAX package's `repro.kernels.ref`
(`attention_ref`, `rglru_ref`): float32 inside, the `-1e30` mask, and
the result in the input's dtype.  The RWKV6 versions come with the RWKV6
slice (ROADMAP.md queue 1, item 4).
"""
from __future__ import annotations

import torch

__all__ = ["attention_ref", "rglru_ref", "NEG_INF"]

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  softcap: float | None = None, scale: float | None = None,
                  q_offset=0, kv_len=None) -> torch.Tensor:
    """Multi-head attention with GQA, sliding window and logit softcap.

    Shapes: q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] with Hq % Hkv == 0.
    `q_offset` is the absolute position of q[:, 0] (decode: Sq=1,
    q_offset=pos).  `kv_len` optionally masks cache positions >= kv_len.
    Computation in float32, result cast back to q.dtype.
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    assert Hq % Hkv == 0, (Hq, Hkv)
    groups = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5

    qf = q.float() * scale
    # expand kv heads for GQA: head h reads kv head h // groups
    kf = k.float().repeat_interleave(groups, dim=2)
    vf = v.float().repeat_interleave(groups, dim=2)

    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap

    q_pos = torch.arange(Sq, device=q.device) + q_offset
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    if kv_len is not None:
        mask &= k_pos[None, :] < kv_len
    logits = torch.where(mask[None, None], logits,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out.to(q.dtype)


def rglru_ref(x: torch.Tensor, a: torch.Tensor,
              h0: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU linear recurrence (Griffin / RecurrentGemma):

        h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * x_t

    Shapes: x, a [B, S, D] (a in (0,1), already gated), h0 [B, D];
    returns (h [B, S, D], h_last [B, D]), both in x.dtype.  float32
    inside; the steps run one after another, as the kernel runs them.
    """
    xf = x.float()
    af = a.float()
    gated = torch.sqrt(torch.clamp(1.0 - af * af, 0.0, 1.0)) * xf
    h = (torch.zeros(x.shape[:1] + x.shape[2:], dtype=torch.float32,
                     device=x.device)
         if h0 is None else h0.float())
    hs = torch.empty_like(xf)
    for t in range(x.shape[1]):
        h = af[:, t] * h + gated[:, t]
        hs[:, t] = h
    return hs.to(x.dtype), h.to(x.dtype)
