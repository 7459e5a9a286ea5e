"""Plain PyTorch versions of the attention, RG-LRU and RWKV6 kernels.

They are the ground truth the tests hold the kernels to, the path every
CPU tensor takes, and what `chip_smoke.py` compares each CUDA kernel
with on the card.  Each mirrors the JAX package's `repro.kernels.ref`
(`attention_ref`, `rglru_ref`, `rwkv6_ref`, `rwkv6_chunked`): float32
inside, the `-1e30` mask, and the result in the input's dtype (the RWKV6
state in float32).  One exception: `rwkv6_ref`, `attention_ref` and
`rglru_ref` given float64 inputs compute in float64 (and return
float64), so that their autograd is a float64 reference for the RWKV6,
flash-attention and RG-LRU backward kernels; no kernel takes float64,
so only those checks and CPU callers who pass float64 see it.  Float32
and bfloat16 inputs are computed as the JAX package computes them.
"""
from __future__ import annotations

import torch

__all__ = ["attention_ref", "rglru_ref", "rwkv6_ref", "rwkv6_chunked",
           "NEG_INF"]

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  softcap: float | None = None, scale: float | None = None,
                  q_offset=0, kv_len=None) -> torch.Tensor:
    """Multi-head attention with GQA, sliding window and logit softcap.

    Shapes: q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] with Hq % Hkv == 0.
    `q_offset` is the absolute position of q[:, 0] (decode: Sq=1,
    q_offset=pos).  `kv_len` optionally masks cache positions >= kv_len.
    Computation in float32 (in float64 for float64 q), result cast back to
    q.dtype.
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    assert Hq % Hkv == 0, (Hq, Hkv)
    groups = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5

    ft = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf = q.to(ft) * scale
    # expand kv heads for GQA: head h reads kv head h // groups
    kf = k.to(ft).repeat_interleave(groups, dim=2)
    vf = v.to(ft).repeat_interleave(groups, dim=2)

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
                         torch.tensor(NEG_INF, dtype=ft, device=q.device))
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
    inside (float64 for float64 x: the reference that the backward
    kernel is held to); the steps run one after another, as the kernel
    runs them.
    """
    ft = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(ft)
    af = a.to(ft)
    gated = torch.sqrt(torch.clamp(1.0 - af * af, 0.0, 1.0)) * xf
    h = (torch.zeros(x.shape[:1] + x.shape[2:], dtype=ft, device=x.device)
         if h0 is None else h0.to(ft))
    hs = torch.empty_like(xf)
    for t in range(x.shape[1]):
        h = af[:, t] * h + gated[:, t]
        hs[:, t] = h
    return hs.to(x.dtype), h.to(x.dtype)


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              s0: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 (Finch) WKV recurrence with data-dependent decay.

    Per head with state S [D_k, D_v]:

        out_t = r_t @ (S + u^T ⊙ (k_t^T v_t))
        S    <- diag(w_t) S + k_t^T v_t

    Shapes: r/k/w [B, S, H, Dk], v [B, S, H, Dv], u [H, Dk], s0
    [B, H, Dk, Dv].  Returns (out [B, S, H, Dv] in r.dtype, S_last
    [B, H, Dk, Dv] float32, or float64 when r is float64).  The state
    update is `w*S + kv`, two rounded operations, as the kernel computes
    it.  Float64 inputs are computed in float64: the reference that the
    backward kernel is held to.
    """
    B, S, H, Dk = r.shape
    Dv = v.shape[-1]
    ft = torch.float64 if r.dtype == torch.float64 else torch.float32
    rf, kf, vf, wf = (t.to(ft) for t in (r, k, v, w))
    uf = u.to(ft)[None, :, :, None]
    state = (torch.zeros((B, H, Dk, Dv), dtype=ft, device=r.device)
             if s0 is None else s0.to(ft))
    out = torch.empty((B, S, H, Dv), dtype=ft, device=r.device)
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]    # [B,H,Dk,Dv]
        out[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t], state + uf * kv)
        state = wf[:, t, :, :, None] * state + kv
    return out.to(r.dtype), state


def rwkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  s0: torch.Tensor | None = None, chunk: int = 64,
                  subchunk: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel WKV6, exact w.r.t. `rwkv6_ref` up to float32
    rounding: the JAX package's matmul form.

    The state is carried once per `chunk` steps; inside a chunk,
    `chunk/subchunk` sub-blocks each compute their pairwise decays in a
    factorised form whose exponents stay bounded (subchunk·|log w|), and
    pass the state on.  Differentiable under autograd.
    """
    B, S, H, Dk = r.shape
    Dv = v.shape[-1]
    L = min(chunk, S)
    q = min(subchunk, L)
    assert S % L == 0 and L % q == 0, (S, L, q)
    uf = u.float()
    state = (torch.zeros((B, H, Dk, Dv), dtype=torch.float32,
                         device=r.device)
             if s0 is None else s0.float())
    tri = torch.tril(torch.ones((q, q), dtype=torch.float32,
                                device=r.device), diagonal=-1)

    def sub_block(state, rc, kc, vc, lw):
        """One q-length sub-block: exact factorised pairwise decays."""
        out_dtype = rc.dtype
        rc, kc, vc = rc.float(), kc.float(), vc.float()
        lw = torch.log(torch.clamp(lw.float(), 1e-30, 1.0))
        Lc = torch.cumsum(lw, dim=1)            # inclusive prefix [B,q,H,D]
        Lprev = Lc - lw                         # exclusive prefix
        rd = rc * torch.exp(Lprev)              # <= rc (decays)
        ki = kc * torch.exp(-Lc)                # bounded: q*|log w| <= ~88
        sc = torch.einsum("bthd,bihd->bhti", rd, ki) * tri[None, None]
        diag = torch.einsum("bthd,bthd->bth", rc, uf[None, None] * kc)
        out = torch.einsum("bhti,bihd->bthd", sc, vc)
        out = out + diag[..., None] * vc
        out = out + torch.einsum("bthk,bhkv->bthv", rd, state)
        decay_all = torch.exp(Lc[:, -1])        # [B,H,Dk]
        kd = kc * torch.exp(Lc[:, -1][:, None] - Lc)
        state = (decay_all[..., None] * state
                 + torch.einsum("bthk,bthv->bhkv", kd, vc))
        return state, out.to(out_dtype)

    outs = []
    for c0 in range(0, S, L):                   # the chunks, in order
        for j0 in range(c0, c0 + L, q):         # the sub-blocks of a chunk
            sl = slice(j0, j0 + q)
            state, o = sub_block(state, r[:, sl], k[:, sl], v[:, sl],
                                 w[:, sl])
            outs.append(o)
    return torch.cat(outs, dim=1).to(r.dtype), state
