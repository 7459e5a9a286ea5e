"""The attention and recurrence entry points every model calls, with the
JAX package's dispatch (`repro.kernels.ops`).

Implementations per op:
  * "cuda"    — the hand-written kernel's wrapper: the kernel on a CUDA
                tensor, its plain version on a CPU tensor;
  * "ref"     — the plain PyTorch version (`ref.py`);
  * "chunked" — attention: flash semantics in plain PyTorch, a loop over
                kv blocks with an online softmax.  It takes what the
                kernel does not: a tensor `q_offset`, a `kv_len`, and any
                pair of qk and v head dims (the kernel takes the pairs in
                `flash_attention.HEAD_DIM_PAIRS`: (D, D) and MLA's
                (192, 128)).  RWKV6: `rwkv6_chunked`,
                the JAX package's chunk-parallel matmul form.  Both run
                on any device.

`impl="auto"` picks the kernel for a tensor that is not on the CPU; on
the CPU it keeps the JAX package's choice: ref for short sequences,
chunked for attention once Sk exceeds `CHUNK_THRESHOLD`, and chunked for
RWKV6 whenever S > 1.  A kernel's failure is never caught.

Under a mesh (`parallel.sharding.use_mesh`) each op takes DTensors and
runs on every rank's local shards (`parallel.sharding.local_region`):
the batch over the data axes and the heads (the recurrence's channels)
over 'model' where every head count divides, so a kernel wrapper always
receives a local tensor and launches once a rank, as without a mesh.
"""
from __future__ import annotations

import torch

from ..parallel.sharding import axis_size, local_region
from . import ref as _ref
from .flash_attention import flash_attention as _flash
from .rglru import rglru_scan as _rglru_cuda
from .rwkv6 import rwkv6_scan as _rwkv6_cuda

__all__ = ["attention", "rglru", "rwkv6", "CHUNK_THRESHOLD"]

CHUNK_THRESHOLD = 1024
_KV_BLOCK = 512


# ---------------------------------------------------------------------- #
# attention
# ---------------------------------------------------------------------- #
def _attention_chunked(q, k, v, *, causal, window, softcap, scale,
                       q_offset=0, kv_len=None, kv_block=_KV_BLOCK):
    """Online-softmax attention, looped over kv blocks (flash semantics).
    Supports distinct qk and v head dims (MLA: 192 vs 128)."""
    B, Sq, Hq, Dk = q.shape
    _, Sk, Hkv, _ = k.shape
    Dv = v.shape[-1]
    groups = Hq // Hkv
    scale = scale if scale is not None else Dk ** -0.5
    nblocks = -(-Sk // kv_block)
    pad = nblocks * kv_block - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))

    dev = q.device
    qf = q.float() * scale
    q_pos = torch.arange(Sq, device=dev) + q_offset
    m = torch.full((B, Hq, Sq, 1), _ref.NEG_INF, dtype=torch.float32,
                   device=dev)
    lsum = torch.zeros((B, Hq, Sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, Hq, Dv), dtype=torch.float32, device=dev)
    neg = torch.tensor(_ref.NEG_INF, device=dev)
    for bi in range(nblocks):
        blk = slice(bi * kv_block, (bi + 1) * kv_block)
        kblk = k[:, blk].float().repeat_interleave(groups, dim=2)
        vblk = v[:, blk].float().repeat_interleave(groups, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kblk)
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        k_pos = bi * kv_block + torch.arange(kv_block, device=dev)
        mask = (k_pos[None, :] < Sk).expand(Sq, kv_block)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        if kv_len is not None:
            mask = mask & (k_pos[None, :] < kv_len)
        s = torch.where(mask[None, None], s, neg)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        lsum = alpha * lsum + p.sum(-1, keepdim=True)
        acc = acc * alpha.transpose(1, 2) + torch.einsum(
            "bhqk,bkhd->bqhd", p, vblk)
        m = m_new
    lsum = torch.where(lsum == 0.0, 1.0, lsum).transpose(1, 2)
    return (acc / lsum).to(q.dtype)


def _model_axis(*counts: int):
    """'model' where its size divides every count (head counts), else
    None: a GQA group must stay whole on a rank."""
    m = axis_size("model")
    return "model" if all(c % m == 0 for c in counts) else None


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              softcap: float | None = None, scale: float | None = None,
              q_offset=0, kv_len=None, impl: str = "auto") -> torch.Tensor:
    """Unified attention entry point used by every model.

    q [B, Sq, Hq, Dqk], k [B, Sk, Hkv, Dqk], v [B, Sk, Hkv, Dv] ->
    [B, Sq, Hq, Dv].  The kernel path takes only a static int `q_offset`
    and no `kv_len`; otherwise "cuda" goes to "chunked", as the JAX
    package's "pallas" does.  A head-dim pair outside the kernel's
    `HEAD_DIM_PAIRS` raises on a CUDA tensor.
    """
    heads = ("data", None, _model_axis(q.shape[2], k.shape[2]), None)
    return local_region(
        lambda q, k, v: _attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale,
                                   q_offset=q_offset, kv_len=kv_len,
                                   impl=impl),
        (q, k, v), (heads,) * 3, heads)


def _attention(q, k, v, *, causal, window, softcap, scale, q_offset,
               kv_len, impl):
    if impl == "auto":
        if q.device.type != "cpu":
            impl = "cuda"
        elif k.shape[1] > CHUNK_THRESHOLD:
            impl = "chunked"
        else:
            impl = "ref"
    if impl == "cuda":
        if isinstance(q_offset, int) and kv_len is None:
            return _flash(q, k, v, causal=causal, window=window,
                          softcap=softcap, scale=scale, q_offset=q_offset)
        impl = "chunked"
    if impl == "chunked":
        return _attention_chunked(q, k, v, causal=causal, window=window,
                                  softcap=softcap, scale=scale,
                                  q_offset=q_offset, kv_len=kv_len)
    if impl == "ref":
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  softcap=softcap, scale=scale,
                                  q_offset=q_offset, kv_len=kv_len)
    raise ValueError(f"unknown impl {impl!r}")


# ---------------------------------------------------------------------- #
# recurrences
# ---------------------------------------------------------------------- #
def rglru(x, a, h0=None, impl: str = "auto"):
    """RG-LRU scan; returns (h, h_last).  Every impl other than "cuda"
    (and "auto" off the CPU) runs the plain version, as in the JAX
    package, so a model's impl="chunked" reaches it too."""
    ch = ("data", None, _model_axis(x.shape[2]))
    return local_region(lambda x, a, h0: _rglru(x, a, h0, impl), (x, a, h0),
                        (ch, ch, (ch[0], ch[2])), [ch, (ch[0], ch[2])])


def _rglru(x, a, h0, impl):
    if impl == "auto":
        impl = "ref" if x.device.type == "cpu" else "cuda"
    if impl == "cuda":
        return _rglru_cuda(x, a, h0)
    return _ref.rglru_ref(x, a, h0=h0)


def rwkv6(r, k, v, w, u, s0=None, impl: str = "auto"):
    """RWKV6 WKV scan; returns (out, state_last).

    "auto" launches the kernel for a tensor that is not on the CPU, in
    prefill and in single-token decode alike.  On the CPU it keeps the JAX
    package's choice: the chunk-parallel form for sequences (state carried
    once per 64 steps) and the per-step form for single-token decode.
    """
    hd = _model_axis(r.shape[2])
    seq, state = ("data", None, hd, None), ("data", hd, None, None)
    return local_region(
        lambda r, k, v, w, u, s0: _rwkv6(r, k, v, w, u, s0, impl),
        (r, k, v, w, u, s0), (seq, seq, seq, seq, (hd, None), state),
        [seq, state])


def _rwkv6(r, k, v, w, u, s0, impl):
    if impl == "auto":
        if r.device.type != "cpu":
            impl = "cuda"
        elif r.shape[1] > 1:
            impl = "chunked"
        else:
            impl = "ref"
    if impl == "cuda":
        return _rwkv6_cuda(r, k, v, w, u, s0)
    if impl == "chunked":
        S = r.shape[1]
        chunk = 64 if S % 64 == 0 else (S if S <= 64 else 1)
        if chunk > 1:
            sub = 8 if chunk % 8 == 0 else chunk
            return _ref.rwkv6_chunked(r, k, v, w, u, s0=s0, chunk=chunk,
                                      subchunk=sub)
        impl = "ref"
    if impl == "ref":
        return _ref.rwkv6_ref(r, k, v, w, u, s0=s0)
    raise ValueError(f"unknown impl {impl!r}")
