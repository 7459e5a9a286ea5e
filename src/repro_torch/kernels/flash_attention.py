"""Flash attention: the CUDA kernels' wrapper and their plain versions.

`flash_attention` takes the JAX package's layout, q [B, Sq, Hq, Dqk],
k [B, Sk, Hkv, Dqk] and v [B, Sk, Hkv, Dv], and returns [B, Sq, Hq, Dv]
in q's dtype (Dv is Dqk but for MLA, whose q and k have 192 columns and
v 128).  On a CUDA
tensor it launches the hand-written kernel `csrc/flash_attention.cu`,
which replaces the Pallas kernel `_fa_kernel` of
`repro.kernels.flash_attention`; on a CPU tensor it runs the plain
version, `attention_ref`.  There is no other path: a CUDA tensor that the
kernel cannot take raises.

It is differentiable on the card too.  When autograd records and an
input requires grad, the call goes through a `torch.autograd.Function`:
the forward kernel also writes each row's log-sum-exp, and the backward
launches the kernels of `csrc/flash_attention_bwd.cu` (the Pallas kernel
has none; the JAX package differentiates `attention_ref` instead, and
`flash_attention_bwd_plain` is that gradient, the autograd of the plain
forward).  Otherwise the forward launches without the log-sum-exp, and
its output is the same.  The backward is three launches on `wgmma`: each
row's dO.O, then one block per key tile that walks every q head of its
kv head's group and writes dK and dV once, then one block per q tile for
dQ; a producer streams 64-row tiles into a ring of shared memory.  Two
bodies: `bwd_kernel` (every (D, D), and float32 at (192, 128)), with the
owned rows as N of each product and a producer warp's bulk copies, and,
for bf16 at MLA's (192, 128), `mla_bwd_kernel`
(`csrc/flash_attention_bwd_mla.cuh`, FlashAttention-3's operand roles:
128 owned rows in two consumer warpgroups as M, P and dS kept in
registers, a producer warpgroup's `cp.async` into the swizzled layout).
It needs no scratch beyond the [B, Hq, Sq] float32 dO.O, uses no
atomics, and two calls give the same bits.

What the kernels take: float32 or bfloat16, q, k and v of one dtype, on
one card, contiguous and 16-byte aligned, with (Dqk, Dv) one of
`HEAD_DIM_PAIRS` and Hq a multiple of Hkv; the forward and the backward
have the same instantiations, MLA's (192, 128) among them (the backward's
S, dK and dQ run over Dqk, its dP, dO.O and dV over Dv).  They support
the causal mask, a sliding window (`k_pos > q_pos - window`), a tanh
logit softcap, GQA (head h reads kv head h // (Hq // Hkv)) and a static
`q_offset` (the absolute position of q[:, 0]).  The gradients come back in the inputs' dtype; a row that the
mask hides entirely gets a zero gradient.

`launches` counts the forward kernel's launches and `launches_bwd` the
backward's (one a backward call); a run sets them to 0 and reads them
back to show that a path went through the kernels.  Under a program
capture (`core.op_graph`) each call is one `flash_attention` vertex and
each backward kernel call one `flash_attention_bwd` vertex, on either
device.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..core import op_graph
from ..core.cuda import _build
from .ref import attention_ref

__all__ = ["flash_attention", "flash_attention_plain",
           "flash_attention_bwd_plain", "HEAD_DIMS", "HEAD_DIM_PAIRS"]

launches = 0
launches_bwd = 0

HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernels' equal-D instantiations
# the forward kernel's (Dqk, Dv) instantiations: (D, D), and MLA's
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
_ENTRIES = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
_BWD_ENTRIES = {torch.float32: "flash_attention_bwd_f32",
                torch.bfloat16: "flash_attention_bwd_bf16"}


def flash_attention_plain(q, k, v, *, causal=True, window=None,
                          softcap=None, scale=None, q_offset: int = 0):
    """The plain version: `attention_ref`, on the tensors' own device."""
    return attention_ref(q, k, v, causal=causal, window=window,
                         softcap=softcap, scale=scale, q_offset=q_offset)


def flash_attention_bwd_plain(q, k, v, dout, *, causal=True, window=None,
                              softcap=None, scale=None, q_offset: int = 0):
    """The plain backward: (dq, dk, dv), the autograd of the plain
    forward given the gradient `dout` of its output, on the tensors' own
    device."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_plain(*qkv, causal=causal, window=window,
                                    softcap=softcap, scale=scale,
                                    q_offset=q_offset)
        return torch.autograd.grad(out, qkv, dout)


def _check(q, k, v, window, q_offset) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D [B, S, H, D]")
    B, _, Hq, D = q.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != B
            or k.shape[3] != D):
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={k.shape[2]}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must have one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not isinstance(q_offset, int):
        raise TypeError("the kernel takes a static int q_offset; a tensor "
                        "offset goes to ops.attention's chunked path")
    if window is not None and not isinstance(window, int):
        raise TypeError("window must be an int or None")


def _launch(q, k, v, causal, window, softcap, scale, q_offset,
            with_lse: bool = False):
    """The forward kernel: out, and with `with_lse` also the rows'
    log-sum-exp [B, Hq, Sq] (float32) for the backward."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CPU or CUDA tensors, "
                         f"not {q.device.type!r}")
    if q.dtype not in _ENTRIES:
        raise TypeError(f"the kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if (D, Dv) not in HEAD_DIM_PAIRS:
        raise ValueError(f"the kernel takes (Dqk, Dv) in {HEAD_DIM_PAIRS}, "
                         f"not {(D, Dv)}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("q, k and v must be contiguous and 16-byte "
                             "aligned")
    out = q.new_empty((B, Sq, Hq, Dv))
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    if Sk == 0:
        raise ValueError("the kernel needs at least one key")
    fn = getattr(_build.load_library(), _ENTRIES[q.dtype])
    with torch.cuda.device(q.device):   # launch on the tensors' card
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if lse is not None else None,
                B, Sq, Sk, Hq, Hkv, D, Dv, int(causal),
                int(window is not None), window or 0,
                int(softcap is not None), float(softcap or 0.0), scale,
                q_offset, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"CUDA error {rc}")
    launches += 1
    return out, lse


def _launch_bwd(q, k, v, out, dout, lse, causal, window, softcap, scale,
                q_offset):
    """The backward kernels: (dq, dk, dv) in the inputs' dtype.  The
    library's `dispatch` picks the body: `mla_bwd_kernel` for bf16 at
    (192, 128), `bwd_kernel` otherwise; the only scratch is dO.O."""
    global launches_bwd
    dout = dout.to(q.dtype).contiguous()
    if dout.shape != out.shape or dout.data_ptr() % 16:
        raise ValueError(f"the gradient of the output must be "
                         f"{tuple(out.shape)} and 16-byte aligned")
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if out.shape != (B, Sq, Hq, Dv):
        raise ValueError(f"the forward's output must be {(B, Sq, Hq, Dv)}, "
                         f"not {tuple(out.shape)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if out.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    fn = getattr(_build.load_library(), _BWD_ENTRIES[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in (q, k, v, out, dout, lse, delta,
                                         dq, dk, dv)),
                B, Sq, Sk, Hq, Hkv, D, Dv, int(causal),
                int(window is not None), window or 0,
                int(softcap is not None), float(softcap or 0.0), scale,
                q_offset, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward kernel launch "
                           f"failed: CUDA error {rc}")
    launches_bwd += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its log-sum-exp, the backward kernels for
    the gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_offset):
        out, lse = _launch(q, k, v, causal, window, softcap, scale,
                           q_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, softcap, scale, q_offset)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*op_graph.opaque("flash_attention_bwd", _launch_bwd, q, k,
                                 v, out, dout, lse, *ctx.args),
                None, None, None, None, None)


@op_graph.kernel_vertex("flash_attention")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q [B, Sq, Hq, Dqk], k [B, Sk, Hkv, Dqk], v [B, Sk, Hkv, Dv] ->
    [B, Sq, Hq, Dv].

    Scale defaults to Dqk ** -0.5.  The kernel's output on a CUDA tensor
    (differentiable through the backward kernels), the plain version's on
    a CPU tensor.
    """
    _check(q, k, v, window, q_offset)
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        # laid out as the kernel's output, so that a program runs the same
        # operators after it on either device
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale,
                                     q_offset=q_offset).contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                     q_offset)
    return _launch(q, k, v, causal, window, softcap, scale, q_offset)[0]
