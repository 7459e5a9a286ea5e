"""RWKV6 (Finch) WKV scan: the CUDA kernel's wrapper and its plain version.

Per head, with a float32 state S [Dk, Dv]:

    out_t = r_t (S + u ⊙ k_t^T v_t)
    S    <- diag(w_t) S + k_t^T v_t        (data-dependent decay w_t)

`rwkv6_scan` takes r, k, w [B, S, H, Dk], v [B, S, H, Dv], u [H, Dk] and
an optional s0 [B, H, Dk, Dv] and returns (out [B, S, H, Dv] in r's
dtype, S_last [B, H, Dk, Dv] float32; float64 for float64 inputs, which
only the CPU takes).  On a CUDA tensor it launches the
hand-written kernel `csrc/rwkv6.cu`, which replaces the Pallas kernel
`_rwkv6_kernel` of `repro.kernels.rwkv6` and reads the [B, S, H, D]
layout as it is; on a CPU tensor it runs the plain version, `rwkv6_ref`.
There is no other path: a CUDA tensor that the kernel cannot take raises.

It is differentiable on the card too: when autograd records and an input
requires grad, the call goes through a `torch.autograd.Function` whose
forward launches the kernel with its checkpoints (the float32 state every
`ckpt_steps()` steps, for the backward) and whose backward launches
the hand-written kernels of `csrc/rwkv6_bwd.cu` (the Pallas kernel has
none; the JAX package differentiates its plain forms instead, and
`rwkv6_bwd_plain` is that gradient, the autograd of `rwkv6_ref`).
Otherwise, under `no_grad` or `inference_mode` as in serving, the forward
launches without the checkpoints, and its outputs are the same bits.

What the kernel takes: r, k, v and w of one dtype, float32 or bfloat16,
contiguous, on one card, with Dk <= 64; u and s0 are read as float32.
The gradients of r, k, v and w come back in their dtype, du and ds0 in
u's and s0's.

`launches` counts the forward kernel's launches and `launches_bwd` the
backward's (one a backward call); a run sets them to 0 and reads them
back to show that a path went through the kernels.  Under a program
capture (`core.op_graph`) each call is one `rwkv6` vertex and each
backward kernel call one `rwkv6_bwd` vertex, on either device.
"""
from __future__ import annotations

import functools

import torch
from torch.autograd.function import once_differentiable

from ..core import op_graph
from ..core.cuda import _build
from .ref import rwkv6_ref

__all__ = ["rwkv6_scan", "rwkv6_plain", "rwkv6_bwd_plain"]

launches = 0
launches_bwd = 0

# the kernel tiles 64 rows of the state over the lanes of a column group
MAX_DK = 64

_ENTRIES = {torch.float32: "rwkv6_f32", torch.bfloat16: "rwkv6_bf16"}
_BWD_ENTRIES = {torch.float32: "rwkv6_bwd_f32",
                torch.bfloat16: "rwkv6_bwd_bf16"}


def rwkv6_plain(r, k, v, w, u, s0=None):
    """The plain version: `rwkv6_ref`, on the tensors' own device."""
    return rwkv6_ref(r, k, v, w, u, s0=s0)


def rwkv6_bwd_plain(r, k, v, w, u, s0, dout, dS_last):
    """The plain backward: (dr, dk, dv, dw, du, ds0), the autograd of
    `rwkv6_ref` given the gradients of out and S_last (one of them may be
    None, meaning zero; ds0 None without s0), on the tensors' own
    device."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (r, k, v, w, u)]
        if s0 is not None:
            ins.append(s0.detach().requires_grad_(True))
        out, s_last = rwkv6_plain(*ins)
        pairs = [(o, g) for o, g in ((out, dout), (s_last, dS_last))
                 if g is not None]
        grads = torch.autograd.grad([o for o, _ in pairs], ins,
                                    [g for _, g in pairs],
                                    allow_unused=True)
    grads = tuple(torch.zeros_like(t) if g is None else g
                  for g, t in zip(grads, ins))
    return grads + ((None,) if s0 is None else ())


@functools.cache
def ckpt_steps() -> int:
    """The steps between the forward kernel's checkpoints (the library's
    constant, read once)."""
    return int(_build.load_library().rwkv6_ckpt_steps())


def _launch(r, k, v, w, u, s0, with_ckpt: bool = False):
    """The forward kernel: (out, S_last, the checkpoints [B, H,
    ceil(S / ckpt_steps()), Dk, Dv] float32 with `with_ckpt`, else
    None)."""
    global launches
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan takes CPU or CUDA tensors, "
                         f"not {r.device.type!r}")
    if r.dtype not in _ENTRIES:
        raise TypeError(f"the kernel takes float32 or bfloat16, "
                        f"not {r.dtype}")
    if not all(t.is_contiguous() for t in (r, k, v, w)):
        raise ValueError("r, k, v and w must be contiguous")
    B, S, H, Dk = r.shape
    Dv = v.shape[-1]
    if Dk > MAX_DK:
        raise ValueError(f"the kernel takes Dk <= {MAX_DK}, not {Dk}")
    out = torch.empty((B, S, H, Dv), dtype=r.dtype, device=r.device)
    s_last = torch.empty((B, H, Dk, Dv), dtype=torch.float32,
                         device=r.device)
    if s0 is not None:
        s0 = s0.to(torch.float32).contiguous()
    ckpt = None
    if with_ckpt:
        n_ckpt = -(-S // ckpt_steps())
        ckpt = torch.empty((B, H, n_ckpt, Dk, Dv), dtype=torch.float32,
                           device=r.device)
    if r.numel() == 0 or v.numel() == 0:    # nothing to scan
        out.zero_()
        if s0 is not None:
            s_last.copy_(s0)
        else:
            s_last.zero_()
        return out, s_last, ckpt
    u = u.to(torch.float32).contiguous()
    lib = _build.load_library()
    with torch.cuda.device(r.device):   # launch on the tensors' card
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, _ENTRIES[r.dtype])(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr() if s0 is not None else None,
            out.data_ptr(), s_last.data_ptr(),
            ckpt.data_ptr() if ckpt is not None else None, B, S, H, Dk, Dv,
            stream)
    if rc != 0:
        raise RuntimeError(f"rwkv6 kernel launch failed: CUDA error {rc}")
    launches += 1
    return out, s_last, ckpt


def _launch_bwd(r, k, v, w, u, s0, ckpt, dout, dS_last):
    """The backward kernels: (dr, dk, dv, dw in r's dtype, du [H, Dk] and
    ds0 float32; ds0 None without s0) given the gradients of out and
    S_last, either of which may be None (zero)."""
    global launches_bwd
    B, S, H, Dk = r.shape
    Dv = v.shape[-1]
    dev = r.device
    dr, dk, dw = (torch.empty_like(r) for _ in range(3))
    dv = torch.empty_like(v)
    du = torch.empty((H, Dk), dtype=torch.float32, device=dev)
    ds0 = (torch.empty((B, H, Dk, Dv), dtype=torch.float32, device=dev)
           if s0 is not None else None)
    if r.numel() == 0 or v.numel() == 0:    # nothing was scanned
        for g in (dr, dk, dw, dv, du):
            g.zero_()
        if ds0 is not None and dS_last is not None:
            ds0.copy_(dS_last)
        elif ds0 is not None:
            ds0.zero_()
        return dr, dk, dv, dw, du, ds0
    if dout is not None:
        dout = dout.to(r.dtype).contiguous()
    if dS_last is not None:
        dS_last = dS_last.to(torch.float32).contiguous()
    u = u.to(torch.float32).contiguous()
    lib = _build.load_library()
    scratch = torch.empty((lib.rwkv6_bwd_scratch_len(B, S, H, Dk, Dv),),
                          dtype=torch.float32, device=dev)
    fn = getattr(lib, _BWD_ENTRIES[r.dtype])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), dout.data_ptr() if dout is not None else None,
                dS_last.data_ptr() if dS_last is not None else None,
                ckpt.data_ptr(), scratch.data_ptr(), dr.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
                ds0.data_ptr() if ds0 is not None else None, B, S, H, Dk,
                Dv, stream)
    if rc != 0:
        raise RuntimeError(f"rwkv6 backward kernel launch failed: CUDA "
                           f"error {rc}")
    launches_bwd += 1
    return dr, dk, dv, dw, du, ds0


class _RWKV6(torch.autograd.Function):
    """The forward kernel with its checkpoints, and the backward kernels
    for the gradient."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        out, s_last, ckpt = _launch(r, k, v, w, u, s0, with_ckpt=True)
        ctx.save_for_backward(r, k, v, w, u, s0, ckpt)
        ctx.set_materialize_grads(False)
        return out, s_last

    @staticmethod
    @once_differentiable
    def backward(ctx, dout, dS_last):
        r, k, v, w, u, s0, ckpt = ctx.saved_tensors
        if dout is None and dS_last is None:
            return (None,) * 6
        dr, dk, dv, dw, du, ds0 = op_graph.opaque(
            "rwkv6_bwd", _launch_bwd, r, k, v, w, u, s0, ckpt, dout, dS_last)
        return (dr, dk, dv, dw, du.to(u.dtype),
                ds0.to(s0.dtype) if s0 is not None else None)


@op_graph.kernel_vertex("rwkv6")
def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/w [B, S, H, Dk], v [B, S, H, Dv], u [H, Dk], s0 [B, H, Dk, Dv]
    or None; returns (out [B, S, H, Dv], S_last [B, H, Dk, Dv]).

    The kernel's output on a CUDA tensor (differentiable through the
    backward kernels), the plain version's on a CPU tensor.
    """
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"r, k and w must be parallel [B, S, H, Dk] "
                         f"tensors, not {tuple(r.shape)}, {tuple(k.shape)} "
                         f"and {tuple(w.shape)}")
    B, S, H, Dk = r.shape
    if v.dim() != 4 or tuple(v.shape[:3]) != (B, S, H):
        raise ValueError(f"v must be [B, S, H, Dv] = {(B, S, H)} + (Dv,), "
                         f"not {tuple(v.shape)}")
    Dv = v.shape[-1]
    if tuple(u.shape) != (H, Dk):
        raise ValueError(f"u must be [H, Dk] = {(H, Dk)}, "
                         f"not {tuple(u.shape)}")
    if s0 is not None and tuple(s0.shape) != (B, H, Dk, Dv):
        raise ValueError(f"s0 must be [B, H, Dk, Dv] = {(B, H, Dk, Dv)}, "
                         f"not {tuple(s0.shape)}")
    if not (k.dtype == v.dtype == w.dtype == r.dtype):
        raise TypeError("r, k, v and w must have one dtype")
    devices = {t.device for t in (r, k, v, w, u)} | (
        {s0.device} if s0 is not None else set())
    if len(devices) != 1:
        raise ValueError("r, k, v, w, u and s0 must be on one device")
    if r.device.type == "cpu":
        return rwkv6_plain(r, k, v, w, u, s0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, s0)):
        return _RWKV6.apply(r, k, v, w, u, s0)
    return _launch(r, k, v, w, u, s0)[:2]
