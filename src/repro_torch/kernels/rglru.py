"""RG-LRU scan: the CUDA kernel's wrapper and its plain version.

    h_t = a_t * h_{t-1} + b_t,   b_t = sqrt(clip(1 - a_t^2, 0, 1)) * x_t

`rglru_scan` takes x, a [B, S, D] and an optional h0 [B, D] and returns
(h [B, S, D], h_last [B, D]), both in x's dtype.  On a CUDA tensor it
launches the hand-written kernel `csrc/rglru.cu`, which replaces the
Pallas kernel `_rglru_kernel` of `repro.kernels.rglru` and computes b_t
inside the kernel, in float32; on a CPU tensor it runs the plain version,
`rglru_ref`.  There is no other path: a CUDA tensor that the kernel
cannot take raises.

It is differentiable on the card too: when autograd records and an input
requires grad, the call goes through a `torch.autograd.Function` whose
backward launches the hand-written kernels of `csrc/rglru_bwd.cu`, a
time-parallel walk over chunks of `chunk_steps()` steps (the Pallas kernel
has none; the JAX package differentiates `rglru_ref` instead, and
`rglru_bwd_plain` is that gradient, the autograd of the plain forward).

What the kernel takes: x and a of one dtype, float32 or bfloat16,
contiguous, on one card; h0, when given, is read as float32.  It streams
rows as 16-byte copies when D * itemsize is a multiple of 16 and x, a and
h are 16-byte aligned, and element by element otherwise (the kernel's
launch picks the path); h and h_last equal the plain version's bit for
bit in float32.

`launches` counts the forward kernel's launches and `launches_bwd` the
backward's (one a backward call); a run sets them to 0 and reads them
back to show that a path went through the kernels.  Under a program
capture (`core.op_graph`) each call is one `rglru` vertex and each
backward kernel call one `rglru_bwd` vertex, on either device.
"""
from __future__ import annotations

import functools

import torch
from torch.autograd.function import once_differentiable

from ..core import op_graph
from ..core.cuda import _build
from .ref import rglru_ref

__all__ = ["rglru_scan", "rglru_plain", "rglru_bwd_plain"]

launches = 0
launches_bwd = 0

_ENTRIES = {torch.float32: "rglru_f32", torch.bfloat16: "rglru_bf16"}
_BWD_ENTRIES = {torch.float32: "rglru_bwd_f32",
                torch.bfloat16: "rglru_bwd_bf16"}


def rglru_plain(x, a, h0=None):
    """The plain version: `rglru_ref`, on the tensors' own device."""
    return rglru_ref(x, a, h0=h0)


def rglru_bwd_plain(x, a, h0, dh, dh_last):
    """The plain backward: (dx, da, dh0), the autograd of the plain forward
    given the gradients of h and h_last (dh0 None without h0), on the
    tensors' own device."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, a)]
        if h0 is not None:
            ins.append(h0.detach().requires_grad_(True))
        h, h_last = rglru_plain(*ins)
        grads = torch.autograd.grad((h, h_last), ins, (dh, dh_last))
    return tuple(grads) + ((None,) if h0 is None else ())


@functools.cache
def chunk_steps() -> int:
    """The steps of the backward's chunks (the library's constant, read
    once)."""
    return int(_build.load_library().rglru_bwd_chunk_steps())


def _launch(x, a, h0):
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan takes CPU or CUDA tensors, "
                         f"not {x.device.type!r}")
    if x.dtype not in _ENTRIES:
        raise TypeError(f"the kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if not (x.is_contiguous() and a.is_contiguous()):
        raise ValueError("x and a must be contiguous")
    B, S, D = x.shape
    h = torch.empty_like(x)
    h_last = torch.empty((B, D), dtype=x.dtype, device=x.device)
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    if x.numel() == 0:
        if h0 is not None:
            h_last.copy_(h0)
        else:
            h_last.zero_()
        return h, h_last
    fn = getattr(_build.load_library(), _ENTRIES[x.dtype])
    with torch.cuda.device(x.device):   # launch on the tensors' card
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), a.data_ptr(),
                h0.data_ptr() if h0 is not None else None,
                h.data_ptr(), h_last.data_ptr(), B, S, D, stream)
    if rc != 0:
        raise RuntimeError(f"rglru kernel launch failed: CUDA error {rc}")
    launches += 1
    return h, h_last


def _launch_bwd(x, a, h0, h, dh, dh_last):
    """The backward kernels (one call, three launches): (dx, da, dh0), dh0
    in h0's dtype (None without h0)."""
    global launches_bwd
    dh = dh.to(x.dtype).contiguous()
    dh_last = dh_last.to(x.dtype).contiguous()
    B, S, D = x.shape
    dx, da = torch.empty_like(x), torch.empty_like(a)
    dh0 = (torch.empty((B, D), dtype=torch.float32, device=x.device)
           if h0 is not None else None)
    h0f = h0.to(torch.float32).contiguous() if h0 is not None else None
    lib = _build.load_library()
    scratch = torch.empty((lib.rglru_bwd_scratch_len(B, S, D),),
                          dtype=torch.float32, device=x.device)
    fn = getattr(lib, _BWD_ENTRIES[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), a.data_ptr(),
                h0f.data_ptr() if h0f is not None else None,
                h.data_ptr(), dh.data_ptr(), dh_last.data_ptr(),
                scratch.data_ptr(), dx.data_ptr(), da.data_ptr(),
                dh0.data_ptr() if dh0 is not None else None, B, S, D,
                stream)
    if rc != 0:
        raise RuntimeError(f"rglru backward kernel launch failed: CUDA "
                           f"error {rc}")
    launches_bwd += 1
    return dx, da, dh0.to(h0.dtype) if h0 is not None else None


class _RGLRU(torch.autograd.Function):
    """The forward kernel, and the backward kernel for the gradient."""

    @staticmethod
    def forward(ctx, x, a, h0):
        h, h_last = _launch(x, a, h0)
        ctx.save_for_backward(x, a, h0, h)
        return h, h_last

    @staticmethod
    @once_differentiable
    def backward(ctx, dh, dh_last):
        x, a, h0, h = ctx.saved_tensors
        return op_graph.opaque("rglru_bwd", _launch_bwd, x, a, h0, h, dh,
                               dh_last)


@op_graph.kernel_vertex("rglru")
def rglru_scan(x: torch.Tensor, a: torch.Tensor,
               h0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """x, a: [B, S, D], h0: [B, D] or None; returns (h, h_last).

    The kernel's output on a CUDA tensor (differentiable through the
    backward kernel), the plain version's on a CPU tensor.
    """
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"x and a must be parallel [B, S, D] tensors, not "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")
    if a.dtype != x.dtype:
        raise TypeError("x and a must have one dtype")
    if h0 is not None and tuple(h0.shape) != (x.shape[0], x.shape[2]):
        raise ValueError(f"h0 must be [B, D] = {(x.shape[0], x.shape[2])}, "
                         f"not {tuple(h0.shape)}")
    devices = {x.device, a.device} | ({h0.device} if h0 is not None else set())
    if len(devices) != 1:
        raise ValueError("x, a and h0 must be on one device")
    if x.device.type == "cpu":
        return rglru_plain(x, a, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, a, h0)):
        return _RGLRU.apply(x, a, h0)
    return _launch(x, a, h0)
