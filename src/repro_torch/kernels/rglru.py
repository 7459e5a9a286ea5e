"""RG-LRU scan: the CUDA kernel's wrapper and its plain version.

    h_t = a_t * h_{t-1} + b_t,   b_t = sqrt(clip(1 - a_t^2, 0, 1)) * x_t

`rglru_scan` takes x, a [B, S, D] and an optional h0 [B, D] and returns
(h [B, S, D], h_last [B, D]), both in x's dtype.  On a CUDA tensor it
launches the hand-written kernel `csrc/rglru.cu`, which replaces the
Pallas kernel `_rglru_kernel` of `repro.kernels.rglru` and computes b_t
inside the kernel, in float32; on a CPU tensor it runs the plain version,
`rglru_ref`.  There is no other path: a CUDA tensor that the kernel
cannot take raises.

A tensor off the CPU that requires grad while autograd records raises
too: the kernel has no backward yet (`_grad.refuse_grad`).

What the kernel takes: x and a of one dtype, float32 or bfloat16,
contiguous, on one card; h0, when given, is read as float32.  It streams
rows as 16-byte copies when D * itemsize is a multiple of 16 and x, a and
h are 16-byte aligned, and element by element otherwise (the kernel's
launch picks the path); h and h_last equal the plain version's bit for
bit in float32.

`launches` counts the kernel launches; a run sets it to 0 and reads it
back to show that a path went through the kernel.
"""
from __future__ import annotations

import torch

from ..core.cuda import _build
from ._grad import refuse_grad
from .ref import rglru_ref

__all__ = ["rglru_scan", "rglru_plain"]

launches = 0

_ENTRIES = {torch.float32: "rglru_f32", torch.bfloat16: "rglru_bf16"}


def rglru_plain(x, a, h0=None):
    """The plain version: `rglru_ref`, on the tensors' own device."""
    return rglru_ref(x, a, h0=h0)


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


def rglru_scan(x: torch.Tensor, a: torch.Tensor,
               h0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """x, a: [B, S, D], h0: [B, D] or None; returns (h, h_last).

    The kernel's output on a CUDA tensor, the plain version's on a CPU
    tensor.
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
    if x.device.type != "cpu":
        refuse_grad("rglru_scan", x, a, h0)
    if x.device.type == "cpu":
        return rglru_plain(x, a, h0)
    return _launch(x, a, h0)
