"""RWKV6 (Finch) WKV scan: the CUDA kernel's wrapper and its plain version.

Per head, with a float32 state S [Dk, Dv]:

    out_t = r_t (S + u ⊙ k_t^T v_t)
    S    <- diag(w_t) S + k_t^T v_t        (data-dependent decay w_t)

`rwkv6_scan` takes r, k, w [B, S, H, Dk], v [B, S, H, Dv], u [H, Dk] and
an optional s0 [B, H, Dk, Dv] and returns (out [B, S, H, Dv] in r's
dtype, S_last [B, H, Dk, Dv] float32).  On a CUDA tensor it launches the
hand-written kernel `csrc/rwkv6.cu`, which replaces the Pallas kernel
`_rwkv6_kernel` of `repro.kernels.rwkv6` and reads the [B, S, H, D]
layout as it is; on a CPU tensor it runs the plain version, `rwkv6_ref`.
There is no other path: a CUDA tensor that the kernel cannot take raises.

A tensor off the CPU that requires grad while autograd records raises
too: of the three model kernels only this one has no backward yet
(`_grad.refuse_grad`).

What the kernel takes: r, k, v and w of one dtype, float32 or bfloat16,
contiguous, on one card, with Dk <= 64; u and s0 are read as float32.

`launches` counts the kernel launches; a run sets it to 0 and reads it
back to show that a path went through the kernel.
"""
from __future__ import annotations

import torch

from ..core.cuda import _build
from ._grad import refuse_grad
from .ref import rwkv6_ref

__all__ = ["rwkv6_scan", "rwkv6_plain"]

launches = 0

# the kernel tiles 64 rows of the state over the lanes of a column group
MAX_DK = 64

_ENTRIES = {torch.float32: "rwkv6_f32", torch.bfloat16: "rwkv6_bf16"}


def rwkv6_plain(r, k, v, w, u, s0=None):
    """The plain version: `rwkv6_ref`, on the tensors' own device."""
    return rwkv6_ref(r, k, v, w, u, s0=s0)


def _launch(r, k, v, w, u, s0):
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
    if r.numel() == 0 or v.numel() == 0:    # nothing to scan
        out.zero_()
        if s0 is not None:
            s_last.copy_(s0)
        else:
            s_last.zero_()
        return out, s_last
    u = u.to(torch.float32).contiguous()
    fn = getattr(_build.load_library(), _ENTRIES[r.dtype])
    with torch.cuda.device(r.device):   # launch on the tensors' card
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), s0.data_ptr() if s0 is not None else None,
                out.data_ptr(), s_last.data_ptr(), B, S, H, Dk, Dv, stream)
    if rc != 0:
        raise RuntimeError(f"rwkv6 kernel launch failed: CUDA error {rc}")
    launches += 1
    return out, s_last


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/w [B, S, H, Dk], v [B, S, H, Dv], u [H, Dk], s0 [B, H, Dk, Dv]
    or None; returns (out [B, S, H, Dv], S_last [B, H, Dk, Dv]).

    The kernel's output on a CUDA tensor, the plain version's on a CPU
    tensor.
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
    if r.device.type != "cpu":
        refuse_grad("rwkv6_scan", r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return rwkv6_plain(r, k, v, w, u, s0)
    return _launch(r, k, v, w, u, s0)
