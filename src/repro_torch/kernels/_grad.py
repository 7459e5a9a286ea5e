"""Only the RWKV6 kernel lacks a backward now (flash attention and RG-LRU
have theirs, `csrc/flash_attention_bwd.cu` and `csrc/rglru_bwd.cu`): its
wrapper refuses a tensor that autograd would follow, instead of returning
an output with no `grad_fn` (the kernel fills fresh outputs through
ctypes).  The RWKV6 backward comes with the rest of training (ROADMAP.md,
queue 1, item 9); until then a caller that needs its gradients runs the
plain version on CPU tensors."""
from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd is recording and any of `tensors` requires
    grad.  Called for every tensor that is not on the CPU, before the
    device-type check, so a `meta` tensor shows the raise."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward yet (ROADMAP.md, "
            f"queue 1, item 9); call it under torch.no_grad() or "
            f"torch.inference_mode(), or on CPU tensors for the "
            f"differentiable plain version")
