"""The CUDA kernels are forward only: a wrapper refuses a tensor that
autograd would follow, instead of returning an output with no
`grad_fn` (the kernels fill fresh outputs through ctypes).  Their
backward comes with training (ROADMAP.md, queue 1, item 9); until then a
caller that needs gradients runs the plain versions on CPU tensors."""
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
