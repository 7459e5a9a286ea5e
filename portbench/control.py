"""The control: the reference put in the program's place, computed one
precision below the configuration's.  The configurations state float32
with TF32 off, so the control runs the reference's matrix products in
TF32: on the card by PyTorch's switch, on the CPU (in the harness's
tests) by rounding the products' float32 inputs to TF32's 10-bit
mantissa, round to nearest even."""
from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["tf32_round", "lowered"]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (the low 13 mantissa bits cleared, round
    to nearest even); the gradient passes through unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0x0FFF
    r = ((bits + bias) & ~0x1FFF).view(torch.float32).view(x.shape)
    return x + (r - x).detach()


_PRODUCTS = {torch.matmul, torch.mm, torch.bmm, torch.einsum,
             torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.Tensor.__rmatmul__, torch.nn.functional.linear}


class _TF32Inputs(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple(tf32_round(a) if isinstance(a, torch.Tensor)
                         and a.dtype == torch.float32 else a for a in args)
        return func(*args, **kwargs)


@contextlib.contextmanager
def lowered(device):
    """The reference's products in TF32 inside the block."""
    if torch.device(device).type == "cuda":
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old
    else:
        with _TF32Inputs():
            yield
