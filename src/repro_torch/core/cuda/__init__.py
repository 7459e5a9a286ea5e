"""The port's device layer: hand-written CUDA kernels and their torch glue.

`segsum` holds the sorted-segment sum (the CUDA kernel's wrapper, its
plain version and `keyed_sum`); `metrics` builds the replica CSR, the
star triples and the interaction graphs on it; `_build` compiles
`csrc/*.cu` with nvcc.  Selected in the core modules as `backend="cuda"`,
on the device that `device=` names: the card by default, the host (with
the kernels' plain versions) when the caller passes `device="cpu"`.
"""
from __future__ import annotations

import torch

from .segsum import keyed_sum, segment_sum, segment_sum_plain

__all__ = ["keyed_sum", "segment_sum", "segment_sum_plain", "resolve_device"]


def resolve_device(device) -> torch.device:
    """`device` as a torch device; raises where it cannot be had.

    "cuda" needs `torch.cuda.is_available()`: without a card the call
    fails, and never carries on on the host.  Only "cpu" and "cuda" are
    accepted.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the host")
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    return dev
