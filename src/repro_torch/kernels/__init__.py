"""The model stack's kernels: hand-written CUDA C++ for Hopper, each with
its plain PyTorch version beside it.

`flash_attention` (replaces the Pallas `_fa_kernel`), `rglru`
(replaces `_rglru_kernel`) and `rwkv6` (replaces `_rwkv6_kernel`) wrap
`csrc/flash_attention.cu`, `csrc/rglru.cu` and `csrc/rwkv6.cu`; `ref`
holds the plain versions; `ops` is the dispatch the models call.  The kernels build with the segment-sum kernel into one
library (`core/cuda/_build.py`).
"""
from . import flash_attention, ops, ref, rglru, rwkv6

__all__ = ["flash_attention", "ops", "ref", "rglru", "rwkv6"]
