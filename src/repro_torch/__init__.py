"""PyTorch/CUDA port of the vertex-cut framework.

Grows beside the JAX package `repro` (the reference) one slice at a time
and never imports it.  It holds `core` — partition → map → simulate,
with its reductions on a hand-written CUDA segment-sum kernel
(`csrc/segsum.cu`) — a minimal `obs`, and the serving half of the model
stack: `configs`, `kernels` (hand-written CUDA flash attention and RG-LRU
scan, `csrc/flash_attention.cu` and `csrc/rglru.cu`), `models` and
`launch`.  ROADMAP.md lists what is still to be ported.
"""
__version__ = "0.1.0"
