"""PyTorch/CUDA port of the vertex-cut framework.

Grows beside the JAX package `repro` (the reference) one slice at a time
and never imports it.  This slice holds `core` — partition → map →
simulate, with its reductions on a hand-written CUDA segment-sum kernel
(`csrc/segsum.cu`) — and a minimal `obs`.  ROADMAP.md lists what is
still to be ported.
"""
__version__ = "0.1.0"
