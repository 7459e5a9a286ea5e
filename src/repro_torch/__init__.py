"""PyTorch/CUDA port of the vertex-cut framework.

Grows beside the JAX package `repro` (the reference) one slice at a time
and never imports it.  It holds `core` — partition → map → simulate,
with its reductions on a hand-written CUDA segment-sum kernel
(`csrc/segsum.cu`) — the trace front end `trace` (NDJSON and `.rtb`
traces into `IRGraph`s), the telemetry layer `obs`, the sharded
partitioner `dist`, the plan service `serve` with its checkpoint store
`checkpoint`, and the serving half of the model stack: `configs`, `kernels` (hand-written CUDA flash
attention, RG-LRU and RWKV6 scans, `csrc/*.cu`), `models` and `launch`.
ROADMAP.md lists what is still to be ported.
"""
__version__ = "0.1.0"
