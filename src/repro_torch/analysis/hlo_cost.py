"""Cost analysis of one run of a PyTorch program: the port's counterpart
of the JAX package's `analysis/hlo_cost.py` (the module keeps its name
and place so that a reader finds it; there is no HLO in the port).

The JAX analyzer reads a compiled program's text and multiplies each
loop body by its trip count.  A PyTorch program has no text: it runs.
`analyze_program(fn, *args, **kw)` runs `fn` once under a
`TorchDispatchMode` and counts every ATen operator that executes, so a
Python loop's iterations, a backward and a microbatch loop are each
counted as often as they ran (the trip counts are the run's own).  The
counting rules are the JAX analyzer's, per operator instead of per HLO
instruction:

  flops       — the mm family: 2·|out|·K (`core.op_graph.op_flops`); a
                convolution 2·|out|·9; a pointwise operator (ATen's
                `pointwise` tag) its output's elements; a reduction its
                input's elements; softmax and log-softmax 5 elements a
                value forward and 4 backward (max, subtract, exp, sum,
                divide as XLA lowers them).  Data movement (copies,
                casts, concatenation, indexing, sorts, scans) makes no
                FLOPs, as in the JAX analyzer, which counts only
                arithmetic instructions.
  hbm_bytes   — a boundary-traffic model: every operator that is not a
                view reads its tensor operands and writes its outputs,
                each at its own size (a view is read at the view's
                size, never its base's, and a broadcast dim once).
                Eager PyTorch fuses nothing, so every operator is a
                boundary (XLA counts a fusion's boundary only).  `empty`
                allocates and moves nothing.
  collectives — each `_c10d_functional` collective (what DTensor issues)
                by its output's bytes and by a count per op, under the
                JAX names (all-gather, all-reduce, reduce-scatter,
                all-to-all, collective-permute); each also reads and
                writes its bytes once.  `collective_bytes_bf16eq` counts
                float32 collectives at bf16 width, as the JAX field does.
  kernels     — a hand-written kernel's region (`core.op_graph.opaque`:
                the wrapper's call, whatever it runs inside) is costed by
                the function's work, the formulas below, which
                `chip_smoke.py` also divides by the card's peaks for its
                bounds; so the card's counts and the host's differ only
                where a kernel's plain version does other work than the
                kernel.

Under a mesh the operators that reach the mode are each rank's local
ones (the mode lets DTensor unwrap its arguments first), so every count
is per rank, as the JAX analyzer's of an SPMD-partitioned program.
`peak_bytes` is the peak of the bytes of the storages the run allocated
and still held, sampled at every allocation (the dry run's temp bytes).
"""
from __future__ import annotations

import contextlib
import inspect
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core import op_graph
from ..core.cuda.cost import segment_sum_work

__all__ = ["analyze_program", "ProgramCost", "attention_work",
           "attention_bwd_work", "rglru_work", "rglru_bwd_work",
           "rwkv6_work", "rwkv6_bwd_work", "KERNEL_WORK", "op_class"]

_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "all_reduce": "all-reduce",
                "all_reduce_coalesced": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "permute_tensor": "collective-permute"}
_COMM_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                    "c10d")
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "wait_tensor"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "argmax", "argmin", "var", "std", "var_mean", "std_mean",
               "norm", "linalg_vector_norm", "logsumexp", "all", "any",
               "_foreach_norm"}
_SOFTMAX = {"_softmax": 5, "_log_softmax": 5,
            "_softmax_backward_data": 4, "_log_softmax_backward_data": 4}


@dataclass
class ProgramCost:
    """Per-rank totals of one run (the JAX package's `HLOCost` fields),
    with the totals by operator class and the run's peak of live bytes."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: dict = field(default_factory=dict)
    collective_counts: dict = field(default_factory=dict)
    collective_bytes_bf16eq: dict = field(default_factory=dict)
    by_class: dict = field(default_factory=dict)
    peak_bytes: float = 0.0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    @property
    def total_collective_bytes_bf16eq(self) -> float:
        return sum(self.collective_bytes_bf16eq.values())


# ---------------------------------------------------------------------- #
# the kernels' work: (operations, bytes) of the function each computes
# ---------------------------------------------------------------------- #
def _pairs(Sq: int, Sk: int, causal: bool, window, q_offset: int = 0) -> int:
    """The unmasked (query, key) pairs of one attention head."""
    pos = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(pos + 1, Sk) if causal else np.full(Sq, Sk, np.int64)
    lo = np.maximum(pos - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo, 0).sum())


def attention_work(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, Dqk: int,
                   Dv: int, causal: bool, window, itemsize: int,
                   q_offset: int = 0) -> tuple[int, int]:
    """One flash-attention forward: 2·(Dqk + Dv) operations an unmasked
    (query, key) pair (S = QKᵀ and PV), and q, k, v read once and the
    output written once."""
    pairs = _pairs(Sq, Sk, causal, window, q_offset) * B * Hq
    nbytes = itemsize * (B * Sq * Hq + B * Sk * Hkv) * (Dqk + Dv)
    return 2 * (Dqk + Dv) * pairs, nbytes


def attention_bwd_work(B: int, Sq: int, Sk: int, Hq: int, Hkv: int,
                       Dqk: int, Dv: int, causal: bool, window,
                       itemsize: int, q_offset: int = 0) -> tuple[int, int]:
    """One flash-attention backward: 6·Dqk + 4·Dv operations an unmasked
    pair (S and dS·K, dSᵀ·Q over Dqk; dP, Pᵀ·dO over Dv: 10·D at equal
    head dims), and q, k, v, O, dO and the float32 row log-sum-exp read
    once, dq, dk, dv written once."""
    pairs = _pairs(Sq, Sk, causal, window, q_offset)
    ops = (6 * Dqk + 4 * Dv) * pairs * B * Hq
    nbytes = (itemsize * (2 * B * Sq * Hq * (Dqk + Dv)
                          + 2 * B * Sk * Hkv * (Dqk + Dv))
              + 4 * B * Hq * Sq)
    return ops, nbytes


def rglru_work(B: int, S: int, D: int, itemsize: int,
               with_h0: bool = False) -> tuple[int, int]:
    """One RG-LRU scan: 8 operations a (b, t, channel); x and a read, h
    written, h_last (and h0) once a channel."""
    n = B * S * D
    return 8 * n, itemsize * (3 * n + B * D * (2 if with_h0 else 1))


def rglru_bwd_work(B: int, S: int, D: int, itemsize: int,
                   with_h0: bool = False) -> tuple[int, int]:
    """Its gradient: 15 operations a (b, t, channel); x, a, h, dh read,
    dx, da written, dh_last (and h0, dh0) once a channel."""
    n = B * S * D
    return 15 * n, itemsize * (6 * n + B * D * (3 if with_h0 else 1))


def rwkv6_work(B: int, S: int, H: int, Dk: int, Dv: int, itemsize: int,
               with_s0: bool = False) -> tuple[int, int]:
    """One WKV scan: 7·Dk·Dv operations a (b, t, h); r, k, w, v read and
    out written once, u read, S_last (float32; and s0) once."""
    nbytes = (itemsize * B * S * H * (3 * Dk + 2 * Dv) + 4 * H * Dk
              + 4 * B * H * Dk * Dv * (2 if with_s0 else 1))
    return 7 * Dk * Dv * B * S * H, nbytes


def rwkv6_bwd_work(B: int, S: int, H: int, Dk: int, Dv: int,
                   itemsize: int) -> tuple[int, int]:
    """Its gradient: 13·Dk·Dv operations a (b, t, h); r, k, w, v, dout
    and u read, dr, dk, dw, dv and du written once."""
    bths = B * S * H
    nbytes = itemsize * (bths * (3 * Dk + 2 * Dv) + H * Dk
                         + bths * (3 * Dk + Dv) + H * Dk)
    return 13 * Dk * Dv * bths, nbytes


def _fa(a: dict) -> tuple[int, int]:
    q, k, v = a["q"], a["k"], a["v"]
    B, Sq, Hq, Dqk = q.shape
    return attention_work(B, Sq, k.shape[1], Hq, k.shape[2], Dqk,
                          v.shape[3], a["causal"], a["window"],
                          q.element_size(), a["q_offset"])


def _fa_bwd(a: dict) -> tuple[int, int]:
    q, k, v = a["q"], a["k"], a["v"]
    B, Sq, Hq, Dqk = q.shape
    return attention_bwd_work(B, Sq, k.shape[1], Hq, k.shape[2], Dqk,
                              v.shape[3], a["causal"], a["window"],
                              q.element_size(), a["q_offset"])


def _rg(a: dict) -> tuple[int, int]:
    return rglru_work(*a["x"].shape, a["x"].element_size(),
                      a["h0"] is not None)


def _rg_bwd(a: dict) -> tuple[int, int]:
    return rglru_bwd_work(*a["x"].shape, a["x"].element_size(),
                          a["h0"] is not None)


def _wkv(a: dict) -> tuple[int, int]:
    return rwkv6_work(*a["r"].shape, a["v"].shape[3], a["r"].element_size(),
                      a["s0"] is not None)


def _wkv_bwd(a: dict) -> tuple[int, int]:
    return rwkv6_bwd_work(*a["r"].shape, a["v"].shape[3],
                          a["r"].element_size())


def _segsum(a: dict) -> tuple[int, int]:
    data, ids = a["data"], a["segment_ids"]
    return segment_sum_work(data.numel(), a["num_segments"],
                            data.element_size(), ids.element_size())


# kernel region name (`op_graph.opaque`) -> its work from the wrapper's
# bound arguments
KERNEL_WORK = {"flash_attention": _fa, "flash_attention_bwd": _fa_bwd,
               "rglru": _rg, "rglru_bwd": _rg_bwd, "rwkv6": _wkv,
               "rwkv6_bwd": _wkv_bwd, "segment_sum": _segsum}


# ---------------------------------------------------------------------- #
# a kernel on fake tensors
# ---------------------------------------------------------------------- #
# csrc/rwkv6.cu's stride of the forward's float32 state checkpoints (the
# library's `rwkv6_ckpt_steps`, which `chip_smoke.py` checks on the card)
RWKV6_CKPT_STEPS = 16


def _fake_fa(a: dict):
    q, v = a["q"], a["v"]
    B, Sq, Hq, _ = q.shape
    return ((q.new_empty((B, Sq, Hq, v.shape[3])),),
            [q.new_empty((B, Hq, Sq), dtype=torch.float32)])


def _fake_rg(a: dict):
    x = a["x"]
    return (x.new_empty(x.shape), x.new_empty((x.shape[0], x.shape[2]))), []


def _fake_wkv(a: dict):
    r, v = a["r"], a["v"]
    B, S, H, Dk = r.shape
    f32 = torch.float32
    return ((r.new_empty((B, S, H, v.shape[3])),
             r.new_empty((B, H, Dk, v.shape[3]), dtype=f32)),
            [r.new_empty((B, H, -(-S // RWKV6_CKPT_STEPS), Dk, v.shape[3]),
                         dtype=f32)])


def _fake_segsum(a: dict):
    return (a["data"].new_empty((a["num_segments"],)),), []


# kernel region name -> (its outputs, what its forward keeps for the
# backward besides its inputs), allocated as the wrapper allocates them
_FAKE = {"flash_attention": _fake_fa, "rglru": _fake_rg, "rwkv6": _fake_wkv,
         "segment_sum": _fake_segsum}


class _FakeKernel(torch.autograd.Function):
    """A kernel's call on fake tensors, which hold no data: its outputs,
    and what its forward keeps for its backward, are allocated and
    nothing is computed; its backward allocates the inputs' gradients
    and charges the backward kernel's work."""

    @staticmethod
    def forward(ctx, mode, name, a, *inputs):
        outs, kept = _FAKE[name](a)
        ctx.mode, ctx.name, ctx.a, ctx.kept = mode, name, a, kept
        return outs if len(outs) > 1 else outs[0]

    @staticmethod
    def backward(ctx, *grads):
        mode = ctx.mode
        with mode.region():
            inputs = [t for t in ctx.a.values()
                      if isinstance(t, torch.Tensor)]
            dx = [torch.empty_like(t) if need else None for t, need in
                  zip(inputs, ctx.needs_input_grad[3:])]
        mode._add("kernel", *map(float, KERNEL_WORK[ctx.name + "_bwd"](
            ctx.a)))
        ctx.kept = None
        return (None, None, None, *dx)


def _ambient_fake_mode():
    """The innermost `FakeTensorMode` on the dispatch mode stack, or
    None."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    modes = [m for m in _get_current_dispatch_mode_stack()
             if isinstance(m, FakeTensorMode)]
    return modes[-1] if modes else None


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


# ---------------------------------------------------------------------- #
# the dispatch mode
# ---------------------------------------------------------------------- #
def _dtensor_type():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:          # a build without torch.distributed
        return ()
    return (DTensor,)


def _nbytes(t: torch.Tensor) -> int:
    """The bytes of the distinct elements `t` addresses: a broadcast
    (stride-0) dim reads its element once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return (n if t.numel() else 0) * t.element_size()


def op_class(name: str) -> str:
    """The class of the ATen operator `name` (e.g. "mm", "add_"), as the
    analysis counts it: "mm", "conv", "softmax", "reduction", "alloc",
    "pointwise" or "data movement"."""
    packet = getattr(torch.ops.aten, name, None)
    func = getattr(packet, "default", None) if packet is not None else None
    if func is None:
        overloads = packet.overloads() if packet is not None else []
        func = getattr(packet, overloads[0]) if overloads else None
    return _classify(func) if func is not None else "data movement"


def _classify(func) -> str:
    name = op_graph._name(func)
    if name in op_graph._MATMUL_LHS:
        return "mm"
    if name in op_graph._CONV:
        return "conv"
    if name in _SOFTMAX:
        return "softmax"
    if name in _REDUCTIONS:
        return "reduction"
    if name in _NO_TRAFFIC:
        return "alloc"
    if torch.Tag.pointwise in func.tags:
        return "pointwise"
    return "data movement"


class _CostMode(TorchDispatchMode):

    def __init__(self):
        super().__init__()
        # DTensor's sharding propagation tries each new operator once on
        # fake tensors of the global shapes: not the program's work.  It
        # runs in the program's own fake mode, if it has one (counted in
        # `propagating`, see `_propagation_skipped`), else in a fake mode
        # of its own
        self.fake_mode = _ambient_fake_mode()
        self.propagating = 0
        self.cost = ProgramCost()
        self.depth = 0
        self.live = 0
        self.held: set[int] = set()
        self._skip = _dtensor_type()
        self._class: dict = {}
        self._decomposes: dict = {}

    # -- memory: storages allocated during the run, until freed ---------- #
    def _freed(self, key: int, n: int) -> None:
        self.held.discard(key)
        self.live -= n

    def _track(self, outs: list, inputs: set) -> None:
        for t in outs:
            storage = t.untyped_storage()
            key = storage._cdata
            if key in inputs or key in self.held:
                continue
            n = storage.nbytes()
            self.held.add(key)
            self.live += n
            weakref.finalize(storage, self._freed, key, n)
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.live)

    def _add(self, cls: str, flops: float, nbytes: float) -> None:
        c = self.cost
        c.flops += flops
        c.hbm_bytes += nbytes
        row = c.by_class.setdefault(cls, {"count": 0, "flops": 0.0,
                                          "bytes": 0.0})
        row["count"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes

    def _composite(self, func) -> bool:
        c = self._decomposes.get(func)
        if c is None:
            try:
                c = torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), "CompositeImplicitAutograd")
            except RuntimeError:        # prim::device and the like
                c = False
            self._decomposes[func] = c
        return c

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self._skip and any(issubclass(t, self._skip) for t in types):
            return NotImplemented       # DTensor unwraps; its local ops
        kwargs = kwargs or {}           # come back here
        first = next((a for a in args if isinstance(a, torch.Tensor)), None)
        if self.propagating or (first is not None and getattr(
                first, "fake_mode", self.fake_mode) is not self.fake_mode):
            return func(*args, **kwargs)
        if self._composite(func):
            # an operator that reaches the mode whole (under inference
            # mode, `matmul`, `einsum`) is counted by the operators it is
            # made of, as autograd would have dispatched them
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        is_view, _, out_kw = op_graph._schema_info(func)
        if is_view:
            return out
        ins = op_graph._operands(args, [])
        if kwargs:
            op_graph._operands([v for k, v in kwargs.items()
                                if k not in out_kw], ins)
        outs = op_graph._operands((out,), [])
        self._track(outs, {t.untyped_storage()._cdata for t in ins})
        if self.depth:                  # inside a kernel: its work counts
            return out
        ns = func.namespace
        if ns in _COMM_NAMESPACES:
            self._collective(op_graph._name(func), outs)
            return out
        cls = self._class.get(func)
        if cls is None:
            cls = self._class[func] = _classify(func)
        if cls == "alloc":
            self._add(cls, 0.0, 0.0)
            return out
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if cls in ("mm", "conv"):
            flops = op_graph.op_flops(func, args, out)
        elif cls == "pointwise":
            flops = float(max((t.numel() for t in outs), default=0))
        elif cls == "reduction":
            flops = float(ins[0].numel()) if ins else 0.0
        elif cls == "softmax":
            flops = float(_SOFTMAX[op_graph._name(func)] * outs[0].numel())
        else:
            flops = 0.0
        self._add(cls, flops, nbytes)
        return out

    def _collective(self, name: str, outs: list) -> None:
        if name == "wait_tensor":
            return
        op = _COLLECTIVES.get(name, name)
        b = float(sum(_nbytes(t) for t in outs))
        beq = sum(_nbytes(t) / (2 if t.dtype == torch.float32 else 1)
                  for t in outs)
        c = self.cost
        c.collective_bytes[op] = c.collective_bytes.get(op, 0.0) + b
        c.collective_bytes_bf16eq[op] = \
            c.collective_bytes_bf16eq.get(op, 0.0) + beq
        c.collective_counts[op] = c.collective_counts.get(op, 0) + 1
        self._add("collective", 0.0, 2 * b)

    @contextlib.contextmanager
    def region(self):
        """Inside a kernel: operators are the kernel's, their allocations
        still tracked."""
        depth, self.depth = self.depth, 1
        try:
            yield
        finally:
            self.depth = depth

    def opaque(self, name: str, fn, args, kwargs):
        if self.depth:
            return fn(*args, **kwargs)
        bound = inspect.signature(fn).bind(*args, **kwargs)
        bound.apply_defaults()
        a = bound.arguments
        flops, nbytes = KERNEL_WORK[name](a)
        tensors = [t for t in a.values() if isinstance(t, torch.Tensor)]
        with self.region():
            if name in _FAKE and any(_is_fake(t) for t in tensors):
                out = _FakeKernel.apply(self, name, a, *tensors)
            else:
                out = fn(*args, **kwargs)
        self._add("kernel", float(flops), float(nbytes))
        return out


@contextlib.contextmanager
def _propagation_skipped(mode: _CostMode):
    """Count DTensor's fake runs of an operator's global shapes (its
    private `ShardingPropagator._propagate_tensor_meta_non_cached`) in
    `mode.propagating`; where the installed torch has no such method,
    nothing is wrapped."""
    try:
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as prop
        orig = prop._propagate_tensor_meta_non_cached
    except (ImportError, AttributeError):
        yield
        return

    def wrapped(self, *args, **kwargs):
        mode.propagating += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            mode.propagating -= 1

    prop._propagate_tensor_meta_non_cached = wrapped
    try:
        yield
    finally:
        prop._propagate_tensor_meta_non_cached = orig


def analyze_program(fn, *args, **kw) -> ProgramCost:
    """Run `fn(*args, **kw)` once and return its `ProgramCost` (module
    docstring).  It runs where its tensors are, fake tensors included; one
    analysis or capture at a time."""
    mode = _CostMode()
    with _propagation_skipped(mode), op_graph.installed(mode):
        fn(*args, **kw)
    return mode.cost
