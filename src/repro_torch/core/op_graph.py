"""PyTorch program -> IR graph: the port's counterpart of the JAX package's
`core/jaxpr_graph.py`.

The paper builds a weighted dataflow graph from a program's *dynamic*
trace (§3).  A PyTorch program has no jaxpr to walk, so this module runs
it once under a `TorchDispatchMode` and builds an `IRGraph` from the ATen
operators that ran (`capture`, `trace_to_graph`):

  * vertex = one executed operator, labelled with its name (`mm`,
    `tanh`, `tanh_backward`, ...); a Python loop runs every iteration,
    so every iteration contributes its own vertices, and a backward
    called inside the capture contributes the backward's operators;
  * edge   = def -> use, one for every tensor operand of every operator;
  * weight = the bytes of the tensor passed, numel * element size,
    clamped to >= 1 as the JAX builder does.

The rules that make the graph faithful:

  * **Inputs.** The tensors of `fn`'s arguments, flattened in order with
    `torch.utils._pytree` (as JAX flattens invars), each get an "input"
    vertex before the first operator.  A tensor first used without having
    been made inside the capture (a module's parameter, say) gets a
    "free" vertex at that first use, created right after its consumer's,
    as the JAX builder creates free variables.
  * **Views.** An operator whose every output aliases an input by its
    schema's alias annotation (`view`, `t`, `select`, `expand`, `split`,
    ...), one that changes only a tensor's metadata in place (the
    `inplace_view` tag: `squeeze_`, `t_`, ...), and `detach` and
    `_unsafe_view`, make no vertex: a view moves no bytes, and its uses
    resolve to the producer of the storage it looks into.
  * **Values are storages.** A tensor's producer is looked up by its
    storage, not by the Python object, so every view of a storage
    resolves to the same producer.  An in-place operator, a write through
    a view or an `out=` write makes a new vertex with an edge from the
    storage's previous producer (an `out=` operand is written, not read),
    and becomes the storage's producer.  Each storage the capture sees is
    pinned by a weak reference for the capture's length, so its identity
    is never reused within one capture; the data is freed as usual, and
    the capture keeps no strong reference to any tensor.
  * **Kernels are one vertex each.**  Every kernel wrapper of the port
    (`flash_attention`, `rglru_scan`, `rwkv6_scan`, `segment_sum`, and the
    backward kernels' calls) runs inside `opaque(name, fn, ...)`: within
    it no dispatched operator makes a vertex (the plain version on the
    CPU, the allocations around a ctypes launch on the card); on exit one
    vertex named after the kernel takes the wrapper's tensor arguments as
    edges and becomes the producer of its outputs and of every storage
    written inside.  So a kernel is one vertex on both devices, as a
    `pallas_call` is one eqn.  With no capture active the region costs one
    module-global read.  On the CPU the backward of a plain version is the
    autograd operators that ran (there is no backward kernel to call).

The active capture is a module global, not thread-local: on the card the
backward runs on autograd's device thread, which inherits the dispatch
mode with the rest of the thread-local state and must find the same
capture.  Python scalars are not tensors, so there are no "lit" vertices.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from .graph import IRGraph

__all__ = ["capture", "trace_to_graph", "op_flops", "opaque",
           "kernel_vertex"]

# the capture that kernel regions report to (None: no capture running)
_active: "_Capture | None" = None

# operators that alias their input without saying so in their schema
_ALIAS_BY_NAME = ("detach", "_unsafe_view")
# the mm family: operator -> position of its left operand [.., M, K]
_MATMUL_LHS = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "vdot": 0,
               "addmm": 1, "baddbmm": 1, "addbmm": 1, "addmv": 1}
_CONV = ("convolution", "_convolution", "conv1d", "conv2d", "conv3d")


def _name(func) -> str:
    return func if isinstance(func, str) else func.overloadpacket.__name__


def _tensors(tree) -> list:
    """The tensors of a pytree (a program's arguments), in flatten order."""
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _operands(items, out: list) -> list:
    """The tensors of an operator's or a kernel wrapper's arguments or
    results (tensors, and lists and tuples of them), in order, appended
    to `out`: `_tensors` without pytree's cost on the per-operator
    path."""
    for x in items:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            _operands(x, out)
    return out


def op_flops(func, args, out) -> float:
    """Rough FLOP estimate of one operator (the planner's cost model, as
    the JAX package's `eqn_flops`): 2*M*N*K for the mm family, 2 * out
    * 9 for a convolution, the output's element count otherwise.  `func`
    is an ATen operator (or its name), `args` its positional arguments
    and `out` what it returned."""
    sizes = [t.numel() for t in _operands((out,), [])]
    out_elems = max(sizes) if sizes else 1
    name = _name(func)
    if name in _MATMUL_LHS:
        return 2.0 * out_elems * args[_MATMUL_LHS[name]].shape[-1]
    if name in _CONV:
        return 2.0 * out_elems * 9
    return float(out_elems)


@functools.lru_cache(maxsize=None)
def _schema_info(func) -> tuple:
    """(is_view, written argument positions and names, out= names)."""
    schema = func._schema
    written = tuple((i, a.name) for i, a in enumerate(schema.arguments)
                    if a.alias_info is not None and a.alias_info.is_write)
    out_kw = frozenset(a.name for a in schema.arguments
                       if a.kwarg_only and a.alias_info is not None
                       and a.alias_info.is_write)
    is_view = (_name(func) in _ALIAS_BY_NAME
               or torch.Tag.inplace_view in func.tags
               or (not written and schema.returns and all(
                   r.alias_info is not None for r in schema.returns)))
    return is_view, written, out_kw


class _Capture(TorchDispatchMode):
    """The dispatch mode that builds the graph while the program runs."""

    def __init__(self):
        super().__init__()
        self.labels: list[str] = []
        self.src: list[int] = []
        self.dst: list[int] = []
        self.w: list[float] = []
        self.producer: dict[int, int] = {}     # storage id -> vertex
        self.pins: dict[int, StorageWeakRef] = {}
        self.region = -1                       # the open kernel's vertex
        self.depth = 0

    def _new(self, label: str) -> int:
        self.labels.append(label)
        return len(self.labels) - 1

    def _key(self, t: torch.Tensor) -> int:
        storage = t.untyped_storage()
        key = storage._cdata
        if key not in self.pins:
            self.pins[key] = StorageWeakRef(storage)
        return key

    def define(self, t: torch.Tensor, nid: int) -> None:
        self.producer[self._key(t)] = nid

    def use(self, t: torch.Tensor, nid: int) -> None:
        key = self._key(t)
        pid = self.producer.get(key)
        if pid is None:
            pid = self.producer[key] = self._new("free")
        self.src.append(pid)
        self.dst.append(nid)
        self.w.append(max(float(t.numel() * t.element_size()), 1.0))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        is_view, written, out_kw = _schema_info(func)
        if is_view:
            return out
        writes = _operands([args[i] if i < len(args) else kwargs.get(name)
                            for i, name in written], [])
        if self.depth:          # inside a kernel: part of its vertex
            nid = self.region
        else:
            nid = self._new(_name(func))
            uses = _operands(args, [])
            if kwargs:
                _operands([v for k, v in kwargs.items() if k not in out_kw],
                          uses)
            for t in uses:
                self.use(t, nid)
        for t in _operands((out,), writes):
            self.define(t, nid)
        return out

    def opaque(self, name: str, fn, args, kwargs):
        if self.depth:          # a kernel called by a kernel is part of it
            return fn(*args, **kwargs)
        nid = self._new(name)
        for t in _operands((*args, *kwargs.values()), []):
            self.use(t, nid)
        self.region, self.depth = nid, 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self.depth = 0
        for t in _operands((out,), []):
            self.define(t, nid)
        return out

    def graph(self, name: str) -> IRGraph:
        return IRGraph(n=len(self.labels), src=np.asarray(self.src, np.int32),
                       dst=np.asarray(self.dst, np.int32),
                       w=np.asarray(self.w, np.float64), name=name,
                       node_labels=list(self.labels))


def opaque(name: str, fn, *args, **kwargs):
    """`fn(*args, **kwargs)` as one vertex `name` of the active capture
    (module docstring); with no capture active, just the call.  An
    exception from `fn` propagates unchanged."""
    cap = _active
    if cap is None:
        return fn(*args, **kwargs)
    return cap.opaque(name, fn, args, kwargs)


def kernel_vertex(name: str):
    """Decorator: every call of the wrapped kernel wrapper is one vertex
    `name` of the active capture (`opaque`).  Signature, results and
    launch counts are the wrapper's own."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            return opaque(name, fn, *args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def installed(mode):
    """Run the block under the dispatch mode `mode`, which also takes every
    kernel region (`opaque` calls `mode.opaque(name, fn, args, kwargs)`):
    the capture's hook, shared with `analysis.hlo_cost`'s cost mode.  One
    such mode at a time."""
    global _active
    if _active is not None:
        raise RuntimeError("a capture is already running")
    _active = mode
    try:
        with mode:
            yield mode
    finally:
        _active = None


def capture(fn, *args, name: str | None = None, **kw):
    """Run `fn(*args, **kw)` once under the capture: (its `IRGraph`, what
    it returned).  It runs where its tensors are; a capture never moves a
    program to another device.  One capture at a time."""
    cap = _Capture()
    for t in _tensors((args, kw)):
        cap.define(t, cap._new("input"))
    with installed(cap):
        out = fn(*args, **kw)
    return cap.graph(name or getattr(fn, "__name__", "fn")), out


def trace_to_graph(fn, *args, name: str | None = None, **kw) -> IRGraph:
    """The `IRGraph` of one run of `fn(*args, **kw)` (`capture`), with the
    JAX package's call shape."""
    return capture(fn, *args, name=name, **kw)[0]
