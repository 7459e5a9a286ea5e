"""Logical-axis sharding specs for every parameter tree, and the ambient
mesh the models read them from.

The port of `repro.parallel.sharding`.  Sharding scheme (as the JAX
package's):
  * 'pod'   — pure data parallelism across pods;
  * 'data'  — data parallelism inside a pod; with FSDP enabled it also
              shards the *contraction* dim of every large weight (ZeRO-3
              style, gathered where an operator needs it);
  * 'model' — tensor parallelism: attention heads / MLP ff dim / MoE
              expert dim / vocab dim of the embedding.

A spec is a tuple with one entry per tensor dim: None, a mesh-axis name,
or a tuple of names (one dim sharded over several mesh dims, major
first) — the information of a JAX `PartitionSpec`.  `to_placements`
turns it into DTensor placements over a `DeviceMesh`.

The rules are name-based over the paths of `models.param_tree(model)`.
Its layers are a list, one dict a layer, where the JAX package stacks
them along a leading stage axis; so the JAX rules' leading stage `None`s
drop out, and a cache's batch axis is always dim 0.

The ambient mesh (`current_mesh`, installed by `launch.mesh.
mesh_context`) is module state, not thread-local: with remat, the
backward reruns a layer's forward (and its `maybe_shard`s) on autograd's
device thread, which must see the same mesh.
"""
from __future__ import annotations

import contextlib

import torch

from ..configs.base import ModelConfig, ParallelConfig

__all__ = ["param_specs", "batch_specs", "cache_specs", "DATA_AXES",
           "maybe_shard", "sanitize_specs", "to_placements", "local_region",
           "current_mesh", "use_mesh", "axis_size", "gather_data",
           "settle", "grad_like", "write_at", "sharded_over", "axis_index",
           "max_over", "sum_over"]

DATA_AXES = ("pod", "data")   # batch is sharded over both

_mesh = None                  # the ambient DeviceMesh (None: no mesh)


def current_mesh():
    """The ambient `DeviceMesh`, or None outside `use_mesh`."""
    return _mesh


@contextlib.contextmanager
def use_mesh(mesh):
    """Install `mesh` as the ambient mesh for the block (nests).  Inside
    it a plain tensor that meets a DTensor counts as replicated (DTensor's
    `implicit_replication`): the models make positions, masks and
    constants as plain tensors, as the JAX package makes them unsharded."""
    from torch.distributed.tensor.experimental import implicit_replication
    global _mesh
    prev, _mesh = _mesh, mesh
    try:
        with implicit_replication():
            yield mesh
    finally:
        _mesh = prev


def axis_size(entry) -> int:
    """The number of ranks that a spec entry (an axis name, "data" or a
    tuple) spans on the ambient mesh: 1 outside a mesh or for axes the
    mesh lacks."""
    if _mesh is None:
        return 1
    return _axis_size(_mesh, _fix(entry, _names(_mesh)))


def _spec(*entries) -> tuple:
    """A spec from its entries in `PartitionSpec`'s canonical form: a
    one-name tuple is that name, an empty one None."""
    return tuple(None if isinstance(e, (tuple, list)) and not e
                 else e[0] if isinstance(e, (tuple, list)) and len(e) == 1
                 else tuple(e) if isinstance(e, list) else e
                 for e in entries)


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def _fix(a, names: tuple):
    """One spec entry with the axes the mesh lacks dropped, "data"
    expanded to every data axis present (the JAX package's rule)."""
    if a is None:
        return None
    if a == "data":
        a = DATA_AXES
    if isinstance(a, (tuple, list)):
        t = tuple(ax for ax in a if ax in names)
        return t if t else None
    return a if a in names else None


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def to_placements(spec, mesh) -> list:
    """DTensor placements of `spec` on `mesh`: for each mesh dim, `Shard(d)`
    of the tensor dim `d` whose entry names it, else `Replicate()`.  A
    tuple entry shards one tensor dim over several mesh dims, major first
    (DTensor shards a dim left to right over the mesh dims that name it,
    which is that order when the tuple follows the mesh's axis order, as
    every spec here does)."""
    from torch.distributed.tensor import Replicate, Shard
    names = _names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for ax in _axes(entry):
            if ax in names:
                out[names.index(ax)] = Shard(d)
    return out


def _axis_size(mesh, entry) -> int:
    names, n = _names(mesh), 1
    for ax in _axes(entry):
        if ax in names:
            n *= mesh.size(names.index(ax))
    return n


def _even(mesh, axes, shape) -> tuple:
    """The spec of `axes` on `mesh` (`_fix`ed) for a tensor of `shape`,
    each dim its axes do not divide left replicated."""
    names, spec = _names(mesh), []
    for entry, n in zip(axes, shape):
        entry = _fix(entry, names)
        spec.append(entry if n % _axis_size(mesh, entry) == 0 else None)
    return tuple(spec)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def maybe_shard(x, *axes):
    """Constrain a DTensor activation to the placements `axes` give, a
    no-op outside a mesh (and on a plain tensor).

    `axes` name mesh axes per dim (None / "data" / "model" / a tuple); axes
    not present in the ambient mesh are dropped, and "data" expands to
    every data axis present (("pod", "data") on the multi-pod mesh).  A
    dim its axes do not divide stays replicated (XLA pads an uneven
    shard; DTensor's view rules refuse one).  The models call this on
    activations so the batch, ff and expert dims stay sharded instead of
    replicating large intermediates.
    """
    mesh = _mesh
    if mesh is None or not _is_dtensor(x):
        return x
    spec = _even(mesh, axes, x.shape)
    placements = to_placements(spec, mesh)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def gather_data(w):
    """A DTensor weight with its FSDP sharding undone: every data axis
    replicated (an all-gather over 'pod'/'data'), its 'model' sharding
    kept; the ZeRO-3 gather before a weight's use, whose backward
    reduce-scatters the gradient back to the weight's placements.  A
    plain tensor, or any tensor outside a mesh, as it is."""
    if _mesh is None or not _is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    names = _names(w.device_mesh)
    placements = [Replicate() if n in DATA_AXES else p
                  for n, p in zip(names, w.placements)]
    if placements == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, placements)


class _GradLike(torch.autograd.Function):
    """The identity on a DTensor, whose backward redistributes the
    gradient to the value's own placements (as XLA shards a cotangent as
    its primal)."""

    @staticmethod
    def forward(ctx, y):
        ctx.placements = y.placements
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if _is_dtensor(g) and tuple(g.placements) != tuple(ctx.placements):
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def grad_like(x):
    """`x` whose gradient is redistributed to `x`'s own placements (a
    DTensor under a mesh; anything else as it is)."""
    if _mesh is None or not _is_dtensor(x):
        return x
    return _GradLike.apply(x)


def settle(y):
    """A product's DTensor result made plain to the ops after it: each
    `Partial` placement (a contraction over a sharded dim, the
    row-parallel half of tensor parallelism) all-reduced to `Replicate`,
    and its gradient constrained to the same placements, so that the
    product's backward never meets a layout its forward did not choose.
    A plain tensor, or any tensor outside a mesh, as it is."""
    if _mesh is None or not _is_dtensor(y):
        return y
    if any(p.is_partial() for p in y.placements):
        from torch.distributed.tensor import Replicate
        y = y.redistribute(y.device_mesh, [
            Replicate() if p.is_partial() else p for p in y.placements])
    return _GradLike.apply(y)


def write_at(buf: torch.Tensor, dim: int, index: int,
             value: torch.Tensor) -> None:
    """`buf.select(dim, index).copy_(value)`, in place.  For a DTensor
    `buf` under a mesh, `value` is placed as `buf` is with `dim` taken
    out, and each rank writes its local shard only where it holds
    `index` (a dynamic update of a sharded cache, no collective)."""
    if _mesh is None or not _is_dtensor(buf):
        buf.select(dim, index).copy_(value)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = buf.device_mesh
    placements = []
    chunk, n = 0, 1             # this rank's chunk of dim, of n (major
    for i, p in enumerate(buf.placements):      # mesh dims first)
        if isinstance(p, Shard) and p.dim == dim:
            chunk = chunk * mesh.size(i) + mesh.get_local_rank(i)
            n *= mesh.size(i)
            placements.append(Replicate())
        elif isinstance(p, Shard):
            placements.append(Shard(p.dim - (p.dim > dim)))
        else:
            placements.append(p)
    lo = chunk * (buf.shape[dim] // n)          # even: `sanitize_specs`
    local = buf.to_local()
    if not lo <= index < lo + local.shape[dim]:
        return
    if not _is_dtensor(value):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    local.select(dim, index - lo).copy_(
        value.redistribute(mesh, placements).to_local())


def sharded_over(x, axis: str, dim: int) -> bool:
    """Whether `x` is a DTensor whose dim `dim` is split over the mesh
    axis `axis` of the ambient mesh, on more than one rank."""
    if _mesh is None or not _is_dtensor(x) or axis not in _names(_mesh):
        return False
    i = _names(_mesh).index(axis)
    p = x.placements[i]
    return _mesh.size(i) > 1 and p.is_shard() and p.dim % x.ndim == dim


def axis_index(axis: str) -> int:
    """This rank's index along the ambient mesh's axis `axis`."""
    return _mesh.get_local_rank(axis)


def _all_reduce(x: torch.Tensor, op: str, axis: str) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol
    y = funcol.all_reduce(x, op, (_mesh, _names(_mesh).index(axis)))
    return y.wait() if isinstance(y, funcol.AsyncCollectiveTensor) else y


def max_over(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The elementwise max of a local tensor over the ranks of the
    ambient mesh's axis `axis` (no gradient)."""
    return _all_reduce(x.detach(), "max", axis)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, "sum", axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of a local tensor's partial values over the ranks of the
    ambient mesh's axis `axis` (an all-reduce), for a result that every
    rank of the axis then uses alike: its gradient is the identity (the
    row-parallel reduction of tensor parallelism)."""
    return _SumOver.apply(x, axis)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a
    local gradient goes back into a DTensor, whose rules view it by the
    strides of its global shape."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_region(fn, args: tuple, in_axes: tuple, out_axes):
    """`fn(*args)` run on each rank's local shards, for a function that no
    DTensor sharding rule covers (a kernel's ctypes launch, a dispatch by
    index): outside a mesh, or with no DTensor among `args`, just the call.
    Under a mesh it is DTensor's `local_map` with the placements that the
    axes give.

    `in_axes[i]` names the mesh axes of each dim of `args[i]` as
    `maybe_shard` does (None for an argument that is not a tensor); a dim
    not divisible by its axes' size is replicated instead.  Each tensor
    argument is redistributed to those placements and passed as its local
    shard (a plain tensor counts as replicated).  `out_axes` is the spec
    of `fn`'s output, or a list of specs for a tuple of outputs, each
    output coming back as a DTensor sharded only over the axes that the
    inputs were split over.  The gradient of an input replicated over a
    mesh dim that the region splits is a partial sum over that dim.
    """
    mesh = _mesh
    if mesh is None or not any(_is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    names = _names(mesh)
    at = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
    specs = [_even(mesh, in_axes[i], args[i].shape) for i in at]
    split = {names.index(ax) for s in specs for e in s for ax in _axes(e)}
    in_pl = [tuple(to_placements(s, mesh)) for s in specs]
    grad_pl = [tuple(Partial() if i in split and p.is_replicate() else p
                     for i, p in enumerate(pl)) for pl in in_pl]
    several = isinstance(out_axes, list)
    # an output dim is sharded over the axes the inputs were split over
    # (a dim whose inputs stayed replicated stays so)
    split_names = {names[i] for i in split}
    out_pl = tuple(tuple(to_placements(tuple(
        e if e is not None and set(_axes(e)) <= split_names else None
        for e in (_fix(e, names) for e in ax)), mesh))
        for ax in (out_axes if several else [out_axes]))

    def on_shards(*local):
        full = list(args)
        for i, x in zip(at, local):
            full[i] = _ContiguousGrad.apply(x)
        out = fn(*full)
        # contiguous: DTensor infers the global strides from the local
        # tensor's, and its rules view a gradient by them
        return tuple(o.contiguous() for o in out) if several \
            else out.contiguous()

    # each gradient back at its argument's own placements, as a
    # redistribution's backward would give it
    tensors = [_GradLike.apply(args[i]) if _is_dtensor(args[i])
               else DTensor.from_local(args[i], mesh,
                                       [Replicate()] * len(names),
                                       run_check=False) for i in at]
    return local_map(on_shards, out_pl, in_pl, grad_pl, mesh,
                     redistribute_inputs=True)(*tensors)


def _leaf_spec(names: list, shape: tuple, cfg: ModelConfig,
               par: ParallelConfig) -> tuple:
    name = names[-1] if names[-1] != "w" else names[-2]
    data = "data" if par.fsdp else None
    tp = "model" if par.tp else None
    rank = len(shape)

    def pad(*dims):
        """Leading None for the dims a rule does not name."""
        return (None,) * (rank - len(dims)) + dims

    # ---- embeddings -------------------------------------------------- #
    if name == "table":
        return (tp, None)
    if name == "unembed":
        return (None, tp)

    # ---- MoE expert weights [E, d, ff] -------------------------------- #
    # "2d" (default): E over 'model' + d over 'data' (ZeRO-3 style);
    # "ep_pod": E over ('pod', 'model'), the weights fully resident.
    if name in ("w_in", "w_gate", "w_out") and rank >= 3 and cfg.is_moe \
            and shape[-3] == cfg.n_experts:
        e_axis = ("pod", "model") if par.expert_layout == "ep_pod" \
            else "model"
        d_axis = data if par.expert_layout == "2d" else None
        if name == "w_out":
            return pad(e_axis, None, d_axis)
        return pad(e_axis, d_axis, None)
    if name == "router":
        return pad(data, None)

    # ---- projections: contraction over d -> head/ff dim sharded ------ #
    if name in ("wq", "wk", "wv", "w_in", "w_gate", "wq_b", "wk_b",
                "wv_b", "wx", "wy", "wr", "wi", "wg", "ck", "cr",
                "w_lora_a", "w_lora_b", "wq_a", "wkv_a"):
        return pad(data, tp)
    # ---- output projections: sharded dim contracts ------------------- #
    if name in ("wo", "w_out", "cv"):
        return pad(tp, data)
    if name == "conv_w":
        return pad(None, tp)

    # ---- vectors ------------------------------------------------------ #
    if rank >= 1 and shape[-1] in (cfg.rglru_width or 0, cfg.d_model) \
            and name in ("lam", "u", "conv_b"):
        return pad(tp)
    return (None,) * rank   # norms, mixes, biases: replicated


def _map_with_path(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(v, fn, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _is_spec(x) -> bool:
    return isinstance(x, tuple)


def param_specs(params, cfg: ModelConfig, par: ParallelConfig):
    """The spec tree matching `params` (a tree as `models.param_tree`
    gives it: dicts, a list of layers; any leaf with a `.shape`, real or
    fake tensors included)."""
    return _map_with_path(
        params, lambda path, x: _leaf_spec(list(path), tuple(x.shape),
                                           cfg, par))


def batch_specs(cfg: ModelConfig, batch: dict,
                data_axes=("data",), micro_split: bool = False) -> dict:
    """Input specs: batch dim over the data axes, seq/features replicated.
    `micro_split` marks a leading [n_micro] accumulation dim
    (replicated)."""
    da = tuple(data_axes)
    lead = (None,) if micro_split else ()
    specs = {}
    for k, v in batch.items():
        if k == "mrope_pos":                       # [(micro,)? 3, B, S]
            specs[k] = _spec(*lead, None, da, None)
        elif hasattr(v, "ndim") and v.ndim >= 1:
            rest = v.ndim - len(lead) - 1
            specs[k] = _spec(*lead, da, *(None,) * rest)
        else:
            specs[k] = ()
    return specs


def _cache_leaf_spec(leaf: str, shape: tuple, data_axes=("data",),
                     seq_shard: bool = True) -> tuple:
    """Caches: batch dim (dim 0: the port's cache is one dict a layer)
    over the data axes; long attention caches are also SEQUENCE-sharded
    over 'model' (context parallelism).  Layout per block type: attention
    k/v [B, W, Hkv, hd]; MLA ckv/krope [B, S, r]; rec h [B, rw], conv
    [B, W-1, rw]; rwkv state [B, H, dk, dv]; enc [B, S, d]."""
    rank = len(shape)
    dims = [None] * rank
    if rank > 0:
        dims[0] = tuple(data_axes)
    if seq_shard and leaf in ("k", "v", "ckv", "krope") and rank > 1 \
            and shape[1] >= 4096:
        dims[1] = "model"
    return _spec(*dims)


def cache_specs(cache, data_axes=("data",), seq_shard: bool = True):
    """The spec tree of a `models.Cache` (a list of the layers' dicts)
    or of any tree of them; a `Cache`'s `enc` is not part of the tree."""
    return _map_with_path(
        list(cache) if isinstance(cache, list) else cache,
        lambda path, x: _cache_leaf_spec(path[-1], tuple(x.shape),
                                         data_axes, seq_shard))


def sanitize_specs(spec_tree, shape_tree, mesh):
    """Drop sharding on dims not divisible by the mesh-axis product.

    The JAX package's rule, kept so that both shard the same dims (e.g.
    granite's vocab 49,155 is not divisible by 16, and stays replicated);
    `spec_tree` and `shape_tree` are parallel trees (a spec may also be
    given with one leaf)."""
    sizes = dict(zip(_names(mesh), mesh.shape))

    def fix_leaf(spec, x):
        dims = list(spec) + [None] * (len(x.shape) - len(spec))
        out = []
        for d, axis in zip(x.shape, dims):
            prod = 1
            for a in _axes(axis):
                prod *= sizes.get(a, 1)
            out.append(axis if axis is not None and d % prod == 0 else None)
        return _spec(*out)

    def walk(s, x):
        if _is_spec(s):
            return fix_leaf(s, x)
        if isinstance(s, dict):
            return {k: walk(v, x[k]) for k, v in s.items()}
        return [walk(v, xi) for v, xi in zip(s, x)]

    return walk(spec_tree, shape_tree)
