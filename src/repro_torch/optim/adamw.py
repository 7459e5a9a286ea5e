"""AdamW with cosine schedule and global-norm clipping, on trees of
tensors.

The port of `repro.optim.adamw`, with its formula (not `torch.optim.AdamW`,
whose clipping, learning rate and order of operations differ): the
gradients are clipped to `clip_norm` by their global norm, the step's
learning rate is the cosine schedule of the step after the update's, and
every leaf is updated in float32 and cast back to its own dtype.

A tree is a nested dict / list of tensors, as `models.init_params` builds
one (`models.param_tree(model)` gives a model's); the optimizer state is
{"m": tree, "v": tree, "step": int32 scalar}.  `moment_dtype` keeps m and
v in bfloat16 where memory is tight.  `adamw_update(..., inplace=True)`
writes the new parameters and moments into the tensors it is given,
under `torch.no_grad()`, so that a full-width model holds no second copy
of its weights; the values equal the functional form's.  The whole update
(clip, schedule, every leaf) is the program span `optim.adamw`.

Two paths, chosen by what the leaves are and by nothing else: where every
leaf of params, grads and both moments is a plain CUDA tensor (not a
DTensor, not a fake tensor) of float32 or bfloat16, and the step counter
a plain int32 CUDA scalar, the update runs as the hand-written kernels
of `csrc/adamw.cu` (`adamw_cuda.update`: three launches for up to 384
leaves, no host sync), one `adamw` vertex under a program capture, each
call adding 1 to the counter `optim.adamw.fused` and to
`adamw_cuda.launches`.  Every other input (CPU leaves, a mesh's
DTensors, a dry run's fake tensors, float16 or float64 leaves) takes the
tree path below, PyTorch operators a leaf.  The two compute the same
formula with the same float32 roundings: p, m and v agree bit for bit
when the clip is not engaged; the kernel sums the norm's squares in
another order (in float64), so when it is, the norm and so the update
differ by float32 rounding.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import obs
from ..core import op_graph
from . import adamw_cuda

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "clip_by_global_norm", "tree_leaves", "tree_map"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: torch.dtype = torch.float32


def tree_leaves(tree) -> list:
    """The leaves in the JAX package's flatten order: dict keys sorted,
    lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in tree_leaves(sub)]
    return [tree]


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` and the trees shaped like it, in
    `tree_leaves`'s order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at `step`, a float32 scalar: linear warm-up, then
    a cosine decay to 0 at `total_steps`."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most `max_norm`, each in its
    own dtype; the global norm before clipping, float32)."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def zeros_as(p: torch.Tensor, dtype) -> torch.Tensor:
    """Zeros of `p`'s shape in `dtype` on `p`'s device; for a DTensor `p`
    a DTensor of its placements.  A plain one is made from the shape
    alone, so a captured program sees no read of `p`."""
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor):
        return torch.zeros_like(p, dtype=dtype,
                                memory_format=torch.contiguous_format)
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zero moments shaped like `params` (in `cfg.moment_dtype`, on each
    leaf's device, and as a leaf's DTensor placements under a mesh) and
    step 0."""
    def zeros(p):
        return zeros_as(p, cfg.moment_dtype)

    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig, *,
                 inplace: bool = False):
    """Returns (new_params, new_state, metrics), metrics holding the
    gradients' global norm and the step's learning rate.

    With `inplace`, the new parameters and moments are written into the
    tensors of `params` and `state` (which are returned); without,
    `params` and `state` are left as they are."""
    with obs.span("optim.adamw"):
        quads = _zip_leaves(params, grads, state["m"], state["v"])
        if _on_card(quads, state["step"]):
            return _fused(params, quads, state, cfg, inplace)
        return _tree_update(params, grads, state, cfg, inplace)


def _zip_leaves(*trees) -> list:
    """The leaves of trees shaped alike, one tuple a leaf in `tree_leaves`
    order: one walk for all of them, as the fused path's host cost is
    per step.  A node that is not exactly a dict, list or tuple is a leaf
    here, so `_on_card` sends such a tree to the tree path."""
    out = []

    def walk(nodes):
        node = nodes[0]
        kind = type(node)
        if kind is dict:
            for k in sorted(node):
                walk([t[k] for t in nodes])
        elif kind is list or kind is tuple:
            for sub in zip(*nodes):
                walk(sub)
        else:
            out.append(nodes)

    walk(trees)
    return out


def _tree_update(params, grads, state: dict, cfg: AdamWConfig,
                 inplace: bool):
    """`adamw_update` as PyTorch operators, leaf by leaf."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        gf = g.float()
        mf = b1 * m.float() + (1 - b1) * gf
        vf = b2 * v.float() + (1 - b2) * gf * gf
        update = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        pf = p.float()
        pf = pf - lr * (update + cfg.weight_decay * pf)
        if inplace:
            p.copy_(pf)
            m.copy_(mf)
            v.copy_(vf)
            return p, m, v
        return pf.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)

    flat = tree_map(upd, params, grads, state["m"], state["v"])
    metrics = {"grad_norm": gnorm, "lr": lr}
    if inplace:
        state["step"].copy_(step)
        return params, state, metrics
    new_p, new_m, new_v = (_pick(flat, i) for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "step": step}, metrics


_PLAIN = (torch.Tensor, torch.nn.Parameter)
_FUSED_DTYPES = (torch.float32, torch.bfloat16)


def _on_card(quads, step) -> bool:
    """What the kernels take: at least one leaf; every leaf of each
    (param, grad, m, v) a plain tensor (a DTensor or a fake tensor is a
    subclass) of float32 or bfloat16 on the step's card; the step a plain
    int32 CUDA scalar."""
    if not (len(quads) > 0 and type(step) in _PLAIN and step.is_cuda
            and step.dtype == torch.int32 and step.dim() == 0):
        return False
    card = step.get_device()
    return all(type(t) in _PLAIN and t.get_device() == card
               and t.dtype in _FUSED_DTYPES
               for quad in quads for t in quad)


def _fused(params, quads, state, cfg, inplace):
    """`adamw_update` through `csrc/adamw.cu`, one `adamw` vertex of a
    capture."""
    leaves = [list(col) for col in zip(*quads)]
    new_p, new_m, new_v, step, scal = op_graph.opaque(
        "adamw", adamw_cuda.update, *leaves, state["step"], cfg, inplace)
    obs.counter("optim.adamw.fused")
    metrics = {"grad_norm": scal[0], "lr": scal[2]}
    if inplace:
        return params, state, metrics

    def like(new):
        it = iter(new)
        return tree_map(lambda _: next(it), params)

    return like(new_p), {"m": like(new_m), "v": like(new_v),
                         "step": step}, metrics


def _pick(tree, i: int):
    """Element i of every (p, m, v) tuple at the leaves of `tree`."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
