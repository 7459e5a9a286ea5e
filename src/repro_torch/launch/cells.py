"""(architecture × input-shape) cells: input specs, state specs, parallel
plans, and the lowering entry used by the dry run.

The port of `repro.launch.cells`.  The JAX package's inputs are
`ShapeDtypeStruct`s; here they are fake tensors (`FakeTensorMode`: shapes
and dtypes, no storage), so a full config is built and stepped without
memory.  `lower_cell` places every leaf on the mesh as a DTensor with
the placements its spec gives (the counterpart of `in_shardings`) and
returns the step with those inputs, ready to run under its fake mode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .. import models
from ..configs import ARCHS, SHAPES
from ..configs.base import ModelConfig, ParallelConfig, ShapeConfig
from ..optim.adamw import AdamWConfig, adamw_init, tree_leaves
from ..parallel.sharding import (batch_specs, cache_specs, param_specs,
                                 sanitize_specs, to_placements, use_mesh)
from .steps import make_prefill_step, make_serve_step, make_train_step

__all__ = ["Cell", "enumerate_cells", "cell_skip_reason", "lower_cell",
           "parallel_plan", "batch_struct", "input_specs", "lower_step",
           "Prepared", "PARAM_DTYPE", "TOKENS_PER_SHARD_TARGET"]

PARAM_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str

    @property
    def cfg(self) -> ModelConfig:
        return ARCHS[self.arch]

    @property
    def shape_cfg(self) -> ShapeConfig:
        return SHAPES[self.shape]

    @property
    def name(self) -> str:
        return f"{self.arch}/{self.shape}"


def cell_skip_reason(cell: Cell) -> str | None:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    cfg, sc = cell.cfg, cell.shape_cfg
    if sc.name == "long_500k" and not cfg.subquadratic:
        return ("full-attention arch: O(S^2) attention at 524k context — "
                "skipped per assignment (DESIGN.md §6)")
    return None


def enumerate_cells(include_skipped: bool = False) -> list[Cell]:
    cells = [Cell(a, s) for a in ARCHS for s in SHAPES]
    if include_skipped:
        return cells
    return [c for c in cells if cell_skip_reason(c) is None]


# ---------------------------------------------------------------------- #
# per-cell parallel plan
# ---------------------------------------------------------------------- #
TOKENS_PER_SHARD_TARGET = 8_192   # activation working-set control


def parallel_plan(cell: Cell, override: dict | None = None,
                  data_shards: int = 16) -> tuple[ParallelConfig,
                                                  AdamWConfig]:
    cfg, sc = cell.cfg, cell.shape_cfg
    kw: dict[str, Any] = dict(fsdp=True, tp=True, ep=cfg.is_moe)
    opt_kw: dict[str, Any] = {}
    if sc.kind == "train":
        # microbatch so tokens/device stays bounded; remat each layer
        tokens_per_shard = sc.global_batch * sc.seq_len // data_shards
        micro = max(1, min(sc.global_batch // data_shards,
                           tokens_per_shard // TOKENS_PER_SHARD_TARGET))
        kw.update(microbatches=int(micro), remat="block")
        if cfg.param_count() > 100e9:
            opt_kw.update(moment_dtype=torch.bfloat16)
    if override:
        kw.update(override)
    return ParallelConfig(**kw), AdamWConfig(**opt_kw)


# ---------------------------------------------------------------------- #
# inputs (fake tensors under the caller's FakeTensorMode)
# ---------------------------------------------------------------------- #
def batch_struct(cfg: ModelConfig, B: int, S: int, n_micro: int = 1,
                 dtype=PARAM_DTYPE) -> dict:
    """Token batch + modality-frontend stubs (precomputed embeddings),
    as empty tensors (fake ones under a `FakeTensorMode`).  With n_micro
    > 1 the GLOBAL batch B is split: leaves are [n_micro, B/n_micro, ...]."""
    lead = (n_micro,) if n_micro > 1 else ()
    if n_micro > 1:
        assert B % n_micro == 0, (B, n_micro)
        B = B // n_micro
    batch = {"tokens": torch.zeros(lead + (B, S), dtype=torch.int32)}
    if cfg.frontend == "vision":
        n_patch = max(min(256, S // 4), 4)
        batch["patch_embeds"] = torch.zeros(lead + (B, n_patch, cfg.d_model),
                                            dtype=dtype)
        batch["mrope_pos"] = torch.zeros(lead + (3, B, S), dtype=torch.int32)
    if cfg.n_encoder_layers:
        batch["frame_embeds"] = torch.zeros(lead + (B, S, cfg.d_model),
                                            dtype=dtype)
    return batch


def input_specs(cell: Cell, dtype=PARAM_DTYPE,
                n_layers: int | None = None) -> dict:
    """All inputs for the cell's step function, built on the CPU: call it
    under a `FakeTensorMode` (as `lower_cell` does) for a full config.
    `n_layers` cuts the model's depth (the plan stays the cell's)."""
    cfg, sc = cell.cfg, cell.shape_cfg
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    par, opt_cfg = parallel_plan(cell)
    model = models.Model(cfg, device="cpu", dtype=dtype,
                         generator=torch.Generator().manual_seed(0))
    out = {"model": model, "cfg": cfg, "par": par, "opt_cfg": opt_cfg}
    if sc.kind == "train":
        out["batch"] = batch_struct(cfg, sc.global_batch, sc.seq_len,
                                    n_micro=par.microbatches, dtype=dtype)
    elif sc.kind == "prefill":
        out["batch"] = batch_struct(cfg, sc.global_batch, sc.seq_len,
                                    dtype=dtype)
    else:  # decode
        out["cache"] = models.init_cache(model, sc.global_batch, sc.seq_len)
        out["tokens"] = torch.zeros((sc.global_batch,), dtype=torch.int32)
        out["pos"] = sc.seq_len - 1
    return out


# ---------------------------------------------------------------------- #
# placing the inputs on a mesh, and the prepared step
# ---------------------------------------------------------------------- #
def _place(x: torch.Tensor, spec: tuple, mesh):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, to_placements(spec, mesh))


def _place_tree(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: _place_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_place_tree(v, s, mesh) for v, s in zip(tree, specs)]
    return _place(tree, specs, mesh)


def _shard_model(model, specs, mesh) -> None:
    """Replace each parameter of `model` by a DTensor with its spec's
    placements (as `distribute_module` would), keeping requires_grad."""
    def walk(mod, spec_tree):
        for name, p in list(mod._parameters.items()):
            mod._parameters[name] = torch.nn.Parameter(
                _place(p.detach(), spec_tree[name], mesh),
                requires_grad=p.requires_grad)
        for name, sub in mod._modules.items():
            if isinstance(sub, torch.nn.ModuleList):
                for child, s in zip(sub, spec_tree[name]):
                    walk(child, s)
            else:
                walk(sub, spec_tree[name])

    walk(model.embed, specs["embed"])
    walk(model.final_ln, specs["final_ln"])
    for layer, s in zip(model.layers, specs["layers"]):
        walk(layer, s)
    if model.encoder is not None:
        for layer, s in zip(model.encoder, specs["encoder"]["layers"]):
            walk(layer, s)
        walk(model.encoder_ln, specs["encoder"]["final_ln"])
    if model.mtp is not None:
        for layer, s in zip(model.mtp, specs["mtp"]):
            walk(layer, s)
        walk(model.mtp_ln, specs["mtp_ln"])


def _local_bytes(t) -> int:
    local = t.to_local() if hasattr(t, "to_local") else t
    return local.numel() * local.element_size()


@dataclasses.dataclass
class Prepared:
    """A step with its placed inputs: `run()` calls `step(*args)` under the
    mesh (and the fake mode the inputs were made in, if any).
    `argument_bytes` is this rank's bytes of the step's tensor arguments:
    the local shards of the parameters, the optimizer state and the batch
    (or the cache and tokens)."""
    step: Callable
    args: tuple
    mesh: Any
    fake_mode: Any = None
    argument_bytes: int = 0

    def context(self):
        import contextlib
        stack = contextlib.ExitStack()
        if self.fake_mode is not None:
            stack.enter_context(self.fake_mode)
        stack.enter_context(use_mesh(self.mesh))
        return stack

    def run(self):
        with self.context():
            return self.step(*self.args)


def lower_step(model, kind: str, mesh, *, par: ParallelConfig,
               opt_cfg: AdamWConfig | None = None, batch: dict | None = None,
               cache=None, tokens=None, pos: int = 0, impl: str = "auto",
               fake_mode=None) -> Prepared:
    """Place `model` and the step's inputs on `mesh` (each leaf a DTensor
    of the placements `sanitize_specs(param_specs(...))`, `batch_specs`
    and `cache_specs` give) and return the `kind` step ("train",
    "prefill" or "decode") prepared with them.  The tensors may be real
    (a gloo or NCCL mesh) or fake (inside `fake_mode`)."""
    import contextlib
    cfg = model.cfg
    data_axes = tuple(a for a in ("pod", "data")
                      if a in (mesh.mesh_dim_names or ()))
    ctx = fake_mode if fake_mode is not None else contextlib.nullcontext()
    with ctx:
        tree = models.param_tree(model)
        p_specs = sanitize_specs(param_specs(tree, cfg, par), tree, mesh)
        _shard_model(model, p_specs, mesh)
        params = models.param_tree(model)
        args_bytes = sum(_local_bytes(t) for t in tree_leaves(params))
        if kind == "train":
            step = make_train_step(cfg, opt_cfg, par, impl=impl)
            with use_mesh(mesh):
                opt_state = adamw_init(params, opt_cfg)
            b_specs = sanitize_specs(
                batch_specs(cfg, batch, data_axes,
                            micro_split=par.microbatches > 1), batch, mesh)
            placed = _place_tree(batch, b_specs, mesh)
            args = (model, opt_state, placed)
            args_bytes += sum(_local_bytes(t) for t in
                              tree_leaves((opt_state, placed)))
        elif kind == "prefill":
            step = make_prefill_step(cfg, impl=impl)
            b_specs = sanitize_specs(batch_specs(cfg, batch, data_axes),
                                     batch, mesh)
            placed = _place_tree(batch, b_specs, mesh)
            args = (model, placed)
            args_bytes += sum(_local_bytes(t) for t in tree_leaves(placed))
        else:
            step = make_serve_step(cfg)
            c_specs = sanitize_specs(cache_specs(cache, data_axes),
                                     list(cache), mesh)
            placed_cache = models.Cache(_place_tree(list(cache), c_specs,
                                                    mesh))
            placed_cache.enc = cache.enc
            t_spec = sanitize_specs((data_axes,), tokens, mesh)
            placed_tokens = _place(tokens, t_spec, mesh)
            args = (model, placed_cache, placed_tokens, pos)
            args_bytes += sum(_local_bytes(t) for t in
                              tree_leaves((placed_cache, placed_tokens)))
    return Prepared(step, args, mesh, fake_mode, args_bytes)


def lower_cell(cell: Cell, mesh, impl: str = "auto",
               par_override: dict | None = None,
               n_layers: int | None = None):
    """The cell's step on `mesh`, its inputs fake tensors placed there.

    Returns (prepared, meta): `prepared.run()` runs the step once (the
    counterpart of the JAX package's `lowered`, which its dry run
    compiles), and meta records the step kind and plan.  `n_layers` cuts
    the model's depth, the plan staying the cell's (meta records it)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    sc = cell.shape_cfg
    par, opt_cfg = parallel_plan(cell, par_override)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        spec = input_specs(cell, n_layers=n_layers)
    model = spec["model"]
    if sc.kind == "train":
        model.requires_grad_(True)
    prepared = lower_step(model, sc.kind, mesh, par=par, opt_cfg=opt_cfg,
                          batch=spec.get("batch"), cache=spec.get("cache"),
                          tokens=spec.get("tokens"), pos=spec.get("pos", 0),
                          impl=impl, fake_mode=fake)
    meta = {"cell": cell.name, "kind": sc.kind,
            "parallel": dataclasses.asdict(par),
            "params_b": cell.cfg.param_count()}
    if n_layers is not None:
        meta["n_layers"] = n_layers
    return prepared, meta
