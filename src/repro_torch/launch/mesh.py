"""Production mesh construction (+ Algorithm-2 device ordering).

The port of `repro.launch.mesh`.  Single-pod: 16×16 = 256 ranks (data,
model).  Multi-pod: 2×16×16 = 512 ranks (pod, data, model); the 'pod'
axis carries only data-parallel gradient reductions.  A mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the
initialised default process group; `fake_world` initialises one of any
size in this process (PyTorch's fake backend: collectives return at once
and move nothing), which is how a mesh larger than the machine is built,
as the JAX package's dry run stands 512 host devices in for the chips.
A 16×16 mesh inside a 512-rank world is the first 256 ranks.  A mesh is
of the card's devices unless the caller asks for the CPU
(`device_type="cpu"`, as the dry run and the tests do): "cuda", the
default, raises when no card is present.

`make_mesh_with_order` feeds a shard-communication matrix through the
paper's memory-centric mapping (`core.planner.mesh_device_order`) so
that heavily-communicating model shards sit on adjacent ranks.

The ambient mesh that `parallel.maybe_shard` reads is kept in one place,
`parallel.sharding` (`mesh_context` installs it): `DeviceMesh`'s own
context manager pushes onto a private stack (`_mesh_resources`, a
`threading.local` in torch 2.13), which the backward of a rematerialised
layer, run on autograd's device thread, would not see.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch.distributed as dist

from ..parallel.sharding import use_mesh

__all__ = ["make_production_mesh", "make_mesh_with_order", "mesh_context",
           "fake_world"]


def mesh_context(mesh):
    """Context manager installing `mesh` as the ambient mesh."""
    return use_mesh(mesh)


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A fake default process group of `world_size` ranks, this process
    being `rank`, for the block; destroyed after it.  Raises when a
    process group is already initialised."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _shape_axes(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def _mesh(ranks: np.ndarray, axes: tuple, device_type: str):
    from torch.distributed.device_mesh import DeviceMesh

    from ..core.cuda import resolve_device
    resolve_device(device_type)
    n = ranks.size
    if not dist.is_initialized() or dist.get_world_size() < n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"need {n} ranks, have {have}")
    return DeviceMesh(device_type, ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape, axes = _shape_axes(multi_pod)
    return _mesh(np.arange(int(np.prod(shape))).reshape(shape), axes,
                 device_type)


def make_mesh_with_order(shard_comm: np.ndarray | None = None, *,
                         multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Mesh whose rank order is chosen by the paper's Algorithm 2.

    `shard_comm[i, j]`: traffic between logical 'model' shards i and j
    (e.g. collective bytes from a dry run).  Shards are mapped to mesh
    columns so communicating shards are neighbours; identity order when
    no matrix is given."""
    shape, axes = _shape_axes(multi_pod)
    ranks = np.arange(int(np.prod(shape)))
    if shard_comm is not None:
        from ..core.planner import mesh_device_order
        m = shape[-1]
        order = mesh_device_order(shard_comm[:m, :m], 1, m)
        # permute the model-axis columns of every (pod, data) row
        grid = ranks.reshape(-1, m)
        inv = np.argsort(order)
        ranks = grid[:, inv].reshape(-1)
    return _mesh(ranks.reshape(shape), axes, device_type)
