"""The port's sharding specs and its sharded train step against the JAX
package.

- Every leaf's spec from `param_specs`, `batch_specs` and `cache_specs`
  equals the JAX package's `PartitionSpec` entry for entry, once the
  JAX tree's leading stage axis is dropped, for all 10 configs, reduced
  (real tensors) and full (fake tensors against `jax.eval_shape`), with
  FSDP and TP on and off and the "2d" and "ep_pod" expert layouts.  The
  trees are bridged with `models.convert.to_jax_tree`: each port leaf is
  replaced by its index, and the stacked JAX leaf holds the indices of
  the layers it stacks.
- `sanitize_specs` as the JAX package's, on duck-typed 16×16 meshes.
- The sharded train step (reduced smollm-360m and dbrx-132b, 2
  microbatches, remat) on a real CPU mesh, gloo with 4 ranks as (2, 2),
  equals the unsharded step in float64 to rtol 1e-9 (every parameter,
  the loss and the gradient norm).  Each rank is a subprocess; they meet
  through a `FileStore` under the test's tmp_path.  The model computes
  its norms and its loss in float32 (`.float()`), as the JAX package's
  does; the workers make `.float()` keep float64, in the sharded and
  the unsharded step alike, so that the comparison sees the sharding
  and not float32 rounding.
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import models  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PARS = {"default": {}, "no-fsdp-no-tp": {"fsdp": False, "tp": False},
        "fsdp-only": {"tp": False}, "ep_pod": {"expert_layout": "ep_pod"}}


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from jax.sharding import PartitionSpec
    from repro import models as jmodels
    from repro.configs import ARCHS as JARCHS, reduced_config as jreduced
    from repro.configs.base import ParallelConfig as JPar
    from repro.parallel import sharding as jsharding
    return types.SimpleNamespace(jax=jax, P=PartitionSpec, models=jmodels,
                                 ARCHS=JARCHS, reduced=jreduced, Par=JPar,
                                 sharding=jsharding)


_BUILT = {}


def _build(arch: str, full: bool):
    """(cfg, the port's param tree, a cache of 2 × 8,192 tokens): real
    tensors at the reduced size, fake ones at the full size; built once
    a module."""
    key = (arch, full)
    if key not in _BUILT:
        from torch._subclasses.fake_tensor import FakeTensorMode
        cfg = get_config(arch) if full else reduced_config(get_config(arch))
        ctx = FakeTensorMode() if full else torch.no_grad()
        with ctx:
            model = models.Model(cfg, device="cpu", dtype=torch.bfloat16,
                                 generator=torch.Generator().manual_seed(0))
            cache = models.init_cache(model, 2, 8192)
        _BUILT[key] = (cfg, models.param_tree(model), cache)
    return _BUILT[key]


def _indexed(tree):
    """The tree with every leaf replaced by a 1-element int64 tensor of
    its index in `tree_leaves` order, and the leaves in that order."""
    leaves = tree_leaves(tree)
    it = iter(range(len(leaves)))
    return tree_map(lambda _: torch.tensor([next(it)]), tree), leaves


def _specs_equal(port_specs: list, jax_specs, idx_tree, jx) -> int:
    """Walk the JAX spec tree beside the bridged index tree: each JAX
    leaf's spec, its stage entry dropped where the leaf is stacked, must
    equal the port spec of every layer it stacks.  Returns the number of
    port leaves checked."""
    jleaves = jx.jax.tree.leaves(jax_specs,
                                 is_leaf=lambda x: isinstance(x, jx.P))
    ileaves = jx.jax.tree.leaves(idx_tree)
    assert len(jleaves) == len(ileaves)
    seen = 0
    for spec, idx in zip(jleaves, ileaves):
        want = tuple(spec)
        if idx.ndim == 2:                 # [n_stages, 1]: stacked layers
            assert want[0] is None, want
            want = want[1:]
        for i in idx.reshape(-1):
            got = port_specs[int(i)]
            assert got == want, (int(i), got, want)
            seen += 1
    return seen


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_the_jax_specs(arch, full, jx):
    """Every parameter's spec, entry for entry, for each parallel plan."""
    jax = jx.jax
    cfg, tree, _ = _build(arch, full)
    jcfg = jx.ARCHS[arch] if full else jx.reduced(jx.ARCHS[arch])
    jparams = jax.eval_shape(lambda k: jx.models.init_params(jcfg, k),
                             jax.random.PRNGKey(0))
    idx_tree, leaves = _indexed(tree)
    bridged = models.convert.to_jax_tree(cfg, idx_tree)
    assert jax.tree.structure(bridged) == jax.tree.structure(jparams)
    for kw in PARS.values():
        specs = _spec_leaves(sharding.param_specs(tree, cfg,
                                                  ParallelConfig(**kw)))
        assert len(specs) == len(leaves)
        jspecs = jx.sharding.param_specs(jparams, jcfg, jx.Par(**kw))
        assert _specs_equal(specs, jspecs, bridged, jx) == len(leaves)


def _spec_leaves(spec_tree) -> list:
    """The specs of a spec tree in `tree_leaves` order (dict keys sorted,
    lists in order)."""
    if isinstance(spec_tree, dict):
        return [s for k in sorted(spec_tree) for s in
                _spec_leaves(spec_tree[k])]
    if isinstance(spec_tree, list):
        return [s for v in spec_tree for s in _spec_leaves(v)]
    return [spec_tree]


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_equal_the_jax_specs(arch, full, jx):
    """Every cache leaf's spec (batch over the data axes, caches of 4,096
    tokens and more also over 'model'), for both meshes' data axes."""
    jax = jx.jax
    cfg, _, cache = _build(arch, full)
    jcfg = jx.ARCHS[arch] if full else jx.reduced(jx.ARCHS[arch])
    jcache = jax.eval_shape(lambda: jx.models.init_cache(jcfg, 2, 8192))
    idx_layers, leaves = _indexed(list(cache))
    bridged = models.convert.to_jax_tree(
        cfg, {"embed": {}, "final_ln": {}, "layers": idx_layers})
    bridged = {k: v for k, v in bridged.items() if k in ("stages", "tail")}
    assert jax.tree.structure(bridged) == jax.tree.structure(jcache)
    for data_axes in (("data",), ("pod", "data")):
        for seq_shard in (True, False):
            specs = _spec_leaves(sharding.cache_specs(
                cache, data_axes, seq_shard))
            jspecs = jx.sharding.cache_specs(jcache, data_axes, seq_shard)
            assert _specs_equal(specs, jspecs, bridged, jx) == len(leaves)
    if full and not cfg.attention_free and cfg.family != "hybrid":
        assert any("model" in s for s in _spec_leaves(
            sharding.cache_specs(cache)))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_specs_equal_the_jax_specs(arch, jx):
    from repro.launch.cells import batch_struct as jbatch

    from repro_torch.launch.cells import batch_struct
    cfg = get_config(arch)
    for n_micro in (1, 4):
        batch = batch_struct(cfg, 16, 256, n_micro=n_micro)
        jb = jbatch(jx.ARCHS[arch], 16, 256, n_micro=n_micro)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in batch.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in jb.items()}
        for data_axes in (("data",), ("pod", "data")):
            got = sharding.batch_specs(cfg, batch, data_axes,
                                       micro_split=n_micro > 1)
            want = jx.sharding.batch_specs(jx.ARCHS[arch], jb, data_axes,
                                           micro_split=n_micro > 1)
            assert got == {k: tuple(v) for k, v in want.items()}


def _meshes(shape, names):
    """Duck-typed meshes for `sanitize_specs`: the port's reads the dim
    names and shape, the JAX package's its axis names and devices."""
    port = types.SimpleNamespace(mesh_dim_names=names, shape=shape)
    jmesh = types.SimpleNamespace(axis_names=names,
                                  devices=np.empty(shape, dtype=object))
    return port, jmesh


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                           "2x16x16"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v3-671b",
                                  "smollm-360m", "rwkv6-7b"])
def test_sanitize_specs_as_the_jax_package(arch, multi_pod, jx):
    """granite's vocab of 49,155 is not divisible by 16: its embedding's
    vocab sharding is dropped, as in the JAX package; every sanitized
    spec equals the JAX one."""
    jax = jx.jax
    shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))
    pmesh, jmesh = _meshes(shape, names)
    cfg, tree, _ = _build(arch, True)
    jcfg = jx.ARCHS[arch]
    jparams = jax.eval_shape(lambda k: jx.models.init_params(jcfg, k),
                             jax.random.PRNGKey(0))
    for kw in ({}, {"expert_layout": "ep_pod"}):
        got = _spec_leaves(sharding.sanitize_specs(
            sharding.param_specs(tree, cfg, ParallelConfig(**kw)), tree,
            pmesh))
        want = jx.sharding.sanitize_specs(
            jx.sharding.param_specs(jparams, jcfg, jx.Par(**kw)), jparams,
            jmesh)
        idx_tree, _ = _indexed(tree)
        _specs_equal(got, want, models.convert.to_jax_tree(cfg, idx_tree),
                     jx)
    if arch == "granite-3-2b":
        table = sharding.sanitize_specs(
            sharding.param_specs(tree, cfg, ParallelConfig()), tree,
            pmesh)["embed"]["table"]
        assert cfg.vocab_size == 49_155 and table == (None, None)
    one = sharding.sanitize_specs(("model",), torch.zeros(7),
                                  _meshes((1,), ("model",))[0])
    assert one == ("model",)          # 7 % 1 == 0


def test_placements_of_a_spec():
    """A spec's entries become Shard placements on the mesh dims they
    name, a tuple entry shards one dim over several mesh dims, absent
    axes stay replicated; `maybe_shard` is a no-op outside a mesh."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert sharding.to_placements((("pod", "data"), None, "model"),
                                  mesh) == [Shard(0), Shard(0), Shard(2)]
    assert sharding.to_placements((None, "model"), mesh) == [
        Replicate(), Replicate(), Shard(1)]
    assert sharding.to_placements(("expert",), mesh) == [Replicate()] * 3
    x = torch.randn(4, 3)
    assert sharding.maybe_shard(x, "data", None) is x
    assert sharding.current_mesh() is None
    assert sharding.axis_size("model") == 1


# ---------------------------------------------------------------------- #
# the sharded train step on a gloo (2, 2) mesh
# ---------------------------------------------------------------------- #
def _gloo_worker(rank: int, world: int, store: str, arch: str,
                 out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.cells import lower_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    as_float = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: (
        self if self.dtype == torch.float64 else as_float(self, *a, **k))
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    cfg = reduced_config(get_config(arch))
    par = ParallelConfig(microbatches=2, remat="block")
    opt_cfg = AdamWConfig(warmup_steps=1, moment_dtype=torch.float64)

    def fresh():
        return models.Model(cfg, device="cpu", dtype=torch.float64,
                            generator=torch.Generator().manual_seed(1)
                            ).requires_grad_(True)

    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (2, 4, 32)).astype(np.int32))}
    ref = fresh()
    ref, _, ref_m = make_train_step(cfg, opt_cfg, par)(
        ref, adamw_init(models.param_tree(ref), opt_cfg), batch)
    mesh = DeviceMesh("cpu", np.arange(world).reshape(2, world // 2),
                      mesh_dim_names=("data", "model"))
    model = fresh()
    prepared = lower_step(model, "train", mesh, par=par, opt_cfg=opt_cfg,
                          batch=batch)
    reduced = {"max": 0, "sum": 0}      # the vocab-parallel all-reduces
    all_reduce = sharding._all_reduce

    def counted(x, op, axis):
        reduced[op] += 1
        return all_reduce(x, op, axis)
    sharding._all_reduce = counted
    model, _, m = prepared.run()
    sharding._all_reduce = all_reduce
    sharded = [p for p in tree_leaves(models.param_tree(model))]
    worst, n_dtensor = 0.0, 0
    for a, b in zip(sharded, tree_leaves(models.param_tree(ref))):
        n_dtensor += hasattr(a, "full_tensor")
        a = a.full_tensor().detach()
        ok = torch.allclose(a, b, rtol=1e-9, atol=1e-15)
        worst = max(worst, float(((a - b).abs() - 1e-9 * b.abs()).max())
                    if not ok else 0.0)
    res = {k: (float(m[k].full_tensor()), float(ref_m[k]))
           for k in ("loss", "grad_norm")}
    dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"metrics": res, "worst_excess": worst,
                       "n_dtensor": n_dtensor, "n": len(sharded),
                       "reduced": reduced}, f)


@pytest.mark.parametrize("arch", ["smollm-360m", "dbrx-132b"])
def test_sharded_train_step_equals_the_unsharded_step(arch, tmp_path):
    world = 4
    store, out = str(tmp_path / "store"), str(tmp_path / "out.json")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         store, arch, out], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    res = json.load(open(out))
    assert res["n_dtensor"] == res["n"]       # every parameter was sharded
    # the loss and the embedding reduced over the vocab split on 'model':
    # per microbatch one max (the loss) and two sums (loss, lookup)
    assert res["reduced"] == {"max": 2, "sum": 4}, res["reduced"]
    assert res["worst_excess"] == 0.0, res
    for key, (got, want) in res["metrics"].items():
        assert abs(got - want) <= 1e-9 * abs(want), (key, got, want)


if __name__ == "__main__":
    _gloo_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                 sys.argv[4], sys.argv[5])
