"""The port's cells, plans, meshes and dry run against the JAX package.

- Host logic held equal: the 40 cells and their skips, every cell's
  parallel plan and optimizer moments (`tests/test_launch_analysis.py`'s
  cases, and every cell against the JAX `parallel_plan`).
- `make_mesh_with_order` over a fake 256-rank (and 512-rank) group gives
  the rank grid of the JAX mesh's device ids, each package in a
  subprocess (the JAX one needs 512 placeholder devices); a mesh is of
  the card's devices unless the CPU is asked for.
- The dry run of two reduced cells (dbrx-132b training, smollm-360m
  decoding) on fake meshes: a rank's argument bytes equal the shard
  sizes the JAX package's specs imply on a (2, 4) mesh; collectives move
  no bytes on a (1, 1) mesh and some on (2, 4); the loss and the
  embedding lookup reduce over the vocab split on 'model' and never
  gather it.
- The dry-run CLI records a run, its skips and `[skip-done]` on resume,
  with the JAX dry run's keys.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (ARCHS, SHAPES, get_config,  # noqa: E402
                                 reduced_config)
from repro_torch.launch.cells import (Cell, cell_skip_reason,  # noqa: E402
                                      enumerate_cells, parallel_plan)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
       "JAX_PLATFORMS": "cpu"}


@pytest.fixture(scope="module")
def jcells():
    pytest.importorskip("jax")
    from repro.launch import cells
    return cells


def test_cell_enumeration_covers_assignment():
    all_cells = enumerate_cells(include_skipped=True)
    assert len(all_cells) == len(ARCHS) * len(SHAPES) == 40
    runnable = enumerate_cells()
    skipped = [c for c in all_cells if cell_skip_reason(c)]
    assert len(skipped) == 8
    assert all(c.shape == "long_500k" for c in skipped)
    assert {c.arch for c in runnable if c.shape == "long_500k"} == \
        {"rwkv6-7b", "recurrentgemma-9b"}


def test_parallel_plan_bounds_tokens():
    par, opt = parallel_plan(Cell("deepseek-v3-671b", "train_4k"))
    assert par.microbatches >= 8
    assert par.remat != "none"
    assert opt.moment_dtype == torch.bfloat16  # >100B params
    par2, _ = parallel_plan(Cell("smollm-360m", "decode_32k"))
    assert par2.microbatches == 1


def test_cells_and_plans_equal_the_jax_package(jcells):
    """Every cell, its skip reason, its plan and its optimizer config
    (the moments' dtype by name) as the JAX package's, with and without
    an override."""
    jall = jcells.enumerate_cells(include_skipped=True)
    assert [c.name for c in enumerate_cells(include_skipped=True)] == \
        [c.name for c in jall]
    assert jcells.TOKENS_PER_SHARD_TARGET == 8_192
    for jc in jall:
        c = Cell(jc.arch, jc.shape)
        assert cell_skip_reason(c) == jcells.cell_skip_reason(jc)
        for override in (None, {"microbatches": 2, "expert_layout":
                                "ep_pod"}):
            par, opt = parallel_plan(c, override)
            jpar, jopt = jcells.parallel_plan(jc, override)
            assert dataclasses.asdict(par) == dataclasses.asdict(jpar)
            got = dataclasses.asdict(opt)
            want = dataclasses.asdict(jopt)
            assert str(got.pop("moment_dtype")).split(".")[-1] == \
                np.dtype(want.pop("moment_dtype")).name
            assert got == want


_MESH_JAX = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, numpy as np
from repro.launch.mesh import make_mesh_with_order
rng = np.random.default_rng(0)
comm = rng.random((16, 16)); comm = comm + comm.T
ids = lambda m: np.vectorize(lambda d: d.id)(m.devices).tolist()
print(json.dumps([ids(make_mesh_with_order(comm)),
                  ids(make_mesh_with_order(comm, multi_pod=True)),
                  ids(make_mesh_with_order(None))]))
"""
_MESH_PORT = """
import json, numpy as np
from repro_torch.launch.mesh import (fake_world, make_mesh_with_order,
                                     make_production_mesh)
rng = np.random.default_rng(0)
comm = rng.random((16, 16)); comm = comm + comm.T
with fake_world(512):
    a = make_mesh_with_order(comm, device_type="cpu")
    b = make_mesh_with_order(comm, multi_pod=True, device_type="cpu")
    c = make_mesh_with_order(None, device_type="cpu")
    p = make_production_mesh(multi_pod=True, device_type="cpu")
    assert p.mesh_dim_names == ("pod", "data", "model")
    assert tuple(p.shape) == (2, 16, 16) and tuple(a.shape) == (16, 16)
    print(json.dumps([a.mesh.tolist(), b.mesh.tolist(), c.mesh.tolist()]))
"""


def _run(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=ENV, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_mesh_with_vertex_cut_order_equals_the_jax_device_ids():
    pytest.importorskip("jax")
    want = _run(_MESH_JAX)
    got = _run(_MESH_PORT)
    assert got == want
    assert sorted(np.ravel(got[0])) == list(range(256))
    assert got[0] != got[2]            # the order is a permutation


def test_a_mesh_needs_its_ranks():
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        make_production_mesh(device_type="cpu")
    with fake_world(8):
        with pytest.raises(RuntimeError, match="need 512 ranks, have 8"):
            make_production_mesh(multi_pod=True, device_type="cpu")


def test_a_mesh_is_of_the_card_unless_the_cpu_is_asked_for():
    from repro_torch.launch.mesh import (fake_world, make_mesh_with_order,
                                         make_production_mesh)
    with fake_world(256):
        assert make_production_mesh(device_type="cpu").device_type == "cpu"
        if torch.cuda.is_available():
            assert make_production_mesh().device_type == "cuda"
            return
        for make in (make_production_mesh, make_mesh_with_order):
            with pytest.raises(RuntimeError, match="is_available"):
                make()


# ---------------------------------------------------------------------- #
# the dry run of reduced cells on fake meshes
# ---------------------------------------------------------------------- #
def _reduced_dry_run(arch: str, shape: str, mesh_shape: tuple):
    """(prepared, cost, cfg, par, opt_cfg, inputs) of the cell's step at
    the reduced config, batch 8 and 64 tokens, on a fake mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import models
    from repro_torch.analysis import analyze_program
    from repro_torch.launch.cells import batch_struct, lower_step
    from repro_torch.launch.mesh import fake_world

    cell = Cell(arch, shape)
    cfg = reduced_config(get_config(arch))
    par, opt_cfg = parallel_plan(cell, {"microbatches": 2}
                                 if cell.shape_cfg.kind == "train" else None)
    kind = cell.shape_cfg.kind
    with fake_world(int(np.prod(mesh_shape))):
        mesh = DeviceMesh("cpu", np.arange(int(np.prod(mesh_shape)))
                          .reshape(mesh_shape),
                          mesh_dim_names=("data", "model"))
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        with fake:
            model = models.Model(cfg, device="cpu", dtype=torch.bfloat16)
            batch = batch_struct(cfg, 8, 64, n_micro=par.microbatches)
            cache = models.init_cache(model, 8, 64) \
                if kind == "decode" else None
            tokens = torch.zeros(8, dtype=torch.int32)
        model.requires_grad_(kind == "train")
        prepared = lower_step(model, kind, mesh, par=par, opt_cfg=opt_cfg,
                              batch=batch, cache=cache, tokens=tokens,
                              pos=63, fake_mode=fake)
        with prepared.context():
            cost = analyze_program(prepared.step, *prepared.args)
    return prepared, cost, cfg, par, opt_cfg


def _jax_shard_bytes(jx_tree, jspecs, sizes: dict, P) -> int:
    """The bytes of one rank's shards of a JAX tree of ShapeDtypeStructs
    under its specs: each dim divided by its axes' product."""
    import jax
    total = 0
    for leaf, spec in zip(jax.tree.leaves(jx_tree), jax.tree.leaves(
            jspecs, is_leaf=lambda x: isinstance(x, P))):
        n = 1
        for d, entry in zip(leaf.shape, tuple(spec) + (None,) * 8):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            div = int(np.prod([sizes.get(a, 1) for a in axes]))
            assert d % div == 0
            n *= d // div
        total += n * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,shape", [("dbrx-132b", "train_4k"),
                                        ("smollm-360m", "decode_32k")])
def test_dry_run_argument_bytes_are_the_jax_shards(arch, shape):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro import models as jmodels
    from repro.configs import ARCHS as JARCHS, reduced_config as jreduced
    from repro.launch.cells import batch_struct as jbatch
    from repro.optim.adamw import adamw_init as jadamw_init
    from repro.parallel import sharding as js

    prepared, cost, cfg, par, opt_cfg = _reduced_dry_run(arch, shape,
                                                         (2, 4))
    jcfg = jreduced(JARCHS[arch])
    from repro.configs.base import ParallelConfig as JPar
    from repro.optim import AdamWConfig as JAdamW
    jpar = JPar(**dataclasses.asdict(par))
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((2, 4), dtype=object))
    sizes = {"data": 2, "model": 4}
    params = jax.eval_shape(lambda k: jmodels.init_params(
        jcfg, k, dtype=jnp.bfloat16), jax.random.PRNGKey(0))
    p_specs = js.sanitize_specs(js.param_specs(params, jcfg, jpar), params,
                                mesh)
    want = _jax_shard_bytes(params, p_specs, sizes, P)
    if SHAPES[shape].kind == "train":
        # the full config's plan: bfloat16 moments above 100B parameters
        assert opt_cfg.moment_dtype == torch.bfloat16
        jopt = jax.eval_shape(lambda p: jadamw_init(
            p, JAdamW(moment_dtype=jnp.bfloat16)), params)
        want += 2 * _jax_shard_bytes(jopt["m"], p_specs, sizes, P) + 4
        batch = jbatch(jcfg, 8, 64, n_micro=par.microbatches)
        b_specs = js.sanitize_specs(js.batch_specs(
            jcfg, batch, ("data",), micro_split=True), batch, mesh)
        want += _jax_shard_bytes(batch, b_specs, sizes, P)
    else:
        cache = jax.eval_shape(lambda: jmodels.init_cache(
            jcfg, 8, 64, dtype=jnp.bfloat16))
        c_specs = js.sanitize_specs(js.cache_specs(cache, ("data",)), cache,
                                    mesh)
        want += _jax_shard_bytes(cache, c_specs, sizes, P) + 8 // 2 * 4
    assert prepared.argument_bytes == want
    assert cost.total_collective_bytes > 0
    assert cost.peak_bytes > 0 and cost.flops > 0


def test_the_loss_and_the_lookup_keep_the_vocab_split():
    """On a fake (2, 4) mesh the cross entropy and the embedding lookup
    reduce over the vocab split on 'model' (all-reduces of the rows'
    max, log-sum-exp, token logit and looked-up vectors) and never
    gather the vocab: no rank holds the whole vocab's logits or table."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.analysis import analyze_program
    from repro_torch.launch.mesh import fake_world, mesh_context
    from repro_torch.models import layers, model
    from repro_torch.parallel import sharding

    B, S, V, d = 8, 64, 512, 32
    cfg = reduced_config(get_config("smollm-360m"))
    with fake_world(8):
        mesh = DeviceMesh("cpu", np.arange(8).reshape(2, 4),
                          mesh_dim_names=("data", "model"))
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        with mesh_context(mesh), fake:
            def place(x, *axes):
                return distribute_tensor(
                    x, mesh, sharding.to_placements(axes, mesh))
            logits = place(torch.empty(B, S, V, dtype=torch.bfloat16),
                           "data", None, "model").requires_grad_(True)
            tokens = place(torch.zeros(B, S, dtype=torch.int64),
                           "data", None)
            table = place(torch.empty(V, d, dtype=torch.bfloat16),
                          "model", None).requires_grad_(True)
            loss = analyze_program(
                lambda: model._nll(logits, tokens, 1).mean().backward())
            lookup = analyze_program(lambda: layers.embed(
                {"table": table}, cfg, tokens).float().sum().backward())
    rows = B // 2 * (S - 1)
    # the max, then the log-sum-exp and the token's logit together
    assert loss.collective_counts == {"all-reduce": 2}
    assert loss.collective_bytes == {"all-reduce": 3 * rows * 4}
    # the looked-up vectors, and the table's gradient over 'data'
    assert lookup.collective_counts == {"all-reduce": 2}
    assert lookup.collective_bytes == {
        "all-reduce": B // 2 * S * d * 2 + V // 4 * d * 2}


def test_a_one_rank_mesh_moves_no_collective_bytes():
    for arch, shape in (("dbrx-132b", "train_4k"),
                        ("smollm-360m", "decode_32k")):
        _, cost, *_ = _reduced_dry_run(arch, shape, (1, 1))
        assert cost.total_collective_bytes == 0
        assert cost.flops > 0


def test_the_dry_run_cli_records_runs_skips_and_resumes(tmp_path):
    """A decode cell on the 16×16 mesh, a skipped cell on both meshes,
    then `[skip-done]` for the cell already recorded."""
    out = str(tmp_path / "dry.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out", out]
    run = subprocess.run(cmd + ["--arch", "gemma-2b", "--shape",
                                "decode_32k"], capture_output=True,
                         text=True, env=ENV, cwd=ROOT, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    rec = json.load(open(out))
    assert len(rec) == 1 and rec[0]["ok"] is True
    jkeys = {"cell", "kind", "parallel", "params_b", "mesh", "ok",
             "lower_s", "compile_s", "flops", "bytes_accessed",
             "hlo_flops", "hlo_hbm_bytes", "hlo_collective_bytes",
             "hlo_collective_bytes_bf16eq", "hlo_collective_counts",
             "collectives", "memory"}
    assert set(rec[0]) == jkeys
    assert rec[0]["mesh"] == "16x16" and rec[0]["kind"] == "decode"
    assert rec[0]["memory"]["argument_bytes"] > 0
    assert rec[0]["collectives"]["total_bytes"] > 0
    assert rec[0]["compile_s"] == rec[0]["bytes_accessed"] == -1
    again = subprocess.run(cmd + ["--arch", "gemma-2b", "--shape",
                                  "decode_32k"], capture_output=True,
                           text=True, env=ENV, cwd=ROOT, timeout=300)
    assert "[skip-done] gemma-2b/decode_32k on 16x16" in again.stdout
    skip = subprocess.run(cmd + ["--arch", "smollm-360m", "--shape",
                                 "long_500k", "--both-meshes"],
                          capture_output=True, text=True, env=ENV,
                          cwd=ROOT, timeout=300)
    assert skip.returncode == 0, skip.stderr[-3000:]
    rec = json.load(open(out))
    assert [(r["cell"], r["mesh"], r["ok"]) for r in rec[1:]] == [
        ("smollm-360m/long_500k", "16x16", None),
        ("smollm-360m/long_500k", "2x16x16", None)]
    assert "O(S^2)" in rec[-1]["skip_reason"]
