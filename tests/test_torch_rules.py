"""The port's ground rules.

- `repro_torch` imports neither JAX nor the JAX package `repro`, and
  neither does `chip_smoke.py`;
- a call that asks for the card raises when there is none, and never
  carries on on the host;
- a tensor that is not on the CPU has no path to a plain version: it
  launches the kernel or raises;
- what is not ported yet raises and names its ROADMAP item;
- program capture and planning ask for the card unless told otherwise.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core.cuda import _build, segsum  # noqa: E402
from repro_torch.core.planner import (expert_placement,  # noqa: E402
                                      optimal_parallelism, plan_step)
from repro_torch.trace import demo_program  # noqa: E402
from repro_torch.trace.__main__ import main as trace_cli  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PORT = os.path.join(ROOT, "src", "repro_torch")
IMPORT_RE = re.compile(r"^\s*(from|import)\s+(repro|jax)(\.|\s|$)")


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


def _cpu_mlp():
    """The mlp demo program and its arguments on the CPU, flattened for
    `plan_step(fn, *args)`."""
    fn, args = demo_program("mlp", device="cpu")
    return (fn, *args)


def _graph():
    rng = np.random.default_rng(1)
    return T.IRGraph(n=50, src=rng.integers(0, 50, 200),
                     dst=rng.integers(0, 50, 200), w=rng.lognormal(size=200))


def test_importing_the_port_loads_neither_jax_nor_repro():
    """Every package of the port, the training path with grad enabled
    included (a reduced model's loss and its gradients on the CPU)."""
    code = ("import sys, torch, repro_torch, repro_torch.core, "
            "repro_torch.obs, "
            "repro_torch.obs.__main__, repro_torch.trace, "
            "repro_torch.trace.__main__, repro_torch.dist, "
            "repro_torch.serve, repro_torch.serve.__main__, "
            "repro_torch.checkpoint, "
            "repro_torch.core.cuda.metrics, repro_torch.configs, "
            "repro_torch.kernels, repro_torch.kernels.ops, "
            "repro_torch.models, repro_torch.models.convert, "
            "repro_torch.models.moe, repro_torch.core.planner, "
            "repro_torch.launch, repro_torch.launch.steps, "
            "repro_torch.launch.serve, repro_torch.optim, "
            "repro_torch.optim.compress, repro_torch.data, "
            "repro_torch.runtime, repro_torch.launch.train; "
            "from repro_torch import models; "
            "from repro_torch.configs import get_config, reduced_config; "
            "m = models.Model(reduced_config(get_config('smollm-360m')), "
            "device='cpu').requires_grad_(True); "
            "assert torch.is_grad_enabled(); "
            "models.loss_fn(m, {'tokens': torch.zeros((1, 4), "
            "dtype=torch.int64)}).backward(); "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.')); print(bad)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_no_source_line_imports_repro_or_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 10
    for sub in ("configs", "kernels", "models", "launch", "obs", "trace",
                "dist", "serve", "checkpoint", "optim", "data", "runtime"):
        assert any(os.sep + sub + os.sep in f for f in files), sub
    for name in ("launch/train.py", "optim/adamw.py", "optim/compress.py",
                 "data/pipeline.py", "runtime/fault_tolerance.py"):
        assert os.path.join(PORT, *name.split("/")) in files, name
    offending = []
    for path in files:
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                if IMPORT_RE.match(line):
                    offending.append(f"{path}:{lineno}: {line.strip()}")
    assert offending == []


# every entry point's default call asks for the card
@pytest.mark.parametrize("call", [
    lambda g: T.run_pipeline(g, 4, "wb_libra"),
    lambda g: T.run_pipeline(g, 4, "metis"),
    lambda g: T.plan_graph(g, 4),
    lambda g: T.vertex_cut(g, 4),
    lambda g: T.cluster_interaction_graphs(
        T.vertex_cut(g, 4, device="cpu"), 4),
    lambda g: T.simulate(g, T.vertex_cut(g, 4, device="cpu"),
                         T.round_robin_mapping(4)),
    lambda g: expert_placement(np.arange(1.0, 9.0), n_devices=4),
    lambda g: models.Model(reduced_config(get_config("dbrx-132b"))),
    lambda g: plan_step(*_cpu_mlp(), p=4),
    lambda g: optimal_parallelism(*_cpu_mlp(), candidates=(2, 4)),
    lambda g: demo_program("mlp"),
    lambda g: trace_cli(["record", os.devnull]),
])
def test_asking_for_the_card_without_one_raises(call, no_gpu):
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        call(_graph())


@pytest.mark.parametrize("backend", ("fast", "native", "python",
                                     "reference"))
def test_host_backends_ignore_device(backend):
    """`device=` belongs to the cuda backend: a host engine never
    touches the card, so it neither needs one nor checks for one."""
    g = _graph()
    want = T.run_pipeline(g, 4, "wb_libra", device="cpu")
    got = T.run_pipeline(g, 4, "wb_libra", backend=backend, device="cuda")
    np.testing.assert_array_equal(got[0].assignment, want[0].assignment)
    np.testing.assert_array_equal(got[1].core_of, want[1].core_of)
    np.testing.assert_allclose(got[2].core_times, want[2].core_times,
                               rtol=1e-12)
    cut = T.vertex_cut(g, 4, backend=backend, device="cuda")
    map_backend = T.resolve_mapping_backend(backend)
    T.cluster_interaction_graphs(cut, 4, backend=map_backend,
                                 device="cuda")
    T.simulate(g, cut, want[1], backend=map_backend, device="cuda")
    T.plan_graph(g, 4, backend=backend, device="cuda")


def test_device_other_than_cpu_or_cuda_is_refused():
    with pytest.raises(ValueError, match="device"):
        T.run_pipeline(_graph(), 4, "wb_libra", device="meta")


def test_non_cpu_tensor_has_no_path_to_the_plain_version(monkeypatch):
    def no_plain(*args, **kw):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    def no_loader():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(segsum, "segment_sum_plain", no_plain)
    monkeypatch.setattr(_build, "load_library", no_loader)
    data = torch.ones(8, dtype=torch.float64, device="meta")
    ids = torch.zeros(8, dtype=torch.int64, device="meta")
    before = segsum.launches
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        segsum.segment_sum(data, ids, 2)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        segsum.keyed_sum(ids, data, 2)
    assert segsum.launches == before


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_unported_paths_raise_and_name_their_roadmap_item(tmp_path):
    """Nothing of items 4 and 5 raises any more: the encoder (item 4c) is
    ported, so seamless-m4t-large-v2 builds, and program capture (item 5)
    is, so `record` writes a trace that ingests."""
    model = models.Model(reduced_config(get_config("seamless-m4t-large-v2")),
                         device="cpu")
    assert model.encoder is not None and model.encoder_ln is not None
    from repro_torch.trace import ingest_trace
    out = os.path.join(tmp_path, "r.ndjson")
    assert trace_cli(["record", out, "--device", "cpu"]) == 0
    g = ingest_trace(out, keep_labels=True)
    assert (g.n, g.num_edges) == (7, 6)
    assert g.node_labels.count("mm") == 2


def test_chip_smoke_fails_without_a_gpu(no_gpu):
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_obs_records_spans_only_when_enabled():
    from repro_torch import obs
    assert not obs.enabled()
    T.run_pipeline(_graph(), 4, "wb_libra", device="cpu")
    obs.enable()
    try:
        T.run_pipeline(_graph(), 4, "wb_libra", device="cpu")
        obs.observe("probe", 2)
    finally:
        col = obs.disable()
    names = {e["name"] for e in col.events}
    assert {"pipeline.partition", "cut.finalize", "map.cluster_graphs",
            "sim.run"} <= names
    assert col.metrics.snapshot()["histograms"]["probe"]["count"] == 1
    assert not obs.enabled()


def test_cuda_marker_is_registered():
    with open(os.path.join(ROOT, "pyproject.toml")) as f:
        assert "cuda: needs an NVIDIA GPU" in f.read()


def test_model_stack_asks_for_the_card_and_raises_without_one(no_gpu):
    from repro_torch.launch import serve
    cfg = reduced_config(get_config("recurrentgemma-9b"))
    for name in ("recurrentgemma-9b", "dbrx-132b"):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            models.Model(reduced_config(get_config(name)))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        models.prefill(models.Model(cfg, device="cuda"),
                       {"tokens": torch.zeros((1, 4), dtype=torch.int64)},
                       max_len=8)
    cpu = models.Model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        models.from_jax_params(cfg, models.to_jax_params(cpu))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        serve.serve(cfg, batch=1, prompt_len=2, gen=1)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        serve.main(["--arch", "recurrentgemma-9b", "--reduced"])


def test_model_kernels_have_no_path_to_the_plain_version(monkeypatch):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, rglru, rwkv6

    def no_plain(*args, **kw):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(fa, "flash_attention_plain", no_plain)
    monkeypatch.setattr(rglru, "rglru_plain", no_plain)
    monkeypatch.setattr(rwkv6, "rwkv6_plain", no_plain)
    for name in ("attention_ref", "rglru_ref", "rwkv6_ref"):
        monkeypatch.setattr(ops._ref, name, no_plain)
    q = torch.ones((1, 4, 2, 16), device="meta")
    x = torch.ones((1, 4, 16), device="meta")
    u = torch.ones((2, 16), device="meta")
    before = (fa.launches, rglru.launches, rwkv6.launches)
    for impl in ("cuda", "auto"):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            ops.attention(q, q, q, impl=impl)
        with pytest.raises(ValueError, match="CPU or CUDA"):
            ops.rglru(x, x, impl=impl)
        for S in (4, 1):        # prefill and decode
            r = q[:, :S]
            with pytest.raises(ValueError, match="CPU or CUDA"):
                ops.rwkv6(r, r, r, r, u, impl=impl)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rglru.rglru_scan(x, x)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rwkv6.rwkv6_scan(q, q, q, q, u,
                         s0=torch.ones((1, 2, 16, 16), device="meta"))
    assert (fa.launches, rglru.launches, rwkv6.launches) == before


def test_rwkv6_model_builds_and_serves_on_the_cpu():
    """rwkv6-7b is in the slice: it builds, and the launcher serves it
    reduced on the CPU through the plain versions."""
    from repro_torch import models
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels import rwkv6
    from repro_torch.launch import serve
    cfg = reduced_config(get_config("rwkv6-7b"))
    model = models.Model(cfg, device="cpu")
    assert model.kinds == ["rwkv"] * cfg.n_layers
    before = rwkv6.launches
    out = serve.serve(cfg, batch=2, prompt_len=4, gen=3, device="cpu")
    assert out["generated"].shape == (2, 3)
    assert rwkv6.launches == before
