"""The port's ground rules.

- `repro_torch` imports neither JAX nor the JAX package `repro`, and
  neither does `chip_smoke.py`;
- a call that asks for the card raises when there is none, and never
  carries on on the host;
- a tensor that is not on the CPU has no path to a plain version: it
  launches the kernel or raises;
- what is not ported yet raises and names its ROADMAP item.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch.core.cuda import _build, segsum  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PORT = os.path.join(ROOT, "src", "repro_torch")
IMPORT_RE = re.compile(r"^\s*(from|import)\s+(repro|jax)(\.|\s|$)")


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


def _graph():
    rng = np.random.default_rng(1)
    return T.IRGraph(n=50, src=rng.integers(0, 50, 200),
                     dst=rng.integers(0, 50, 200), w=rng.lognormal(size=200))


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.obs, "
            "repro_torch.core.cuda.metrics; "
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
    g = _graph()
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*item 7"):
        T.run_pipeline(g, 4, "wb_libra", backend="dist", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*item 7"):
        T.plan_graph(g, 4, backend="dist", device="cpu")
    trace = os.path.join(ROOT, "examples", "traces", "toy_loop.ndjson")
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*item 2"):
        T.run_pipeline(trace, 4, "wb_libra", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*item 6"):
        T.run_pipeline(g, 4, "wb_libra", device="cpu",
                       profile=os.path.join(tmp_path, "p.json"))


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
        events = obs.disable()
    names = {e["name"] for e in events}
    assert {"pipeline.partition", "cut.finalize", "map.cluster_graphs",
            "sim.run", "probe"} <= names
    assert not obs.enabled()


def test_cuda_marker_is_registered():
    with open(os.path.join(ROOT, "pyproject.toml")) as f:
        assert "cuda: needs an NVIDIA GPU" in f.read()
