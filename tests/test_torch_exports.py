"""Every public name of the JAX package has its counterpart in the port.

For every module of `src/repro` with an `__all__`, read by AST (so no
JAX is loaded), each name is imported from the port's counterpart
module: `core.pallas.*` maps to `core.cuda.*`, `core.jaxpr_graph` to
`core.op_graph`, and every other module keeps its path.  A name with no
counterpart is listed below with its reason, and a name the port keeps
under another name with that name; any other missing name fails.
"""
import ast
import importlib
import os

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
REF = os.path.join(ROOT, "src", "repro")

MODULE_MAP = {"core.pallas": "core.cuda", "core.jaxpr_graph": "core.op_graph"}

# (JAX module, name) -> why the port has no counterpart
NO_COUNTERPART = {
    ("kernels.ops", "on_tpu"):
        "the port dispatches on the tensor's device; there is no TPU",
    ("trace", "record_jaxpr"):
        "the port records a program's run (`record_fn`), not a jaxpr",
    ("trace.record", "record_jaxpr"):
        "the port records a program's run (`record_fn`), not a jaxpr",
    ("core.pallas", "DEFAULT_BLOCK"):
        "a Pallas grid's block size; the CUDA kernel sizes its own grid",
    ("core.pallas.segsum", "DEFAULT_BLOCK"):
        "a Pallas grid's block size; the CUDA kernel sizes its own grid",
    ("core.pallas", "pallas_available"):
        "no availability probe: the card's machine has nvcc, and a "
        "missing one raises",
    ("core.pallas.segsum", "pallas_available"):
        "no availability probe: the card's machine has nvcc, and a "
        "missing one raises",
    ("core.pallas", "require_pallas"):
        "no availability probe: `core.cuda.resolve_device` raises instead",
    ("core.pallas.segsum", "require_pallas"):
        "no availability probe: `core.cuda.resolve_device` raises instead",
    ("core.pallas.segsum", "with_x64"):
        "JAX's 64-bit switch; torch computes float64 and int64 as given",
    ("core.pallas.metrics", "trace_count"):
        "counts jit retraces; the port compiles nothing per shape",
}
# (JAX module, name) -> the port's name for it
RENAMED = {
    ("core.jaxpr_graph", "eqn_flops"): "op_flops",
    ("core.jaxpr_graph", "jaxpr_to_graph"): "trace_to_graph",
    ("analysis", "analyze_hlo"): "analyze_program",
    ("analysis", "HLOCost"): "ProgramCost",
    ("analysis.hlo_cost", "analyze_hlo"): "analyze_program",
    ("analysis.hlo_cost", "HLOCost"): "ProgramCost",
}


def _reference_modules() -> list[tuple[str, list]]:
    """(dotted module under `repro`, its `__all__`) for every module of
    the JAX package that has a literal `__all__`."""
    out = []
    for dirpath, _, files in os.walk(REF):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, REF)[:-3].split(os.sep)
            if rel[-1] == "__init__":
                rel = rel[:-1]
            tree = ast.parse(open(path).read())
            for node in tree.body:
                if isinstance(node, ast.Assign) and any(
                        getattr(t, "id", None) == "__all__"
                        for t in node.targets):
                    out.append((".".join(rel), list(
                        ast.literal_eval(node.value))))
    return sorted(out)


def _port_module(mod: str) -> str:
    for old, new in MODULE_MAP.items():
        if mod == old or mod.startswith(old + "."):
            mod = new + mod[len(old):]
    return "repro_torch" + ("." + mod if mod else "")


MODULES = _reference_modules()


def test_the_reference_has_modules_with_all():
    names = [m for m, _ in MODULES]
    assert "parallel.sharding" in names and "launch.cells" in names
    assert len(MODULES) >= 40


@pytest.mark.parametrize("mod,names", MODULES, ids=[m or "repro"
                                                    for m, _ in MODULES])
def test_every_public_name_has_its_counterpart(mod, names):
    port = importlib.import_module(_port_module(mod))
    missing = []
    for name in names:
        if (mod, name) in NO_COUNTERPART:
            assert not hasattr(port, name), \
                f"{name} is listed as having no counterpart, but exists"
            continue
        if not hasattr(port, RENAMED.get((mod, name), name)):
            missing.append(name)
    assert not missing, f"{_port_module(mod)} lacks {missing}"


def test_the_exemptions_name_real_reference_names():
    """Every listed exemption names a name of the JAX module's
    `__all__`, so the lists cannot go stale unseen."""
    public = {(m, n) for m, names in MODULES for n in names}
    for key in list(NO_COUNTERPART) + list(RENAMED):
        assert key in public, key
