"""What the harness may load, what it needs of a new cell, and what it
does without a card; the benchmark's file against the contract's form."""
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

from portbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _python(code: str, cwd=ROOT, path=(ROOT,)):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [*path, os.path.join(ROOT, "src")]))
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=600)


def test_harness_modules_load_no_jax_and_no_jax_package():
    out = _python("""
        import importlib, os, pkgutil, sys
        import portbench
        from portbench import harness
        root = os.path.dirname(portbench.__file__)
        for sub in ("", "loops", "reference"):
            pkg = "portbench" + ("." + sub if sub else "")
            importlib.import_module(pkg)
            for m in pkgutil.iter_modules([os.path.join(root, sub)]):
                if m.name != "run":
                    importlib.import_module(pkg + "." + m.name)
        for f in os.listdir(os.path.join(root, "metrics")):
            if f.endswith(".py") and f != "__init__.py":
                harness._reader(f[:-3])
        import repro_torch.models, repro_torch.launch.steps
        import repro_torch.optim.adamw
        print(harness.forbidden_modules())
    """)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        return          # only where there is no card
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "smollm-360m.train", "--seed", "4294967311", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "metrics" not in out.stdout and "{" not in out.stdout


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    """A later change adds files and entries only: a copy of the
    benchmark with a new configuration, traffic mix, per-layer metric
    and limits, and nothing edited but BENCHMARK.json's lists."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench = tmp_path / "portbench"
    cfg = json.load(open(bench / "configs" / "smollm-360m.json"))
    cfg.update(name="tiny-decoder", n_layers=2, d_model=64, n_heads=4,
               n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)
    del cfg["n_params"]
    json.dump(cfg, open(bench / "configs" / "tiny-decoder.json", "w"))
    traffic = json.load(open(bench / "traffic" / "text_train_8x2048.json"))
    traffic.update(batch=2, seq_len=16, microbatches=1, pool=4,
                   trace_units=2)
    json.dump(traffic, open(bench / "traffic" / "text_train_2x16.json", "w"))
    (bench / "metrics" / "units_traced.py").write_text(
        "def read(w):\n    return float(w.units)\n")
    shutil.copy(bench / "limits" / "smollm-360m.train.json",
                bench / "limits" / "tiny-decoder.train.json")
    spec["configs"].append({"name": "tiny-decoder", "source": "x",
                            "file": "portbench/configs/tiny-decoder.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "tiny-decoder.train",
                              "config": "tiny-decoder",
                              "traffic": "text_train_2x16", "chips": 1,
                              "why": "x"})
    spec["end_to_end"][0]["workloads"].append("tiny-decoder.train")
    spec["per_layer"].append({"name": "units_traced", "unit": "units",
                              "better": "higher", "source": "program_span",
                              "layer": "x", "moves": "train_tokens_per_s",
                              "workloads": ["tiny-decoder.train"]})
    json.dump(spec, open(tmp_path / "BENCHMARK.json", "w"))
    out = _python(f"""
        import json, time
        from portbench import harness
        cell = harness.load_cell("tiny-decoder.train", root={str(tmp_path)!r})
        r0 = harness.execute(cell, 2**33 + 1, 0.2, False, "cpu",
                             time.perf_counter())
        r1 = harness.execute(cell, 2**33 + 1, 0.2, True, "cpu",
                             time.perf_counter())
        print(json.dumps([r0, r1]))
    """, cwd=tmp_path, path=(str(tmp_path),))
    assert out.returncode == 0, out.stderr
    r0, r1 = json.loads(out.stdout.splitlines()[-1])
    assert r0["correct"] and set(r0["metrics"]) == {"train_tokens_per_s",
                                                    "setup_s"}
    assert r1["correct"] and r1["metrics"]["units_traced"]["value"] == 2.0


def test_benchmark_file_keeps_the_contract_form():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    configs = {c["name"]: c for c in spec["configs"]}
    cells = {w["name"]: w for w in spec["workloads"]}
    names = list(e2e) + [m["name"] for m in spec["per_layer"]]
    assert len(set(names)) == len(names)
    for entry in [*spec["configs"], *spec["workloads"], *e2e.values(),
                  *spec["per_layer"]]:
        assert NAME.match(entry["name"]), entry["name"]
        for key in ("why", "layer", "source"):
            if key in entry and key != "source" or key == "source" and \
                    entry in spec["configs"]:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in \
                    entry[key], (entry["name"], key)
    for c in spec["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in cells.values())
    for m in [*e2e.values(), *spec["per_layer"]]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in cells.values():
        assert w["config"] in configs and w["chips"] in (1, 4)
        reported = [n for n, m in e2e.items()
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in reported and len(reported) >= 2
        layers = [m for m in spec["per_layer"]
                  if w["name"] in m.get("workloads", [w["name"]])]
        assert layers and all(m["moves"] in reported for m in layers)
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "limits", w["name"] + ".json"))
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
