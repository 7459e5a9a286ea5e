"""The plain references against the program at a small size on the CPU
(the kernels' plain versions): the loss, every leaf's gradient, one
AdamW step and the prefill's last-position logits."""
import ast
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.reference import adamw as ref_adamw
from portbench.tests.conftest import small_cell
from portbench.weights import Weights, leaf

CELLS = ["smollm-360m.train"]


def _setup(name, seed=5):
    from repro_torch import models
    run = harness.Run(small_cell(name), seed, "cpu")
    W = Weights(run.ref.param_spec(run.model), 17, "cpu")
    tr = run.traffic
    rows, S = tr["batch"], tr["seq_len"]
    g = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, run.model["vocab_size"], (rows, S),
                                     generator=g)}
    # the program's weights: the same bits, made again from the seed
    model = models.Model(run.model_cfg, device="cpu",
                         params=Weights(run.ref.param_spec(run.model), 17,
                                        "cpu").tree())
    return run, W, batch, model


def _ref_loss(run, W, flat, batch):
    """The mean over sequences of each sequence's mean next-token loss."""
    m, ref = run.model, run.ref
    rows = batch["tokens"].shape[0]
    P = W.views(flat)
    total = 0.0
    for r in range(rows):
        tokens = batch["tokens"][r]
        lg = ref.logits(P, m, ref.hidden(P, m, tokens)[:-1])
        nll = (torch.logsumexp(lg, -1)
               - lg.gather(-1, tokens[1:, None])[:, 0]).mean()
        total = total + nll / rows
    return total


@pytest.mark.parametrize("name", CELLS)
def test_reference_loss_and_gradients_match_the_program(name):
    from repro_torch import models
    run, W, batch, model = _setup(name)
    model.requires_grad_(True)
    loss = models.loss_fn(model, batch)
    params = models.param_tree(model)
    paths = [p for p, _, _ in W.spec]
    grads = torch.autograd.grad(loss, [leaf(params, p) for p in paths])
    flat = W.flat.clone().requires_grad_(True)
    ref_loss = _ref_loss(run, W, flat, batch)
    ref_loss.backward()
    loss, ref_loss = float(loss.detach()), float(ref_loss.detach())
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for p, g in zip(paths, grads):
        want = W.views(flat.grad)[p]
        scale = max(float(want.abs().max()), 1e-12)
        assert float((g - want).abs().max()) <= 1e-4 * scale, p


@pytest.mark.parametrize("name", CELLS)
def test_reference_adamw_step_matches_the_program(name):
    from repro_torch import models
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         adamw_update, tree_map)
    run, W, batch, model = _setup(name)
    opt = dict(run.traffic["optimizer"], lr=0.05, clip_norm=0.5)
    params = models.param_tree(model)
    paths = [p for p, _, _ in W.spec]
    g = torch.Generator().manual_seed(9)
    grad_flat = torch.randn(W.numel, generator=g)
    gv = W.views(grad_flat)
    # the gradient tree shaped as the parameters, each leaf a view of the
    # reference's flat gradient
    flat_of = {id(leaf(params, p)): gv[p] for p in paths}
    grad_tree = tree_map(lambda t: flat_of[id(t)], params)
    cfg = AdamWConfig(**opt)
    state = adamw_init(params, cfg)
    for _ in range(2):
        params, state, _ = adamw_update(params, grad_tree, state, cfg)
    ref = ref_adamw.AdamW(W.numel, "cpu", opt)
    p_ref = W.flat.clone()
    for _ in range(2):
        ref.step(p_ref, grad_flat, ref.clip_scale(grad_flat))
    want = W.views(p_ref)
    for p in paths:
        assert float((leaf(params, p) - want[p]).abs().max()) <= 1e-6, p


def test_reference_prefill_logits_match_the_program():
    from repro_torch.launch.steps import make_prefill_step
    run, W, batch, model = _setup("smollm-360m.prefill")
    got = make_prefill_step(run.model_cfg)(model, batch)
    P = W.views()
    for r in range(batch["tokens"].shape[0]):
        h = run.ref.hidden(P, run.model, batch["tokens"][r])
        want = run.ref.logits(P, run.model, h[-1])
        assert float((got[r] - want).abs().max()) <= \
            1e-5 * float(want.abs().max())


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


FORBIDDEN = {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_reference_imports_nothing_of_the_program():
    here = os.path.join(harness.BENCH_DIR, "reference")
    names = [n[:-3] for n in os.listdir(here) if n.endswith(".py")]
    for name in names:
        tops = {m.split(".")[0] for m in _imports(os.path.join(here,
                                                               name + ".py"))}
        assert not tops & FORBIDDEN, (name, tops)
    # and what they load, in a fresh interpreter
    code = ("import sys\n"
            + "".join(f"import portbench.reference.{n}\n" for n in names)
            + "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=harness.ROOT))
    assert out.returncode == 0, out.stderr
    assert not set(ast.literal_eval(out.stdout)) & FORBIDDEN
