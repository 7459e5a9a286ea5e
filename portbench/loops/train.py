"""The training loop: `make_train_step` of the program, one step a unit,
each step's loss read back to the host as a trainer logs it.

Set-up builds the model from the seed's weights, AdamW's state and the
step, and drives that same step through its first `check_steps` steps on
the first inputs of the feed (the warm-up, and what the reference
follows); the window goes on from there with the same object.  The
traffic's file gives "batch" sequences of "seq_len" tokens a step in
"microbatches", the optimizer's settings and "pool", the distinct steps
of inputs made at set-up (the feed goes round them).

Compared with the reference, which runs the same first steps from the
same weights and inputs:
  loss_gap         the largest relative gap of a step's loss
  first_loss_gap   the relative gap of the first step's loss (the forward
                   and the loss alone, before AdamW's normalised updates
                   carry the rounding of near-zero gradients into the
                   weights that the later steps run on)
  grad_norm_gap    the worst leaf's gap of the first step's gradient norm
                   as the optimizer got it (the program's read from its
                   first moment, m / (1 - b1))
  grad_diff        the worst leaf's norm of the difference of the first
                   gradients themselves (the program's copied to the host
                   from its first moment at set-up), over the leaf's
                   reference norm or the median leaf's: the norms above
                   average a lower precision's rounding away, the
                   difference keeps it
  update_norm_gap  the worst leaf's gap of the norm of the parameters'
                   change over the checked steps, leaves whose reference
                   gradient is under 1e-3 of the median leaf's left out
Each leaf's gap is over its reference norm or the median leaf's,
whichever is larger.
"""
from __future__ import annotations

import math
import statistics

import torch

from .. import yardstick
from ..reference.adamw import AdamW
from ..weights import Weights, leaf
from .common import make_inputs, rel_gap, worst_leaf_gap

__all__ = ["Driver", "reference", "compare"]


def _shape(tr: dict) -> tuple:
    return (tr["microbatches"], tr["batch"] // tr["microbatches"])


class Driver:
    def __init__(self, run):
        from repro_torch import models
        from repro_torch.configs.base import ParallelConfig
        from repro_torch.launch.steps import make_train_step
        from repro_torch.optim.adamw import AdamWConfig, adamw_init
        self.run, tr = run, run.traffic
        self.inputs = make_inputs(run, tr["pool"], _shape(tr))
        spec = run.ref.param_spec(run.model)
        self.weights = Weights(spec, run.seeds["weights"], run.device)
        self.model = models.Model(run.model_cfg, device=run.device,
                                  params=self.weights.tree())
        n = sum(p.numel() for p in self.model.parameters())
        want = run.cell.config.get("n_params")
        if want is not None and n != want:
            raise RuntimeError(f"built {n} parameters, the configuration "
                               f"states {want}")
        self.model.requires_grad_(True)
        opt_cfg = AdamWConfig(**tr["optimizer"])
        self.step = run.wrap_step(make_train_step(
            run.model_cfg, opt_cfg,
            ParallelConfig(microbatches=tr["microbatches"])))
        self.opt = adamw_init(models.param_tree(self.model), opt_cfg)
        self.failed, self.next = 0, 0
        paths = [p for p, _, _ in spec]
        self.losses = []
        for i in range(tr["check_steps"]):
            self.losses.append(self._step())
            if i == 0:
                self.grad_norms = {p: _norm(leaf(self.opt["m"], p))
                                   / (1.0 - opt_cfg.b1) for p in paths}
                self.first_grad = _to_host(self.weights, self.opt["m"],
                                           1.0 / (1.0 - opt_cfg.b1))
        start = Weights(spec, run.seeds["weights"], run.device).views()
        params = models.param_tree(self.model)
        self.update_norms = {p: _norm(leaf(params, p).detach() - start[p])
                             for p in paths}
        del start

    def _step(self) -> float:
        # the step takes a leading microbatch axis only for two or more
        one = self.run.traffic["microbatches"] == 1
        batch = {k: v[self.next % len(v)][0] if one else v[self.next % len(v)]
                 for k, v in self.inputs.items()}
        self.next += 1
        self.model, self.opt, metrics = self.step(self.model, self.opt,
                                                  batch)
        return float(metrics["loss"])

    def unit(self) -> None:
        if not math.isfinite(self._step()):
            self.failed += 1

    def failures(self) -> int:
        """Steps of the window whose loss was not finite."""
        return self.failed

    def end_to_end(self, units: list, window_s: float) -> dict:
        tr = self.run.traffic
        targets = tr["batch"] * (tr["seq_len"] - 1)
        return {"train_tokens_per_s": len(units) * targets / window_s}

    def unit_work(self) -> yardstick.UnitWork:
        tr = self.run.traffic
        n, rows = _shape(tr)
        fwd = self.run.ref.forward_work(self.run.model, rows, tr["seq_len"])
        step = {"dense": [(p, pos * n) for p, pos in fwd["dense"]],
                "attention": fwd["attention"] * n}
        return yardstick.unit_work(step, training=True)

    def observe(self) -> dict:
        k = self.run.traffic["check_steps"]
        return {"losses": self.losses, "grad_norms": self.grad_norms,
                "update_norms": self.update_norms,
                "first_grad": self.first_grad,
                "slices": self.weights.slices,
                "inputs": {key: v[:k] for key, v in self.inputs.items()}}

    def release(self) -> None:
        """Drop the program's state: model, optimizer, step, weights."""
        del self.model, self.opt, self.step, self.weights, self.inputs


def _to_host(weights: Weights, tree, scale: float) -> torch.Tensor:
    """The leaves of `tree` (shaped as the weights) times `scale`, as one
    flat float32 tensor on the host in the weights' layout."""
    out = torch.empty(weights.numel, dtype=torch.float32)
    for path, a, b, _ in weights.slices:
        out[a:b].copy_(leaf(tree, path).detach().reshape(-1))
    return out.mul_(scale)


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach(), dtype=torch.float64))


def reference(run, observed: dict) -> dict:
    """The reference's losses, first gradient norms and change norms over
    the same steps, one sequence at a time (the gradient of each
    sequence's mean loss over the batch's sequence count, accumulated).
    Each leaf is a leaf tensor of its own over the flat weights, its
    gradient a view of one flat gradient, so that a backward writes the
    gradients in place and allocates no second copy of the weights."""
    tr, m, ref = run.traffic, run.model, run.ref
    spec = ref.param_spec(m)
    W = Weights(spec, run.seeds["weights"], run.device)
    grad = torch.zeros_like(W.flat)
    P = {p: v.detach().requires_grad_(True) for p, v in W.views().items()}
    for p, g in W.views(grad).items():
        P[p].grad = g
    opt = AdamW(W.numel, run.device, tr["optimizer"])
    inputs = observed["inputs"]
    rows = tr["batch"]
    losses, grad_norms = [], None
    for t in range(inputs["tokens"].shape[0]):
        grad.zero_()
        total = 0.0
        for i in range(tr["microbatches"]):
            for r in range(rows // tr["microbatches"]):
                tokens = inputs["tokens"][t, i, r].long()
                h = ref.hidden(P, m, tokens)
                lg = ref.logits(P, m, h[:-1])
                nll = (torch.logsumexp(lg, -1)
                       - lg.gather(-1, tokens[1:, None])[:, 0]).mean()
                (nll / rows).backward()
                total += float(nll.detach())
                del h, lg, nll
        losses.append(total / rows)
        scale = opt.clip_scale(grad)
        if t == 0:
            grad_norms = {p: n * scale for p, n in W.leaf_norms(grad).items()}
            first_grad = (grad * scale).cpu() if grad.numel() < (1 << 28) \
                else torch.cat([g.mul(scale).cpu() for g in grad.split(1 << 28)])
        opt.step(W.flat, grad, scale)
    del P
    start = Weights(spec, run.seeds["weights"], run.device)
    update_norms = W.leaf_norms(W.flat, minus=start.flat)
    return {"losses": losses, "grad_norms": grad_norms,
            "update_norms": update_norms, "first_grad": first_grad,
            "slices": W.slices}


def _diff_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's norm of the difference of the first gradients,
    over that leaf's reference norm or the median leaf's."""
    g, r = prog["first_grad"], ref["first_grad"]
    med = statistics.median(ref["grad_norms"].values())
    worst = 0.0
    for path, a, b, _ in ref["slices"]:
        d = float(torch.linalg.vector_norm(g[a:b] - r[a:b],
                                           dtype=torch.float64))
        worst = max(worst, d / max(ref["grad_norms"][path], med))
    return worst


def compare(prog: dict, ref: dict) -> dict:
    med = statistics.median(ref["grad_norms"].values())
    moved = [p for p, n in ref["grad_norms"].items() if n >= 1e-3 * med]
    return {
        "loss_gap": max(rel_gap(a, b) for a, b in zip(prog["losses"],
                                                      ref["losses"])),
        "first_loss_gap": rel_gap(prog["losses"][0], ref["losses"][0]),
        "grad_norm_gap": worst_leaf_gap(prog["grad_norms"],
                                        ref["grad_norms"]),
        "grad_diff": _diff_gap(prog, ref),
        "update_norm_gap": worst_leaf_gap(prog["update_norms"],
                                          ref["update_norms"], moved),
    }
