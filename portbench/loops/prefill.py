"""The prefill loop: one closed-loop client, each request "batch" prompts
of "seq_len" tokens through the program's `make_prefill_step`.  A request
starts when the client hands its inputs over and ends when the
last-position logits [batch, vocab] are on the host.

Set-up makes "pool" distinct requests from the seed (the client goes
round them) and warms up with the first two.  After the window a sample
of "check_requests" finished requests, drawn from the seed with the
first request in it, is run through the reference, one prompt at a time:
  logits_err  the largest gap of a returned logit from the reference's,
              over the reference's largest logit of that prompt
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import yardstick
from ..weights import Weights
from .common import make_inputs

__all__ = ["Driver", "reference", "compare"]


class Driver:
    def __init__(self, run):
        from repro_torch import models
        from repro_torch.launch.steps import make_prefill_step
        self.run, tr = run, run.traffic
        self.inputs = make_inputs(run, tr["pool"], (tr["batch"],))
        spec = run.ref.param_spec(run.model)
        self.weights = Weights(spec, run.seeds["weights"], run.device)
        self.model = models.Model(run.model_cfg, device=run.device,
                                  params=self.weights.tree())
        n = sum(p.numel() for p in self.model.parameters())
        want = run.cell.config.get("n_params")
        if want is not None and n != want:
            raise RuntimeError(f"built {n} parameters, the configuration "
                               f"states {want}")
        self.step = run.wrap_step(make_prefill_step(run.model_cfg))
        self.next = 0
        self.answers = {}               # request -> host logits
        self.latency = []
        for _ in range(2):              # warm-up, not kept
            self._request()
        self.answers.clear()
        self.next = 0

    def _request(self) -> None:
        i = self.next
        self.next += 1
        batch = {k: v[i % len(v)] for k, v in self.inputs.items()}
        t0 = time.perf_counter()
        out = self.step(self.model, batch).cpu()
        self.latency.append(time.perf_counter() - t0)
        self.answers[i] = out

    def unit(self) -> None:
        self._request()

    def failures(self) -> int:
        """Requests of the window whose logits are not all finite
        (looked at once the window has closed)."""
        return sum(not bool(torch.isfinite(a).all())
                   for a in self.answers.values())

    def end_to_end(self, units: list, window_s: float) -> dict:
        tr = self.run.traffic
        lat = np.asarray(self.latency[-len(units):]) * 1e3
        return {"prefill_tokens_per_s":
                len(units) * tr["batch"] * tr["seq_len"] / window_s,
                "prefill_ms_p90": float(np.percentile(lat, 90))}

    def unit_work(self) -> yardstick.UnitWork:
        tr = self.run.traffic
        fwd = self.run.ref.forward_work(self.run.model, tr["batch"],
                                        tr["seq_len"])
        return yardstick.unit_work(fwd, training=False)

    def observe(self) -> dict:
        tr = self.run.traffic
        done = sorted(self.answers)
        k = min(tr["check_requests"], len(done))
        rng = np.random.default_rng(self.run.seeds["sample"])
        pick = [done[0]] + sorted(
            int(i) for i in rng.choice(done[1:], size=k - 1, replace=False))
        return {"answers": {i: self.answers[i] for i in pick},
                "inputs": self.inputs}

    def release(self) -> None:
        del self.model, self.step, self.weights


def reference(run, observed: dict) -> dict:
    """The reference's last-position logits of each sampled request."""
    m, ref = run.model, run.ref
    W = Weights(ref.param_spec(m), run.seeds["weights"], run.device)
    P = W.views()
    inputs = observed["inputs"]
    out = {}
    with torch.no_grad():
        for i in observed["answers"]:
            u = i % inputs["tokens"].shape[0]
            rows = []
            for r in range(inputs["tokens"].shape[1]):
                h = ref.hidden(P, m, inputs["tokens"][u, r].long())
                rows.append(ref.logits(P, m, h[-1]).cpu())
            out[i] = torch.stack(rows)
    return {"answers": out}


def compare(prog: dict, ref: dict) -> dict:
    worst = 0.0
    for i, want in ref["answers"].items():
        got = prog["answers"][i].double()
        want = want.double()
        gap = float(((got - want).abs().amax(-1)
                     / want.abs().amax(-1)).max())
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return {"logits_err": worst}
