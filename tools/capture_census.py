"""Census of a captured train step's graph, on the host.

    PYTHONPATH=src python tools/capture_census.py [--arch smollm-360m]

Captures one `make_train_step` of the config at its full depth but the
reduced width of the tests (a graph's vertices and edges do not depend on
the widths) on the CPU, 2 microbatches, and prints its vertex and edge
counts and most frequent labels; then one flash-attention call and its
gradient, so that the vertices a call's plain backward adds on the host
can be told from the one `flash_attention_bwd` vertex the card makes.
No card is needed.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.core.op_graph import capture
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import AdamWConfig, adamw_init


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-360m")
    args = ap.parse_args(argv)
    full = get_config(args.arch)
    cfg = dataclasses.replace(reduced_config(full), n_layers=full.n_layers)
    model = models.Model(cfg, device="cpu", generator=torch.Generator()
                         .manual_seed(0)).requires_grad_(True)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    step = make_train_step(cfg, opt_cfg, ParallelConfig(microbatches=2),
                           impl="cuda")
    opt = adamw_init(models.param_tree(model), opt_cfg)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 2, 64)))
    g, _ = capture(step, model, opt, {"tokens": toks})
    labels = collections.Counter(g.node_labels)
    print(json.dumps({"step": cfg.name, "layers": cfg.n_layers,
                      "vertices": g.n, "edges": g.num_edges,
                      "flash_attention": labels["flash_attention"],
                      "top": labels.most_common(10)}))

    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 64, 4, 16, generator=gen, requires_grad=True)
    k, v = (torch.randn(1, 64, 2, 16, generator=gen, requires_grad=True)
            for _ in range(2))

    def call(q, k, v):
        return torch.autograd.grad(flash_attention(q, k, v).sum(), (q, k, v))

    g1, _ = capture(call, q, k, v)
    labels = collections.Counter(g1.node_labels)
    # the program around the call: 3 inputs, the call, its sum and the
    # seed gradient; the rest is the plain version's backward
    bwd = g1.n - 3 - labels["flash_attention"] - 2
    print(json.dumps({"one_call": {"vertices": g1.n, "edges": g1.num_edges,
                                   "plain_backward_vertices": bwd,
                                   "labels": dict(labels)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
