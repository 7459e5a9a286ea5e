"""Census of a captured train step's graph, on the host.

    PYTHONPATH=src python tools/capture_census.py [--arch smollm-360m]

Captures one `make_train_step` of the config at its full depth but the
reduced width of the tests (a graph's vertices and edges do not depend on
the widths) on the CPU, 2 microbatches, and prints its vertex and edge
counts and most frequent labels; then the labels of one flash-attention
call's gradient, so that the vertices a call's plain backward adds on
the host can be told from the one `flash_attention_bwd` vertex the card
makes; then the labels of the step's AdamW update on the host (the tree
path's operators, where the card makes one `adamw` vertex).  No card is
needed; `chip_smoke.py` phase 18e captures the same step on the card
(`census_step(device="cuda")`) and holds its labels to the host's.
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
from repro_torch.optim import AdamWConfig, adamw, adamw_init
from repro_torch.optim.adamw import tree_map

CENSUS_OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)


def census_step(arch: str = "smollm-360m", device: str = "cpu"):
    """(the step, its arguments): one `make_train_step` of the config at
    its full depth and the tests' reduced width, 2 microbatches of 2 x 64
    tokens, impl="cuda" (the kernels on the card, their plain versions on
    the host), with the weights of a seed-0 host model on `device`."""
    full = get_config(arch)
    cfg = dataclasses.replace(reduced_config(full), n_layers=full.n_layers)
    host = models.Model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    model = models.Model(cfg, device=device, params=tree_map(
        lambda t: t.detach().to(device), models.param_tree(host))
    ).requires_grad_(True)
    step = make_train_step(cfg, CENSUS_OPT, ParallelConfig(microbatches=2),
                           impl="cuda")
    opt = adamw_init(models.param_tree(model), CENSUS_OPT)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 2, 64))).to(device)
    return step, (model, opt, {"tokens": toks})


def one_call_backward_labels() -> collections.Counter:
    """The labels one flash-attention call's gradient adds on the host:
    its plain version's backward operators (the card makes one
    `flash_attention_bwd` vertex instead)."""
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
    for label, n in (("input", 3), ("flash_attention", 1), ("sum", 1),
                      ("ones_like", 1)):
        labels[label] -= n
    return +labels


def adamw_tree_labels(step_args) -> collections.Counter:
    """The labels the step's AdamW update makes on the host: the tree
    path (`adamw._tree_update`, in place, as the step runs it) on the
    leaves of `census_step`'s arguments `step_args`, captured alone, less
    its inputs (the card makes one `adamw` vertex instead).  The update
    is written into those arguments."""
    model, opt = step_args[:2]
    params = models.param_tree(model)
    grads = tree_map(torch.zeros_like, params)

    def update(params, grads, opt):
        with torch.no_grad():
            return adamw._tree_update(params, grads, opt, CENSUS_OPT, True)

    g, _ = capture(update, params, grads, opt)
    labels = collections.Counter(g.node_labels)
    del labels["input"]
    return labels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-360m")
    args = ap.parse_args(argv)
    step, step_args = census_step(args.arch)
    g, _ = capture(step, *step_args)
    labels = collections.Counter(g.node_labels)
    print(json.dumps({"step": args.arch, "layers": len(step_args[0].layers),
                      "vertices": g.n, "edges": g.num_edges,
                      "flash_attention": labels["flash_attention"],
                      "top": labels.most_common(10)}))
    bwd = one_call_backward_labels()
    print(json.dumps({"one_call": {"plain_backward_vertices":
                                   sum(bwd.values()),
                                   "labels": dict(bwd)}}))
    opt = adamw_tree_labels(census_step(args.arch)[1])
    print(json.dumps({"adamw": {"tree_path_vertices": sum(opt.values()),
                                "labels": dict(opt)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
