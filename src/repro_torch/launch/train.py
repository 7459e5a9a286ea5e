"""Training launcher.

The port of `repro.launch.train`, with its flags and its log, plus
`--device` (the card by default; `--device cpu` runs the kernels' plain
versions):

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --reduced --steps 100 --batch 8 --seq 128 --device cpu

Features wired in: the deterministic sharded data pipeline, AdamW + cosine
schedule + clipping, gradient accumulation, checkpoint/restart (resume
from the latest step automatically), straggler detection.  Checkpoints
hold (params, opt_state) in the JAX package's tree layout (the layers of
each stage stacked, through `models.to_jax_tree`), so either package's
trainer resumes from the other's directory.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import models
from ..checkpoint import CheckpointManager
from ..configs import ARCHS, get_config, reduced_config
from ..configs.base import ModelConfig, ParallelConfig
from ..core.cuda import resolve_device
from ..data import DataConfig, SyntheticLM
from ..optim import AdamWConfig, adamw_init
from ..optim.adamw import tree_leaves
from ..runtime import StragglerDetector
from .steps import make_train_step

__all__ = ["main", "train_state_to_jax", "load_train_state"]


def train_state_to_jax(model, opt_state: dict) -> tuple:
    """(params, opt_state) as the JAX package's trainer checkpoints them:
    numpy trees in its layout, the step an int32 scalar."""
    cfg = model.cfg
    return (models.to_jax_tree(cfg, models.param_tree(model)),
            {"m": models.to_jax_tree(cfg, opt_state["m"]),
             "v": models.to_jax_tree(cfg, opt_state["v"]),
             "step": opt_state["step"].detach().cpu().numpy()})


@torch.no_grad()
def load_train_state(model, opt_state: dict, state: tuple) -> None:
    """Copy a (params, opt_state) tree in the JAX package's layout into
    the model's weights and the optimizer state, in place."""
    params, opt = state
    cfg, device = model.cfg, model.device
    pairs = [(models.param_tree(model), params),
             (opt_state["m"], opt["m"]), (opt_state["v"], opt["v"])]
    for dst, src in pairs:
        src = models.from_jax_tree(cfg, src, device=device)
        for d, s in zip(tree_leaves(dst), tree_leaves(src)):
            d.copy_(s)
    opt_state["step"].copy_(torch.as_tensor(np.asarray(opt["step"])))


def _config(args) -> ModelConfig:
    cfg = get_config(args.arch)
    if args.reduced:
        over = {}
        if args.d_model:
            over.update(d_model=args.d_model,
                        head_dim=max(args.d_model // 8, 16),
                        n_heads=8,
                        n_kv_heads=4 if cfg.n_kv_heads > 1 else 1,
                        d_ff=args.d_model * 4)
        if args.n_layers:
            over.update(n_layers=args.n_layers)
        cfg = reduced_config(cfg, vocab_size=4096, **over)
    return cfg


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-360m", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (e.g. ~100M runs)")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu (the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = _config(args)
    device = resolve_device(args.device)
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20,
                          total_steps=args.steps)
    par = ParallelConfig(fsdp=False, tp=False,
                         microbatches=args.microbatches,
                         remat="none")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq,
                                  global_batch=args.batch,
                                  seed=args.seed))

    model = models.Model(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(args.seed)).requires_grad_(True)
    opt_state = adamw_init(models.param_tree(model), opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, par)

    ckpt = None
    start = 0
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, keep=3)
        latest = ckpt.latest_step()
        if latest is not None:
            state, meta = ckpt.restore(train_state_to_jax(model, opt_state))
            load_train_state(model, opt_state, state)
            start = meta["step"]
            print(f"resumed from step {start}")

    straggler = StragglerDetector()
    losses = []
    for step in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=device) for k, v in
                 data.batch(step, n_micro=args.microbatches).items()}
        t0 = time.time()
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        loss = float(metrics["loss"])      # waits for the step
        dt = time.time() - t0
        flagged = straggler.observe(step, dt)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms"
                  + (" [straggler]" if flagged else ""))
        if ckpt and (step + 1) % args.save_every == 0:
            ckpt.save(step + 1, train_state_to_jax(model, opt_state),
                      blocking=False)
    if ckpt:
        # the last periodic save may still be writing this very step: the
        # JAX package's trainer starts the final save beside it
        ckpt.wait()
        ckpt.save(args.steps, train_state_to_jax(model, opt_state))
    if not losses:
        print(f"no steps left to run (at step {start} of {args.steps})")
        return
    first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
    last = np.mean(losses[-5:])
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
