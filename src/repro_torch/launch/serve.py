"""Serving launcher: batched greedy decoding with a KV/state cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --reduced --batch 4 --prompt-len 32 --gen 32 [--device cpu]

The port of `repro.launch.serve`, with the same flags and `--device`
(default `cuda`, which needs a card).  The prompt is replayed through
`decode_step` to populate the cache (the decode-vs-forward equivalence is
test-verified), then generation proceeds greedily.  Requests are batched:
all sequences advance in lockstep.  An encoder-decoder config
(seamless-m4t-large-v2) serves decoder-only, as the JAX launcher does:
it passes no frames, so the cross attentions do not run.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import models
from ..configs import ARCHS, get_config, reduced_config
from ..configs.base import ModelConfig
from ..core.cuda import resolve_device
from .steps import make_serve_step

__all__ = ["serve", "main"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def serve(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 32,
          gen: int = 32, seed: int = 0, device="cuda") -> dict:
    """Serve `batch` random prompts of `prompt_len` tokens and generate
    `gen` tokens each, greedily.

    The weights come from a generator seeded with `seed` on `device`; the
    prompts from numpy's generator with the same seed, as in the JAX
    launcher.  Returns the model, the prompts
    [B, prompt_len], the generated ids [B, gen] (int32), the logits after
    the prompt replay [B, V], and the host-clock seconds of the replay
    (`prefill_s`) and of generation (`gen_s`), each ending in a device
    synchronise.
    """
    dev = resolve_device(device)
    model = models.Model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    max_len = prompt_len + gen
    print(f"serving {cfg.name}: batch={batch} prompt={prompt_len} gen={gen}")

    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
        dtype=torch.int32).to(dev)
    cache = models.init_cache(model, batch, max_len)
    step = make_serve_step(cfg)

    # replay prompt to fill the cache
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(prompt_len):
        logits, cache = models.decode_step(model, cache, prompts[:, t], t)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    # greedy generation
    out = []
    tok = nxt
    t0 = time.perf_counter()
    for t in range(prompt_len, max_len):
        out.append(tok)
        tok, cache = step(model, cache, tok, t)
    _sync(dev)
    gen_s = time.perf_counter() - t0
    generated = torch.stack(out, dim=1)
    tput = batch * gen / gen_s
    print(f"prefill {prefill_s * 1e3:.0f}ms, "
          f"decode {gen_s / gen * 1e3:.1f}ms/tok/batch, "
          f"throughput {tput:.1f} tok/s")
    print(f"sample generation ids: {generated[0][:16].cpu().numpy()}",
          flush=True)
    return {"model": model, "prompts": prompts, "generated": generated,
            "last_logits": logits, "prefill_s": prefill_s, "gen_s": gen_s,
            "tok_per_s": tput}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gemma-2b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
          seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
