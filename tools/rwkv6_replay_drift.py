"""How far rwkv6-7b's prefill and prompt replay drift from float64, layer
by layer, on one NVIDIA GPU.

    python3 tools/rwkv6_replay_drift.py

Builds rwkv6-7b at full width and depth from a generator seeded with 0
(as the serving launcher does), draws 4 prompts of 32 tokens as the
launcher does, and runs them through the port twice: as one forward pass
(prefill order, the WKV kernel at S=32) and as 32 decode steps (replay
order, the kernel at S=1 with the cached state), keeping every layer's
output. It then evaluates the same weights in float64 in both orders,
with its own straightforward float64 evaluation of the block (weights
upcast where they are used, a float64 WKV scan), and prints for every
fourth layer and the last: the float32 paths' difference, each one's
distance from the float64 prefill, and the float64 paths' difference;
then the same for the last-position logits.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

from repro_torch import models  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import _block_apply, _block_decode  # noqa: E402

B, P = 4, 32


def port_paths(model, tokens):
    """Per-layer outputs [L, B, P, d] of the prefill and the replay order,
    and their last-position logits, through the port (float32)."""
    cfg = model.cfg
    positions = torch.arange(P, device=tokens.device)[None].expand(B, P)
    h = layers.embed(model.embed, cfg, tokens.long())
    fwd = []
    for kind, p in zip(model.kinds, model.layers):
        h = _block_apply(p, cfg, kind, h, positions)
        fwd.append(h)
    logits_fwd = layers.unembed(model.embed, cfg,
                                layers.rms_norm(model.final_ln, h[:, -1:]))
    cache = models.init_cache(model, B, P)
    dec = [[] for _ in model.kinds]
    for t in range(P):
        h = layers.embed(model.embed, cfg, tokens[:, t:t + 1].long())
        for i, (kind, p) in enumerate(zip(model.kinds, model.layers)):
            h, cache[i] = _block_decode(p, cfg, kind, h, cache[i], t)
            dec[i].append(h)
    logits_dec = layers.unembed(model.embed, cfg,
                                layers.rms_norm(model.final_ln, h))
    return (torch.stack(fwd), torch.stack([torch.cat(d, 1) for d in dec]),
            logits_fwd[:, 0], logits_dec[:, 0])


def f64_block(layer, cfg, h, carry):
    """One RWKV6 block in float64 over h [B, S, d], continuing from
    `carry` (state, last time-mix input, last channel-mix input): the
    block's equations written out, apart from the code under test.
    `chip_smoke.py` holds the served rwkv6-7b to it."""
    H, hd = cfg.n_heads, cfg.head_dim
    q = layer["rwkv"]

    def f(t):
        return t.double()

    def norm(p, x):
        return (x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6)
                * (1.0 + f(p["scale"])))

    def lin(name, x):
        return x @ f(q[name]["w"])

    def shift(x, last):
        return torch.cat([last[:, None], x[:, :-1]], dim=1)

    state, last_tm, last_cm = carry
    Bn, S, d = h.shape
    x = norm(layer["ln"], h)
    xs = shift(x, last_tm)

    def mix(name):
        return x * f(q[name]) + xs * (1.0 - f(q[name]))

    r, k, v = (lin(n, mix(m)).reshape(Bn, S, H, hd)
               for n, m in (("wr", "mix_r"), ("wk", "mix_k"), ("wv", "mix_v")))
    g = F.silu(lin("wg", mix("mix_g")))
    wd = lin("w_lora_b", torch.tanh(lin("w_lora_a", mix("mix_w"))))
    w = torch.exp(-torch.exp(f(q["w_base"]) + wd)).reshape(Bn, S, H, hd)
    u = f(q["u"]).reshape(1, H, hd, 1)
    outs = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], state + u * kv))
        state = w[:, t, :, :, None] * state + kv
    o = norm(q["ln_x"], torch.stack(outs, dim=1).reshape(Bn, S, d))
    y = x + lin("wo", o * g)
    ys = shift(y, last_cm)
    mk, mr = f(q["cmix_k"]), f(q["cmix_r"])
    kk = torch.relu(lin("ck", y * mk + ys * (1.0 - mk))) ** 2
    out = y + torch.sigmoid(lin("cr", y * mr + ys * (1.0 - mr))) \
        * lin("cv", kk)
    return out, (state, x[:, -1], y[:, -1])


def zero_carry(cfg, batch: int, device) -> tuple:
    """The float64 carry of a block before its first step."""
    H, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    return (torch.zeros((batch, H, hd, hd), dtype=torch.float64,
                        device=device),
            torch.zeros((batch, d), dtype=torch.float64, device=device),
            torch.zeros((batch, d), dtype=torch.float64, device=device))


def f64_logits(model, h_last: torch.Tensor) -> torch.Tensor:
    """Logits of the float64 hidden states h_last [B, d]."""
    x = h_last * torch.rsqrt((h_last * h_last).mean(-1, keepdim=True)
                             + 1e-6)
    x = x * (1.0 + model.final_ln["scale"].double())
    return x @ model.embed["unembed"].double()


def f64_paths(model, tokens):
    """The same as `port_paths`, in float64 from the model's weights."""
    cfg = model.cfg
    h = model.embed["table"][tokens.long()].double()
    fwd, dec = [], []
    hd_seq = h
    for layer in model.layers:
        h, _ = f64_block(layer, cfg, h, zero_carry(cfg, B, h.device))
        fwd.append(h)
        carry, steps = zero_carry(cfg, B, h.device), []
        for t in range(P):       # this layer in replay order
            out, carry = f64_block(layer, cfg, hd_seq[:, t:t + 1], carry)
            steps.append(out)
        hd_seq = torch.cat(steps, 1)
        dec.append(hd_seq)
    return (torch.stack(fwd), torch.stack(dec), f64_logits(model, h[:, -1]),
            f64_logits(model, hd_seq[:, -1]))


@torch.inference_mode()
def main() -> int:
    if not torch.cuda.is_available():
        print("rwkv6_replay_drift: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    cfg = get_config("rwkv6-7b")
    model = models.Model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, P)), dtype=torch.int32).cuda()
    f32_fwd, f32_dec, lg_fwd, lg_dec = (t.double() for t in
                                        port_paths(model, tokens))
    f64_fwd, f64_dec, lg64_fwd, lg64_dec = f64_paths(model, tokens)

    def gap(a, b):
        return float((a - b).abs().max())

    for i in sorted(set(range(0, cfg.n_layers, 4)) | {cfg.n_layers - 1}):
        print(f"layer {i}: float32 prefill vs replay "
              f"{gap(f32_fwd[i], f32_dec[i])!r}; from float64: prefill "
              f"{gap(f32_fwd[i], f64_fwd[i])!r}, replay "
              f"{gap(f32_dec[i], f64_fwd[i])!r}; float64 prefill vs "
              f"replay {gap(f64_fwd[i], f64_dec[i])!r}; |h| max "
              f"{float(f64_fwd[i].abs().max())!r}", flush=True)
    print(f"logits: float32 prefill vs replay {gap(lg_fwd, lg_dec)!r}; "
          f"from float64: prefill {gap(lg_fwd, lg64_fwd)!r}, replay "
          f"{gap(lg_dec, lg64_fwd)!r}; float64 prefill vs replay "
          f"{gap(lg64_fwd, lg64_dec)!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
