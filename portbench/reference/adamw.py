"""AdamW (Loshchilov and Hutter, decoupled weight decay) with the
gradient clipped to a global norm and a learning rate that warms up
linearly and then follows a cosine to zero, on one flat float32 buffer
of all parameters.

The step's learning rate is the schedule's at the step number after the
update: lr_t = lr * min(t / warmup, 1) * (1 + cos(pi * progress)) / 2,
progress = clip((t - warmup) / (total - warmup), 0, 1).
"""
from __future__ import annotations

import math

import torch

__all__ = ["AdamW"]

_CHUNK = 1 << 26        # elements updated at a time: small temporaries


class AdamW:
    def __init__(self, n: int, device, opt: dict):
        self.opt = opt
        self.m = torch.zeros(n, dtype=torch.float32, device=device)
        self.v = torch.zeros(n, dtype=torch.float32, device=device)
        self.t = 0

    def lr(self, t: int) -> float:
        o = self.opt
        warm = min(t / max(o["warmup_steps"], 1), 1.0)
        span = max(o["total_steps"] - o["warmup_steps"], 1)
        progress = min(max((t - o["warmup_steps"]) / span, 0.0), 1.0)
        return o["lr"] * warm * 0.5 * (1.0 + math.cos(math.pi * progress))

    @torch.no_grad()
    def clip_scale(self, grad: torch.Tensor) -> float:
        """The factor that brings the gradient's global norm to at most
        `clip_norm` (float64 sum of squares)."""
        norm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                             for g in grad.split(_CHUNK)))
        return min(self.opt["clip_norm"] / (norm + 1e-9), 1.0)

    @torch.no_grad()
    def step(self, p: torch.Tensor, grad: torch.Tensor, scale: float) -> None:
        """One update of p in place, the gradient scaled by `scale`."""
        o = self.opt
        self.t += 1
        lr = self.lr(self.t)
        bc1 = 1.0 - o["b1"] ** self.t
        bc2 = 1.0 - o["b2"] ** self.t
        for pc, gc, mc, vc in zip(p.split(_CHUNK), grad.split(_CHUNK),
                                  self.m.split(_CHUNK), self.v.split(_CHUNK)):
            g = gc * scale
            mc.mul_(o["b1"]).add_(g, alpha=1.0 - o["b1"])
            vc.mul_(o["b2"]).addcmul_(g, g, value=1.0 - o["b2"])
            update = (mc / bc1) / ((vc / bc2).sqrt() + o["eps"])
            pc.sub_(lr * (update + o["weight_decay"] * pc))
