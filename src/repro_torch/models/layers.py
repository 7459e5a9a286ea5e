"""Shared model primitives: norms, rotary embeddings, MLPs, embeddings.

The port of `repro.models.layers`.  Parameters are nested dicts of
tensors with the JAX package's names and layouts (a dense weight `w` is
[d_in, d_out] and applies as `x @ w`), held inside the model as a
`Params` module, so that a weight carried across from the JAX package
needs no transpose.  Every `init_*` takes an explicit `torch.Generator`
on the device it builds on, and draws from the distributions of the JAX
initialisers (not their numbers: the two generators differ).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..parallel import sharding

__all__ = ["Params", "rms_norm", "init_rms_norm", "rope", "mrope",
           "init_dense", "dense", "init_mlp", "mlp", "init_embedding",
           "embed", "unembed", "act_fn"]


class Params(nn.Module):
    """A nested dict of tensors as a module: dict keys become submodules,
    tensor leaves become parameters (frozen: `requires_grad_(True)` on
    the model turns them on for training), and `p[key]` reads either and
    `key in p` tests for either, as the JAX package's dict params are
    read.  Under a mesh `p[key]` gives a DTensor weight gathered over the
    data axes (`parallel.sharding.gather_data`: FSDP's gather before a
    use); `tree()` gives the parameters themselves."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, Params(value))
            else:
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, key: str):
        value = getattr(self, key)
        if sharding._mesh is not None and isinstance(value, nn.Parameter):
            return sharding.gather_data(value)
        return value

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def tree(self) -> dict:
        """The nested dict of tensors back (the parameters themselves)."""
        out = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


def _normal(shape, gen: torch.Generator, dtype, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype).mul_(std)   # in place: no second copy


def init_rms_norm(d: int, gen: torch.Generator,
                  dtype=torch.float32) -> dict:
    return {"scale": torch.zeros((d,), dtype=dtype, device=gen.device)}


def rms_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + p["scale"].float())).to(x.dtype)


# ---------------------------------------------------------------------- #
# rotary embeddings
# ---------------------------------------------------------------------- #
def _freqs(dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def _rotate(x: torch.Tensor, sin: torch.Tensor,
            cos: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """x [B, S, H, D], positions [B, S] (absolute)."""
    ang = positions.float()[..., None] * _freqs(x.shape[-1], theta, x.device)
    return _rotate(x, torch.sin(ang)[:, :, None, :],
                   torch.cos(ang)[:, :, None, :])


def mrope(x: torch.Tensor, positions: torch.Tensor, sections: tuple,
          theta: float = 1_000_000.0) -> torch.Tensor:
    """Qwen2-VL multimodal rotary: positions [3, B, S] (t/h/w streams),
    `sections` gives the per-stream split of the half-dim frequency bands
    (e.g. (16, 24, 24) for head_dim 128)."""
    D = x.shape[-1]
    assert sum(sections) == D // 2, (sections, D)
    freqs = _freqs(D, theta, x.device)
    sins, coss = [], []
    for i, sec in enumerate(sections):
        lo = sum(sections[:i])
        ang = positions[i].float()[..., None] * freqs[lo:lo + sec]
        sins.append(torch.sin(ang))
        coss.append(torch.cos(ang))
    return _rotate(x, torch.cat(sins, -1)[:, :, None, :],
                   torch.cat(coss, -1)[:, :, None, :])


# ---------------------------------------------------------------------- #
# dense / MLP
# ---------------------------------------------------------------------- #
def init_dense(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> dict:
    return {"w": _normal((d_in, d_out), gen, dtype,
                         (2.0 / (d_in + d_out)) ** 0.5)}


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """x @ w.  Under a mesh the product is `parallel.sharding.settle`d
    (partial sums all-reduced) and the gradients of x and of the product
    take their values' placements, so the backward never meets a layout
    the forward did not choose."""
    return sharding.settle(sharding.grad_like(x) @ p["w"].to(x.dtype))


def act_fn(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu(approximate=True)
    if name == "relu":
        return F.relu(x)
    raise ValueError(name)


def init_mlp(gen: torch.Generator, d: int, d_ff: int,
             dtype=torch.float32) -> dict:
    return {
        "w_in": init_dense(gen, d, d_ff, dtype),
        "w_gate": init_dense(gen, d, d_ff, dtype),
        "w_out": init_dense(gen, d_ff, d, dtype),
    }


def mlp(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated MLP (SwiGLU / GeGLU by `act`)."""
    return dense(p["w_out"], act_fn(act, dense(p["w_gate"], x))
                 * dense(p["w_in"], x))


# ---------------------------------------------------------------------- #
# embeddings
# ---------------------------------------------------------------------- #
def init_embedding(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32) -> dict:
    p = {"table": _normal((cfg.vocab_size, cfg.d_model), gen, dtype, 0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = _normal((cfg.d_model, cfg.vocab_size), gen, dtype,
                               0.02)
    return p


def embed(p, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    # under a mesh each rank looks its own tokens up (a lookup's gradient
    # is an index_put, which DTensor does not shard): in the whole table,
    # or, where the table's vocab is split over 'model', in its own rows,
    # the rows it lacks zero, all-reduced over 'model'
    table = p["table"]
    batch = ("data",) + (None,) * (tokens.dim() - 1)
    if not sharding.sharded_over(table, "model", 0):
        h = sharding.local_region(lambda table, ids: table[ids],
                                  (table, tokens), ((None, None), batch),
                                  batch + (None,))
    else:
        def lookup(table, ids):
            t = ids - sharding.axis_index("model") * table.shape[0]
            inside = (t >= 0) & (t < table.shape[0])
            own = table[t.clamp(0, table.shape[0] - 1)]
            return sharding.sum_over(
                torch.where(inside[..., None], own, 0.0), "model")
        h = sharding.local_region(lookup, (table, tokens),
                                  (("model", None), batch), batch + (None,))
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
    return h


def unembed(p, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = sharding.grad_like(h)       # placed as `dense` places its product
    if cfg.tie_embeddings:
        logits = sharding.settle(h @ p["table"].to(h.dtype).T)
    else:
        logits = sharding.settle(h @ p["unembed"].to(h.dtype))
    if cfg.final_softcap is not None:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits
