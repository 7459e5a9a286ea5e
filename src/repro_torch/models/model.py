"""The model: a stack of pattern-typed blocks (attn / local / global /
rec / rwkv; each attention block GQA or, for an MLA config, multi-head
latent attention, with an MLP or, for an MoE config, an MoE layer)
between an embedding and an unembedding, and for a config with
`mtp_depth` the multi-token-prediction head that `loss_fn` trains.

The port of `repro.models.model`.  The JAX package stacks
the layers of each repeat of `cfg.layer_pattern` along a leading axis and
scans over them; here the layers are one flat `nn.ModuleList` in layer
order (the stages, then the partial tail stage), each a `Params` module
with the JAX package's key names, so `convert.py` maps one onto the other.

API (the JAX package's, with a `Model` where it passes (cfg, params)):
  Model(cfg, device=, dtype=, generator=)      # random weights, seeded
  forward(model, batch, impl, remat) -> (logits, aux)
  loss_fn(model, batch, impl, remat) -> scalar
  init_cache(model, batch, max_len)
  prefill(model, batch, max_len, impl) -> (logits_last, cache)
  decode_step(model, cache, tokens, pos) -> (logits, cache)
  param_tree(model) -> the parameters as `init_params` shapes them

The weights are built frozen (serving runs under `inference_mode`); a
trainer turns them on with `model.requires_grad_(True)`.

Blocks and features outside this slice raise NotImplementedError naming
their ROADMAP.md item.  Sharding (`maybe_shard`) and the scan barrier
have no counterpart: the first goes with ROADMAP.md queue 1, item 10, and
the second only steers XLA.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.cuda import resolve_device
from .attention import GQA, MLA
from .layers import (Params, embed, init_embedding, init_mlp,
                     init_rms_norm, mlp, rms_norm, unembed)
from .moe import MoE
from .recurrent import RGLRUBlock
from .rwkv import RWKV6Block

__all__ = ["Model", "init_params", "layer_kinds", "forward", "loss_fn",
           "init_cache", "prefill", "decode_step", "param_tree"]


# ---------------------------------------------------------------------- #
# what this slice runs
# ---------------------------------------------------------------------- #
def _check_supported(cfg: ModelConfig) -> None:
    if cfg.n_encoder_layers:
        raise NotImplementedError(
            f"the encoder is not ported yet, so {cfg.name} does not run: "
            f"ROADMAP.md queue 1, item 4")


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """Block kind of every layer, in order: the stages, then the tail."""
    pattern = tuple(cfg.layer_pattern)
    n_stages = cfg.n_layers // len(pattern)
    tail = pattern[: cfg.n_layers % len(pattern)]
    return list(pattern) * n_stages + list(tail)


def _window_for(cfg: ModelConfig, kind: str) -> int | None:
    if kind == "local":
        return cfg.local_window
    if kind == "attn" and cfg.family == "hybrid":
        return cfg.local_window
    return None


def _attn_cls(cfg: ModelConfig):
    return MLA if cfg.use_mla else GQA


def _positions(cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """[B, S] token positions, or [3, B, S] for M-RoPE (the batch's
    `mrope_pos`, else the text positions on every stream)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    if cfg.mrope_sections is not None:
        positions = batch.get("mrope_pos", torch.stack([positions] * 3))
    return positions


# ---------------------------------------------------------------------- #
# block-level init / apply
# ---------------------------------------------------------------------- #
def _block_init(gen, cfg: ModelConfig, kind: str, dtype) -> dict:
    if kind == "rwkv":
        return {"ln": init_rms_norm(cfg.d_model, gen, dtype),
                "rwkv": RWKV6Block.init(gen, cfg, dtype)}
    p = {"ln1": init_rms_norm(cfg.d_model, gen, dtype),
         "ln2": init_rms_norm(cfg.d_model, gen, dtype)}
    if kind == "rec":
        p["rec"] = RGLRUBlock.init(gen, cfg, dtype)
    else:
        p["attn"] = _attn_cls(cfg).init(gen, cfg, dtype)
    if cfg.is_moe:
        p["moe"] = MoE.init(gen, cfg, dtype)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def _block_apply(p, cfg: ModelConfig, kind: str, h, positions,
                 impl: str = "auto"):
    """One block, full-sequence.  Returns (h, the MoE aux loss: a float32
    scalar, None without MoE)."""
    if kind == "rwkv":      # the block carries its own residuals
        return RWKV6Block.apply(p["rwkv"], cfg, rms_norm(p["ln"], h),
                                impl=impl), None
    if kind == "rec":
        h = h + RGLRUBlock.apply(p["rec"], cfg, rms_norm(p["ln1"], h),
                                 impl=impl)
    else:
        h = h + _attn_cls(cfg).apply(p["attn"], cfg, rms_norm(p["ln1"], h),
                                     positions,
                                     window=_window_for(cfg, kind),
                                     impl=impl)
    x = rms_norm(p["ln2"], h)
    if cfg.is_moe:
        return h + MoE.apply(p["moe"], cfg, x), MoE.aux_loss(p["moe"], cfg, x)
    return h + mlp(p["mlp"], x, cfg.hidden_act), None


def _block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 dtype, device) -> dict:
    if kind == "rwkv":
        return RWKV6Block.init_cache(cfg, batch, dtype, device=device)
    if kind == "rec":
        return RGLRUBlock.init_cache(cfg, batch, dtype, device=device)
    return _attn_cls(cfg).init_cache(cfg, batch, max_len,
                                     window=_window_for(cfg, kind),
                                     dtype=dtype, device=device)


def _block_decode(p, cfg: ModelConfig, kind: str, h, cache, pos: int):
    if kind == "rwkv":
        return RWKV6Block.apply_decode(p["rwkv"], cfg, rms_norm(p["ln"], h),
                                       cache, pos)
    if kind == "rec":
        y, cache = RGLRUBlock.apply_decode(p["rec"], cfg,
                                           rms_norm(p["ln1"], h), cache, pos)
    else:
        y, cache = _attn_cls(cfg).apply_decode(
            p["attn"], cfg, rms_norm(p["ln1"], h), cache, pos,
            window=_window_for(cfg, kind))
    h = h + y
    x = rms_norm(p["ln2"], h)
    if cfg.is_moe:        # each token its own group; no aux in decode
        return h + MoE.apply(p["moe"], cfg, x), cache
    return h + mlp(p["mlp"], x, cfg.hidden_act), cache


# ---------------------------------------------------------------------- #
# params and the module
# ---------------------------------------------------------------------- #
def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype=torch.float32) -> dict:
    """Random weights on the generator's device, with the distributions of
    the JAX package's `init_params`: {"embed", "final_ln", "layers"}, and
    with `cfg.mtp_depth` the MTP head's blocks ("mtp", a list of
    `mtp_depth` attention blocks) and its norm ("mtp_ln")."""
    _check_supported(cfg)
    params = {
        "embed": init_embedding(gen, cfg, dtype),
        "final_ln": init_rms_norm(cfg.d_model, gen, dtype),
        "layers": [_block_init(gen, cfg, kind, dtype)
                   for kind in layer_kinds(cfg)],
    }
    if cfg.mtp_depth:
        params["mtp"] = [_block_init(gen, cfg, "attn", dtype)
                         for _ in range(cfg.mtp_depth)]
        params["mtp_ln"] = init_rms_norm(cfg.d_model, gen, dtype)
    return params


class Model(nn.Module):
    """A model of `cfg` on one device.

    Random weights come from `generator` (a `torch.Generator` on
    `device`; one seeded with 0 when None).  `params`, a tree as
    `init_params` returns it, takes their place (see `convert.py`).
    `device` defaults to the card and raises without one.
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 dtype=torch.float32, generator: torch.Generator | None = None,
                 params: dict | None = None):
        super().__init__()
        dev = resolve_device(device)
        _check_supported(cfg)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            if generator.device.type != dev.type:
                raise ValueError(f"the generator is on {generator.device}, "
                                 f"the model on {dev}")
            params = init_params(cfg, generator, dtype)
        self.cfg = cfg
        self.kinds = layer_kinds(cfg)
        if len(params["layers"]) != len(self.kinds):
            raise ValueError(f"{len(params['layers'])} layers given, "
                             f"{cfg.name} has {len(self.kinds)}")
        self.embed = Params(params["embed"])
        self.final_ln = Params(params["final_ln"])
        self.layers = nn.ModuleList(Params(p) for p in params["layers"])
        # the MTP head, which only `loss_fn` reads (as in the JAX package,
        # a tree without it trains without its term)
        if "mtp" in params:
            self.mtp = nn.ModuleList(Params(p) for p in params["mtp"])
            self.mtp_ln = Params(params["mtp_ln"])
        else:
            self.mtp = self.mtp_ln = None

    @property
    def device(self) -> torch.device:
        return self.final_ln["scale"].device

    @property
    def dtype(self) -> torch.dtype:
        return self.final_ln["scale"].dtype

    def forward(self, batch: dict, impl: str = "auto", remat: bool = False):
        """batch: {"tokens": [B, S]}.  Returns (logits [B, S, V], aux),
        aux being the sum of the layers' MoE auxiliary losses (a float32
        scalar, 0 without MoE).
        With `remat`, each layer is checkpointed: the backward recomputes
        its internals instead of keeping them (the JAX package checkpoints
        each stage of its layer scan)."""
        cfg = self.cfg
        if "patch_embeds" in batch:
            raise NotImplementedError(
                "the vision frontend is not ported yet: ROADMAP.md queue 1, "
                "item 4")
        h = embed(self.embed, cfg, batch["tokens"].long())
        positions = _positions(cfg, batch)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for kind, p in zip(self.kinds, self.layers):
            if remat and torch.is_grad_enabled():
                h, a = checkpoint(_block_apply, p, cfg, kind, h, positions,
                                  impl, use_reentrant=False)
            else:
                h, a = _block_apply(p, cfg, kind, h, positions, impl=impl)
            if a is not None:
                aux = aux + a
        h = rms_norm(self.final_ln, h)
        logits = unembed(self.embed, cfg, h)
        return logits, aux


# ---------------------------------------------------------------------- #
# the functional API
# ---------------------------------------------------------------------- #
def forward(model: Model, batch: dict, impl: str = "auto",
            remat: bool = False):
    """(logits [B, S, V], aux) of a full-sequence pass."""
    return model(batch, impl=impl, remat=remat)


def loss_fn(model: Model, batch: dict, impl: str = "auto",
            aux_weight: float = 0.01, mtp_weight: float = 0.3,
            remat: bool = False) -> torch.Tensor:
    """Next-token cross entropy in float32, the mean over the batch's
    positions 1..S-1, plus `aux_weight` times the MoE auxiliary loss for
    an MoE config, plus, for a config with `mtp_depth` whose model holds
    the MTP head, `mtp_weight` times the head's cross entropy at t+2: the
    head's blocks run on the re-embedded inputs (their MoE aux unused, as
    in the JAX package), then its norm and the shared unembedding."""
    cfg = model.cfg
    tokens = batch["tokens"].long()
    logits, aux = forward(model, batch, impl=impl, remat=remat)
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(lp, -1, tokens[:, 1:, None])[..., 0]
    loss = nll.mean()
    if cfg.is_moe:
        loss = loss + aux_weight * aux
    if cfg.mtp_depth and model.mtp is not None:
        h = embed(model.embed, cfg, tokens)
        positions = _positions(cfg, batch)
        for p in model.mtp:
            h, _ = _block_apply(p, cfg, "attn", h, positions, impl=impl)
        logits2 = unembed(model.embed, cfg, rms_norm(model.mtp_ln, h))
        lp2 = torch.log_softmax(logits2[:, :-2].float(), dim=-1)
        nll2 = -torch.gather(lp2, -1, tokens[:, 2:, None])[..., 0]
        loss = loss + mtp_weight * nll2.mean()
    return loss


def param_tree(model: Model) -> dict:
    """The model's parameters (the tensors themselves) as `init_params`
    shapes them: {"embed", "final_ln", "layers": [...]}, and "mtp" and
    "mtp_ln" where the model holds the MTP head.  Gradients and optimizer
    moments are trees of the same shape."""
    tree = {"embed": model.embed.tree(), "final_ln": model.final_ln.tree(),
            "layers": [p.tree() for p in model.layers]}
    if model.mtp is not None:
        tree["mtp"] = [p.tree() for p in model.mtp]
        tree["mtp_ln"] = model.mtp_ln.tree()
    return tree


def init_cache(model: Model, batch: int, max_len: int) -> list[dict]:
    """One cache dict per layer, in layer order, on the model's device and
    in its dtype (the recurrent state is float32)."""
    return [_block_cache(model.cfg, kind, batch, max_len, model.dtype,
                         model.device) for kind in model.kinds]


def decode_step(model: Model, cache: list[dict], tokens: torch.Tensor,
                pos: int) -> tuple[torch.Tensor, list[dict]]:
    """tokens [B] (current token), pos an int.  Returns (logits [B, V],
    the cache with this position written)."""
    cfg = model.cfg
    h = embed(model.embed, cfg, tokens.long()[:, None])
    new_cache = []
    for kind, p, c in zip(model.kinds, model.layers, cache):
        h, c = _block_decode(p, cfg, kind, h, c, pos)
        new_cache.append(c)
    h = rms_norm(model.final_ln, h)
    return unembed(model.embed, cfg, h)[:, 0], new_cache


def prefill(model: Model, batch: dict, max_len: int,
            impl: str = "auto") -> tuple[torch.Tensor, list[dict]]:
    """Process the full prompt, returning (last-position logits, cache).

    As in the JAX package, the prompt's forward pass runs here and the
    returned cache starts empty; the serving loop replays the prompt
    through `decode_step` to fill it (see launch/serve.py)."""
    logits, _ = forward(model, batch, impl=impl)
    last = logits[:, -1].clone()    # frees the [B, S, V] logits
    del logits
    return last, init_cache(model, batch["tokens"].shape[0], max_len)
