"""The model: a stack of pattern-typed blocks (attn / local / global /
rec / rwkv; each attention block GQA or, for an MLA config, multi-head
latent attention, with an MLP or, for an MoE config, an MoE layer)
between an embedding and an unembedding; for an encoder-decoder config
(seamless) a bidirectional encoder over precomputed frame embeddings,
read by a cross attention in every decoder block; for a vision config
(qwen2-vl) precomputed patch embeddings in place of the first token
embeddings; and for a config with `mtp_depth` the multi-token-prediction
head that `loss_fn` trains.  The audio and vision frontends themselves
are stubs in the JAX package too: a batch carries their embeddings.

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
  decode_step(model, cache, tokens, pos, enc) -> (logits, cache)
  param_tree(model) -> the parameters as `init_params` shapes them

A batch is {"tokens": [B, S]} and, where the config has them,
"frame_embeds" [B, Se, d] (the encoder's input), "patch_embeds"
[B, N, d] and "mrope_pos" [3, B, S].

The weights are built frozen (serving runs under `inference_mode`); a
trainer turns them on with `model.requires_grad_(True)`.

Under a mesh (`launch.mesh.mesh_context`) the weights are DTensors
placed by `parallel.param_specs`, and `_forward` constrains each layer's
input and output to ("data", None, None) and the logits to ("data",
None, "model") with `parallel.maybe_shard`, at the JAX package's call
sites; outside a mesh those calls do nothing.  The scan barrier has no
counterpart: it only steers XLA.

The final norm and the unembedding of every full-sequence forward are the
program span `models.unembed` (`repro_torch.obs`; in `torch.profiler`'s
trace while it records).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import obs
from ..configs.base import ModelConfig
from ..core.cuda import resolve_device
from ..parallel.sharding import (axis_index, axis_size, local_region,
                                 max_over, maybe_shard, sum_over)
from .attention import GQA, MLA, CrossAttention
from .layers import (Params, embed, init_embedding, init_mlp,
                     init_rms_norm, mlp, rms_norm, unembed)
from .moe import MoE
from .recurrent import RGLRUBlock
from .rwkv import RWKV6Block

__all__ = ["Model", "Cache", "init_params", "layer_kinds", "forward",
           "loss_fn", "init_cache", "prefill", "decode_step", "param_tree"]


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
def _block_init(gen, cfg: ModelConfig, kind: str, dtype,
                cross: bool = False) -> dict:
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
    if cross:
        p["ln_x"] = init_rms_norm(cfg.d_model, gen, dtype)
        p["xattn"] = CrossAttention.init(gen, cfg, dtype)
    return p


def _block_apply(p, cfg: ModelConfig, kind: str, h, positions,
                 enc=None, impl: str = "auto"):
    """One block, full-sequence.  Returns (h, the MoE aux loss: a float32
    scalar, None without MoE).  A decoder block of an encoder-decoder
    config attends to `enc` after its self-attention; without `enc` it
    runs as a plain decoder block."""
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
    if "xattn" in p and enc is not None:
        h = h + CrossAttention.apply(p["xattn"], cfg, rms_norm(p["ln_x"], h),
                                     enc, impl=impl)
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


def _block_decode(p, cfg: ModelConfig, kind: str, h, cache, pos: int,
                  enc=None):
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
    if "xattn" in p and enc is not None:   # impl "auto", as in JAX
        h = h + CrossAttention.apply(p["xattn"], cfg,
                                     rms_norm(p["ln_x"], h), enc)
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
    the JAX package's `init_params`, drawn in its order: {"embed",
    "final_ln", "layers"} (each decoder block of an encoder-decoder
    config with its cross attention, "ln_x" and "xattn"), then for
    `cfg.n_encoder_layers` the encoder ("encoder": {"layers": [...],
    "final_ln"}, each layer an "attn" block without cross attention), then
    with `cfg.mtp_depth` the MTP head's blocks ("mtp", a list of
    `mtp_depth` attention blocks) and its norm ("mtp_ln")."""
    cross = cfg.n_encoder_layers > 0
    params = {
        "embed": init_embedding(gen, cfg, dtype),
        "final_ln": init_rms_norm(cfg.d_model, gen, dtype),
        "layers": [_block_init(gen, cfg, kind, dtype, cross=cross)
                   for kind in layer_kinds(cfg)],
    }
    if cfg.n_encoder_layers:
        params["encoder"] = {
            "layers": [_block_init(gen, cfg, "attn", dtype)
                       for _ in range(cfg.n_encoder_layers)],
            "final_ln": init_rms_norm(cfg.d_model, gen, dtype)}
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
        # the encoder, which `forward` and `prefill` run on a batch's
        # frame embeddings
        if cfg.n_encoder_layers:
            enc = params.get("encoder", {"layers": []})
            if len(enc["layers"]) != cfg.n_encoder_layers:
                raise ValueError(f"{len(enc['layers'])} encoder layers "
                                 f"given, {cfg.name} has "
                                 f"{cfg.n_encoder_layers}")
            self.encoder = nn.ModuleList(Params(p) for p in enc["layers"])
            self.encoder_ln = Params(enc["final_ln"])
        else:
            self.encoder = self.encoder_ln = None
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
        """batch: {"tokens": [B, S], optional frontend inputs}.  Returns
        (logits [B, S, V], aux), aux being the sum of the layers' MoE
        auxiliary losses (a float32 scalar, 0 without MoE).
        With `remat`, each layer is checkpointed: the backward recomputes
        its internals instead of keeping them (the JAX package checkpoints
        each stage of its layer scan)."""
        logits, aux, _ = _forward(self, batch, impl, remat)
        return logits, aux


def _encode(model: Model, frames: torch.Tensor,
            impl: str = "auto") -> torch.Tensor:
    """Run the (non-causal) encoder over precomputed frame embeddings
    [B, Se, d]: each layer's self-attention with RoPE at positions
    0..Se-1 and no mask, then its MLP; then the encoder's norm.  Its
    callers pass no `impl`, as in the JAX package, so on the card the
    encoder launches the flash-attention kernel even under a
    `forward(impl="ref")`."""
    cfg = model.cfg
    B, S, _ = frames.shape
    positions = torch.arange(S, device=frames.device)[None].expand(B, S)
    h = frames
    for blk in model.encoder:
        h = h + GQA.apply_bidirectional(blk["attn"], cfg,
                                        rms_norm(blk["ln1"], h), positions,
                                        impl=impl)
        h = h + mlp(blk["mlp"], rms_norm(blk["ln2"], h), cfg.hidden_act)
    return rms_norm(model.encoder_ln, h)


def _inputs_to_hidden(model: Model, batch: dict):
    """(the token embeddings [B, S, d], with a batch's `patch_embeds`
    [B, N, d] in place of the first N for a vision config; the encoder's
    output on a batch's `frame_embeds`, cast to the hidden dtype, for an
    encoder-decoder config, else None)."""
    cfg = model.cfg
    h = embed(model.embed, cfg, batch["tokens"].long())
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(h.dtype)
        h = torch.cat([pe, h[:, pe.shape[1]:]], dim=1)
    enc = None
    if cfg.n_encoder_layers and "frame_embeds" in batch:
        enc = _encode(model, batch["frame_embeds"].to(h.dtype))
    return h, enc


def _forward(model: Model, batch: dict, impl: str, remat: bool):
    """(logits, aux, the encoder's output or None): `Model.forward`, and
    the encoder's output that `prefill` puts on the cache."""
    cfg = model.cfg
    h, enc = _inputs_to_hidden(model, batch)
    positions = _positions(cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for kind, p in zip(model.kinds, model.layers):
        h = maybe_shard(h, "data", None, None)
        if remat and torch.is_grad_enabled():
            # `enc` goes in as an input, so the backward gives the
            # encoder every cross attention's gradient
            h, a = checkpoint(_block_apply, p, cfg, kind, h, positions, enc,
                              impl, use_reentrant=False)
        else:
            h, a = _block_apply(p, cfg, kind, h, positions, enc=enc,
                                impl=impl)
        h = maybe_shard(h, "data", None, None)
        if a is not None:
            aux = aux + a
    with obs.span("models.unembed"):
        h = rms_norm(model.final_ln, h)
        logits = maybe_shard(unembed(model.embed, cfg, h), "data", None,
                             "model")
    return logits, aux, enc


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
    loss = _nll(logits, tokens, 1).mean()
    if cfg.is_moe:
        loss = loss + aux_weight * aux
    if cfg.mtp_depth and model.mtp is not None:
        h, _ = _inputs_to_hidden(model, batch)
        positions = _positions(cfg, batch)
        for p in model.mtp:
            h, _ = _block_apply(p, cfg, "attn", h, positions, impl=impl)
        logits2 = unembed(model.embed, cfg, rms_norm(model.mtp_ln, h))
        loss = loss + mtp_weight * _nll(logits2, tokens, 2).mean()
    return loss


def _nll(logits: torch.Tensor, tokens: torch.Tensor,
         ahead: int) -> torch.Tensor:
    """[B, S - ahead] float32 negative log-likelihoods of the tokens
    `ahead` positions on under `logits` [B, S, V].  Under a mesh each
    rank takes its own rows (DTensor would allocate the slice's and the
    gather's gradients at the global batch); where the vocab is split
    over 'model', as the logits are placed, each rank keeps its own
    columns and the log-sum-exp and the token's logit are all-reduced
    over 'model' (vocab-parallel cross entropy: no rank holds the whole
    vocab's logits)."""
    n = axis_size("model")
    if n == 1 or logits.shape[-1] % n:
        def nll(logits, tokens):
            lp = torch.log_softmax(logits[:, :-ahead].float(), dim=-1)
            return -torch.gather(lp, -1, tokens[:, ahead:, None])[..., 0]
        return local_region(nll, (logits, tokens),
                            (("data", None, None), ("data", None)),
                            ("data", None))

    def nll_vocab_parallel(logits, tokens):
        x = logits[:, :-ahead].float()
        v = x.shape[-1]
        t = tokens[:, ahead:] - axis_index("model") * v
        inside = (t >= 0) & (t < v)
        m = max_over(x.amax(-1), "model")
        z = (x - m[..., None]).exp().sum(-1)
        own = torch.gather(x, -1, t.clamp(0, v - 1)[..., None])[..., 0]
        z, picked = sum_over(torch.stack([z, torch.where(inside, own, 0.0)]),
                             "model")
        return m + z.log() - picked
    return local_region(nll_vocab_parallel, (logits, tokens),
                        (("data", None, "model"), ("data", None)),
                        ("data", None))


def param_tree(model: Model) -> dict:
    """The model's parameters (the tensors themselves) as `init_params`
    shapes them: {"embed", "final_ln", "layers": [...]}, "encoder" where
    the model holds one, and "mtp" and "mtp_ln" where it holds the MTP
    head.  Gradients and optimizer moments are trees of the same shape."""
    tree = {"embed": model.embed.tree(), "final_ln": model.final_ln.tree(),
            "layers": [p.tree() for p in model.layers]}
    if model.encoder is not None:
        tree["encoder"] = {"layers": [p.tree() for p in model.encoder],
                           "final_ln": model.encoder_ln.tree()}
    if model.mtp is not None:
        tree["mtp"] = [p.tree() for p in model.mtp]
        tree["mtp_ln"] = model.mtp_ln.tree()
    return tree


class Cache(list):
    """The decode cache: one dict per layer, in layer order (a list, as
    every caller indexes it), and as `enc` the encoder's output
    [B, Se, d] that the cross attentions read (None: none is read).  The
    JAX package keeps it as `cache["enc"]`."""

    enc: torch.Tensor | None = None


def init_cache(model: Model, batch: int, max_len: int) -> Cache:
    """One cache dict per layer, in layer order, on the model's device and
    in its dtype (the recurrent state is float32); no encoder output."""
    return Cache(_block_cache(model.cfg, kind, batch, max_len, model.dtype,
                              model.device) for kind in model.kinds)


def decode_step(model: Model, cache: list[dict], tokens: torch.Tensor,
                pos: int, enc: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, Cache]:
    """tokens [B] (current token), pos an int.  Returns (logits [B, V],
    the cache with this position written).  For an encoder-decoder
    config the cross attentions read `enc`, by default the cache's."""
    cfg = model.cfg
    new_cache = Cache()
    new_cache.enc = getattr(cache, "enc", None)
    if enc is None:
        enc = new_cache.enc
    h = embed(model.embed, cfg, tokens.long()[:, None])
    for kind, p, c in zip(model.kinds, model.layers, cache):
        h, c = _block_decode(p, cfg, kind, h, c, pos, enc=enc)
        new_cache.append(c)
    h = rms_norm(model.final_ln, h)
    return unembed(model.embed, cfg, h)[:, 0], new_cache


def prefill(model: Model, batch: dict, max_len: int,
            impl: str = "auto") -> tuple[torch.Tensor, Cache]:
    """Process the full prompt, returning (last-position logits, cache).

    As in the JAX package, the prompt's forward pass runs here and the
    returned cache starts empty; the serving loop replays the prompt
    through `decode_step` to fill it (see launch/serve.py).  For an
    encoder-decoder batch with `frame_embeds` the cache's `enc` is the
    encoder's output: the forward pass's own (the JAX package encodes the
    frames a second time, the same function of the same inputs)."""
    logits, _, enc = _forward(model, batch, impl, remat=False)
    last = logits[:, -1].clone()    # frees the [B, S, V] logits
    del logits
    cache = init_cache(model, batch["tokens"].shape[0], max_len)
    cache.enc = enc
    return last, cache
