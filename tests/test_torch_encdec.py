"""The port's encoder-decoder path (seamless-m4t-large-v2) against the JAX
package.

Reduced seamless (2 encoder and 2 decoder layers, d 64, 4 heads of 16 on
4 kv heads, every decoder block with a cross attention) is built by the
JAX package, its weights carried across as numpy arrays with
`repro_torch.models.convert`, and the same numpy-seeded tokens and frame
embeddings go through both.  The JAX side runs `impl="pallas"` (its
flash attention in interpret mode) and `impl="ref"`; the port runs
`cuda` (its kernel wrapper, which runs the plain version on a CPU
tensor), its default dispatch and `ref`.

Tolerances: `CrossAttention.apply`, `apply_bidirectional` and the
encoder 1e-5; `forward` logits, the prefill cache's encoder output and
ten `decode_step`s 1e-4 (the JAX package's own decode-vs-forward bound);
`loss_fn` and its gradients as tests/test_torch_train.py holds the
others (the loss 1e-4·max(1, |loss|), every leaf 1e-4·max(1, max|g|),
remat against no remat 1e-6); the flash-attention kernel against its
plain version 2e-5 in float32 and 2e-2 in bfloat16.  The tests marked
`cuda` run on the card.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import models  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.attention import GQA, CrossAttention  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402

ARCH = "seamless-m4t-large-v2"
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# `init_params`' count at full width (ModelConfig.param_count() leaves
# out the 122 norms: 2,034,659,328)
FULL_PARAMS = 2_034_784_256
PORT_IMPL = {"pallas": "cuda", "ref": "ref"}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's model stack.  Imported here, not at the top, so
    the tests marked `cuda` also run where JAX is not installed."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import models as jmodels
    from repro.configs import ARCHS, reduced_config as jreduced
    from repro.launch import steps as jsteps
    from repro.models import attention as jattention
    from repro.models import model as jmodel
    return types.SimpleNamespace(jax=jax, jnp=jnp, models=jmodels,
                                 model=jmodel, ARCHS=ARCHS,
                                 reduced=jreduced, attention=jattention,
                                 steps=jsteps)


@pytest.fixture(scope="module")
def setup(jx):
    """(JAX cfg, JAX params, port model) of reduced seamless."""
    jcfg = jx.reduced(jx.ARCHS[ARCH])
    cfg = reduced_config(get_config(ARCH))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_encoder_layers == 2 and cfg.n_layers == 2
    params = jx.models.init_params(jcfg, jx.jax.random.PRNGKey(0))
    model = models.from_jax_params(
        cfg, jx.jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, model


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _batch(cfg, B=2, S=12, Se=8, seed=0) -> dict:
    """Tokens and frame embeddings as numpy arrays."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "frame_embeds": rng.standard_normal((B, Se, cfg.d_model)).astype(
                np.float32)}


def _jax(jx, batch):
    return {k: jx.jnp.asarray(v) for k, v in batch.items()}


def _torch(batch, device="cpu"):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _err(got, want) -> float:
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    return float(np.abs(got - np.asarray(want)).max())


def _scaled_err(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(
        1.0, float(np.abs(want).max()))


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _block_params(jx, p):
    return jx.jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)


# ---------------------------------------------------------------------- #
# the blocks
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["pallas", "ref"])
@pytest.mark.parametrize("S,Se", [(24, 8), (10, 77)])
def test_cross_attention_matches_jax(S, Se, impl, setup, jx):
    """q from the decoder's rows, k and v from the encoder's, no mask:
    Se shorter and longer than S."""
    jcfg, _, model = setup
    p = jx.attention.CrossAttention.init(jx.jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(S + Se)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, Se, jcfg.d_model)).astype(np.float32)
    want = jx.attention.CrossAttention.apply(
        p, jcfg, jx.jnp.asarray(x), jx.jnp.asarray(enc), impl=impl)
    got = CrossAttention.apply(_block_params(jx, p), model.cfg,
                               torch.from_numpy(x), torch.from_numpy(enc),
                               impl=PORT_IMPL[impl])
    assert got.shape == want.shape == (2, S, jcfg.d_model)
    assert _err(got, want) < 1e-5


@pytest.mark.parametrize("impl", ["pallas", "ref"])
def test_bidirectional_attention_matches_jax(impl, setup, jx):
    """The encoder's self-attention: RoPE, no causal mask."""
    jcfg, _, model = setup
    p = jx.attention.GQA.init(jx.jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 19, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(19), (2, 1))
    want = jx.attention.GQA.apply_bidirectional(
        p, jcfg, jx.jnp.asarray(x), jx.jnp.asarray(pos), impl=impl)
    got = GQA.apply_bidirectional(_block_params(jx, p), model.cfg,
                                  torch.from_numpy(x), torch.as_tensor(pos),
                                  impl=PORT_IMPL[impl])
    assert _err(got, want) < 1e-5
    causal = GQA.apply(_block_params(jx, p), model.cfg, torch.from_numpy(x),
                       torch.as_tensor(pos), impl=PORT_IMPL[impl])
    assert float((causal - got).abs().max()) > 1e-3


def test_encoder_matches_jax(setup, jx):
    jcfg, params, model = setup
    frames = _batch(jcfg, Se=21)["frame_embeds"]
    want = jx.model._encode(jcfg, params, jx.jnp.asarray(frames))
    got = model_mod._encode(model, torch.from_numpy(frames))
    assert got.shape == (2, 21, jcfg.d_model)
    assert _err(got, want) < 1e-5


# ---------------------------------------------------------------------- #
# the model, the cache and the conversion
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["pallas", "ref"])
def test_forward_with_frames_matches_jax(impl, setup, jx):
    jcfg, params, model = setup
    batch = _batch(jcfg)
    want, _ = jx.models.forward(jcfg, params, _jax(jx, batch), impl=impl)
    before = fa.launches
    got, aux = models.forward(model, _torch(batch), impl=PORT_IMPL[impl])
    assert fa.launches == before      # CPU: plain versions
    assert float(aux) == 0.0
    assert _err(got, want) < 1e-4


def test_forward_without_frames_is_the_decoder_alone(setup, jx):
    """Without frames the cross attentions do not run, on both sides."""
    jcfg, params, model = setup
    batch = _batch(jcfg)
    del batch["frame_embeds"]
    want, _ = jx.models.forward(jcfg, params, _jax(jx, batch),
                                impl="pallas")
    got, _ = models.forward(model, _torch(batch))
    assert _err(got, want) < 1e-4
    with_frames, _ = models.forward(model, _torch(_batch(jcfg)))
    assert float((with_frames - got).abs().max()) > 1e-3


def test_prefill_puts_the_encoder_output_on_the_cache(setup, jx):
    jcfg, params, model = setup
    batch = _batch(jcfg, Se=30)
    jlast, jcache = jx.models.prefill(jcfg, params, _jax(jx, batch),
                                      max_len=16)
    last, cache = models.prefill(model, _torch(batch), max_len=16)
    assert isinstance(cache, models.Cache) and isinstance(cache, list)
    assert len(cache) == model.cfg.n_layers
    assert cache.enc.shape == (2, 30, jcfg.d_model)
    assert _err(cache.enc, jcache["enc"]) < 1e-4
    assert _err(last, jlast) < 1e-4
    # a batch without frames leaves it empty, as every other model's
    _, bare = models.prefill(model, {"tokens": torch.as_tensor(
        batch["tokens"])}, max_len=16)
    assert bare.enc is None and models.init_cache(model, 2, 16).enc is None


@pytest.mark.parametrize("enc_from", ["cache", "argument"])
def test_decode_steps_match_jax(enc_from, setup, jx):
    """Ten `decode_step`s reading the encoder's output (from the cache
    `prefill` returns, or passed as `enc`) against the JAX package's
    `decode_step(enc=)` and against the port's own forward."""
    jax, jnp = jx.jax, jx.jnp
    jcfg, params, model = setup
    B, S = 2, 10
    batch = _batch(jcfg, B=B, S=S, Se=13, seed=1)
    _, cache = models.prefill(model, _torch(batch), max_len=S)
    enc = cache.enc
    if enc_from == "argument":
        cache = models.init_cache(model, B, max_len=S)
    jenc = jx.model._encode(jcfg, params, jnp.asarray(batch["frame_embeds"]))
    jstep = jax.jit(lambda c, t, p: jx.models.decode_step(
        jcfg, params, c, t, p, enc=jenc))
    jcache = jx.models.init_cache(jcfg, B, max_len=S)
    ref, _ = models.forward(model, _torch(batch))
    to_jax, to_forward = [], []
    for t in range(S):
        jlog, jcache = jstep(jcache, jnp.asarray(batch["tokens"][:, t]),
                             jnp.int32(t))
        logits, cache = models.decode_step(
            model, cache, torch.as_tensor(batch["tokens"][:, t]), t,
            enc=None if enc_from == "cache" else enc)
        to_jax.append(_err(logits, jlog))
        to_forward.append(float((logits - ref[:, t]).abs().max()))
    assert max(to_jax) < 1e-4, to_jax
    assert max(to_forward) < 1e-4, to_forward
    assert (cache.enc is enc) == (enc_from == "cache")


@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_and_its_gradients_match_jax(remat, setup, jx):
    """`loss_fn` on a batch with frames and every gradient leaf, the
    encoder's and the cross attentions' included."""
    jax = jx.jax
    jcfg, params, model = setup
    model = models.Model(model.cfg, device="cpu",
                         params=models.param_tree(model)).requires_grad_(True)
    batch = _batch(jcfg, seed=4)
    jloss, jgrads = jax.value_and_grad(lambda p: jx.models.loss_fn(
        jcfg, p, _jax(jx, batch), remat=remat))(params)
    loss = models.loss_fn(model, _torch(batch), remat=remat)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-4 * max(
        1.0, abs(float(jloss)))
    tree = models.param_tree(model)
    grads = torch.autograd.grad(loss, tree_leaves(tree))
    it = iter(grads)
    got = _flat(models.to_jax_tree(model.cfg, tree_map(lambda p: next(it),
                                                       tree)))
    want = _flat(jax.tree.map(np.asarray, jgrads))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert _scaled_err(got[key], want[key]) < 1e-4, key
    for key in ("/encoder/stages/b0_attn/attn/wq/w",
                "/stages/b0_attn/xattn/wk/w"):
        assert float(np.abs(got[key]).max()) > 0, key
    if remat:
        plain = models.loss_fn(model, _torch(batch))
        assert abs(float(plain.detach()) - float(loss.detach())) <= 1e-6
        for a, b in zip(torch.autograd.grad(plain, tree_leaves(tree)),
                        grads):
            assert float((a - b).abs().max()) <= 1e-6


def test_conversion_round_trips_the_encoder(setup, jx):
    jax = jx.jax
    _, params, model = setup
    back = models.to_jax_params(model)
    want = jax.tree.map(np.asarray, params)
    assert set(back["encoder"]) == {"stages", "final_ln"}
    assert set(back["stages"]["b0_attn"]) >= {"ln_x", "xattn"}
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # any tree shaped like the params (gradients, moments) carries alike
    tree = models.from_jax_tree(model.cfg, want, device="cpu")
    assert len(tree["encoder"]["layers"]) == 2
    again = models.to_jax_tree(model.cfg, tree)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(want)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="'vision'.*no block"):
        models.from_jax_tree(model.cfg, {**want, "vision": {}},
                             device="cpu")
    bare = models.param_tree(model)
    del bare["encoder"]
    with pytest.raises(ValueError, match="0 encoder layers"):
        models.Model(model.cfg, device="cpu", params=bare)


def test_initialiser_builds_the_jax_shapes(setup, jx):
    """`init_params` builds the JAX tree's shapes, the encoder and the
    cross attentions included, and a seed fixes the weights."""
    jax = jx.jax
    jcfg, _, model = setup
    seeded = models.Model(model.cfg, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    got = models.to_jax_params(seeded)
    want = jax.eval_shape(lambda: jx.models.init_params(
        jcfg, jax.random.PRNGKey(0)))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    again = models.Model(model.cfg, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    for a, b in zip(seeded.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_full_width_config_builds(jx):
    """`Model` takes seamless-m4t-large-v2's published config whole (24
    encoder and 24 decoder layers), with the JAX package's parameter
    count; built as fake tensors, which hold shapes and no storage."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    jax = jx.jax
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        jax.eval_shape(lambda: jx.models.init_params(
            jx.ARCHS[ARCH], jax.random.PRNGKey(0)))))
    with FakeTensorMode():
        model = models.Model(get_config(ARCH), device="cpu",
                             generator=torch.Generator().manual_seed(0))
        n = sum(p.numel() for p in model.parameters())
    assert n == want == FULL_PARAMS
    assert len(model.encoder) == len(model.layers) == 24


def test_launcher_matches_the_jax_launcher(setup, jx, monkeypatch):
    """`serve` on reduced seamless, decoder-only as the JAX launcher runs
    it (no frames), with the JAX weights: the same generated ids as the
    JAX launcher's decode loop, and the replay's logits within 1e-4 of
    the JAX package's and of the port's prefill."""
    jax, jnp = jx.jax, jx.jnp
    jcfg, params, model = setup
    B, P, G, seed = 2, 6, 5, 0
    monkeypatch.setattr(serve_mod.models, "Model",
                        lambda cfg, **kw: model)
    out = serve_mod.serve(model.cfg, batch=B, prompt_len=P, gen=G,
                          seed=seed, device="cpu")
    # the JAX launcher's loop (repro/launch/serve.py::main)
    rng = np.random.default_rng(seed)
    prompts = jnp.asarray(rng.integers(0, jcfg.vocab_size, (B, P)),
                          jnp.int32)
    assert np.array_equal(out["prompts"].numpy(), np.asarray(prompts))
    step = jax.jit(jx.steps.make_serve_step(jcfg))
    cache = jx.models.init_cache(jcfg, B, P + G)
    for t in range(P):
        nxt, cache = step(params, cache, prompts[:, t], jnp.int32(t))
    jlogits, _ = jx.models.decode_step(jcfg, params, cache,
                                       prompts[:, P - 1], jnp.int32(P - 1))
    gen, tok = [], nxt
    for t in range(P, P + G):
        gen.append(tok)
        tok, cache = step(params, cache, tok, jnp.int32(t))
    assert np.array_equal(out["generated"].numpy(),
                          np.asarray(jnp.stack(gen, axis=1)))
    assert _err(out["last_logits"], jlogits) < 1e-4
    last = make_prefill_step(model.cfg)(model, {"tokens": out["prompts"]})
    assert float((out["last_logits"] - last).abs().max()) < 1e-4


# ---------------------------------------------------------------------- #
# on the card
# ---------------------------------------------------------------------- #
# (B, Sq, Sk, Hq, Hkv): chip_smoke.py's phase-5 non-causal cases, then
# reduced seamless's cross attention in decode
XATTN_CASES = [(1, 24, 8, 4, 4), (1, 24, 8, 4, 2), (1, 1, 1, 4, 4),
               (2, 1, 1, 4, 2), (1, 100, 77, 4, 4), (1, 100, 77, 4, 2),
               (1, 77, 300, 4, 4), (1, 77, 300, 4, 2), (4, 1, 1000, 16, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("case", XATTN_CASES)
def test_kernel_without_a_mask_at_sq_apart_from_sk(case, D, dt, cuda_device):
    B, Sq, Sk, Hq, Hkv = case
    rng = np.random.default_rng(Sq * 1000 + Sk)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda_device, getattr(torch, dt))
        for shape in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=False)
    assert got.shape == (B, Sq, Hq, D) and got.dtype == q.dtype
    err = float((got.float() - want.float()).abs().max())
    assert err < TOL[dt], (case, D, dt, err)


@pytest.mark.cuda
def test_model_on_the_card_launches_the_kernel_everywhere(cuda_device):
    """Reduced seamless on the card: a forward with frames launches the
    kernel once an encoder layer, a self-attention and a cross attention
    (the encoder also under impl="ref"); without frames once a layer; a
    decode step reading `enc` once a layer (the cross attention at
    Sq = 1); each within 1e-4 of the plain versions on the host."""
    cfg = reduced_config(get_config(ARCH))
    host = models.Model(cfg, device="cpu")
    gpu = models.from_jax_params(cfg, models.to_jax_params(host))
    batch = _batch(cfg, S=40, Se=70, seed=2)
    L, E = cfg.n_layers, cfg.n_encoder_layers
    fa.launches = 0
    got, _ = models.forward(gpu, _torch(batch, cuda_device))
    torch.cuda.synchronize()
    assert fa.launches == E + 2 * L
    want, _ = models.forward(host, _torch(batch), impl="ref")
    assert float((got.cpu() - want).abs().max()) < 1e-4
    fa.launches = 0
    models.forward(gpu, _torch(batch, cuda_device), impl="ref")
    assert fa.launches == E
    fa.launches = 0
    models.forward(gpu, {"tokens": torch.as_tensor(batch["tokens"],
                                                   device=cuda_device)})
    assert fa.launches == L
    fa.launches = 0
    _, cache = models.prefill(gpu, _torch(batch, cuda_device), max_len=8)
    _, hcache = models.prefill(host, _torch(batch), max_len=8)
    assert fa.launches == E + 2 * L
    for t in range(8):
        fa.launches = 0
        logits, cache = models.decode_step(gpu, cache, torch.as_tensor(
            batch["tokens"][:, t], device=cuda_device), t)
        torch.cuda.synchronize()
        assert fa.launches == L
        want, hcache = models.decode_step(host, hcache, torch.as_tensor(
            batch["tokens"][:, t]), t)
        assert float((logits.cpu() - want).abs().max()) < 1e-4
