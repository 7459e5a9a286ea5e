"""The port's serving path against the JAX package's model stack.

Reduced recurrentgemma-9b, gemma2-27b (local/global windows, softcap),
rwkv6-7b and dbrx-132b (MoE: 4 experts, top-2, tokens dropped by
capacity), and the text models qwen2-vl-2b (M-RoPE, explicit
`mrope_pos`), gemma-2b and granite-3-2b, are built by the JAX package,
their weights carried across with `repro_torch.models.convert`, and the
two packages' `forward` (logits and the MoE aux loss) and `decode_step`
compared on the same tokens: the JAX side with `impl="pallas"` (its
kernels in interpret mode), the port with `impl="cuda"` (its kernel
wrappers, which run their plain versions on a CPU tensor).  The tests
marked `cuda` run the port on the card.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import models  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rglru, rwkv6  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.attention import GQA  # noqa: E402
from repro_torch.models.recurrent import RGLRUBlock  # noqa: E402
from repro_torch.models.rwkv import RWKV6Block  # noqa: E402

SLICE_ARCHS = ["recurrentgemma-9b", "gemma2-27b", "rwkv6-7b", "dbrx-132b"]
TEXT_ARCHS = ["qwen2-vl-2b", "gemma-2b", "granite-3-2b"]
S_FWD = 12


def _tokens(vocab, B=2, S=S_FWD, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


def _inputs(cfg, toks) -> dict:
    """The forward's batch as numpy arrays: the tokens and, for an M-RoPE
    config, explicit positions of the three streams [3, B, S] (text
    positions for t, a 4-wide patch grid for h and w)."""
    batch = {"tokens": toks}
    if cfg.mrope_sections is not None:
        B, S = toks.shape
        t = np.arange(S)
        batch["mrope_pos"] = np.broadcast_to(
            np.stack([t, t // 4, t % 4])[:, None], (3, B, S)).copy()
    return batch


@pytest.fixture(scope="module")
def jx():
    """The JAX package's model stack.  Imported here, not at the top, so
    the tests marked `cuda` also run where JAX is not installed."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import models
    from repro.configs import ARCHS, reduced_config
    from repro.models import layers
    return types.SimpleNamespace(jax=jax, jnp=jnp, models=models,
                                 ARCHS=ARCHS, reduced=reduced_config,
                                 layers=layers)


@pytest.fixture(scope="module")
def setups(jx):
    """name -> (port model, JAX cfg, JAX params, JAX pallas logits, JAX
    aux)."""
    jax, jnp, jmodels = jx.jax, jx.jnp, jx.models
    cache = {}

    def get(name):
        if name not in cache:
            jcfg = jx.reduced(jx.ARCHS[name])
            params = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
            tree = jax.tree.map(np.asarray, params)
            model = models.from_jax_params(reduced_config(ARCHS[name]),
                                           tree, device="cpu")
            batch = _inputs(jcfg, _tokens(jcfg.vocab_size))
            logits, aux = jmodels.forward(
                jcfg, params, {k: jnp.asarray(v, jnp.int32)
                               for k, v in batch.items()}, impl="pallas")
            cache[name] = (model, jcfg, params, np.asarray(logits),
                           float(aux))
        return cache[name]

    return get


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _batch(model, toks, device="cpu"):
    return {k: torch.as_tensor(v, device=device)
            for k, v in _inputs(model.cfg, toks).items()}


def _dropless(model):
    """The same weights with a capacity factor of the expert count: a
    forward that drops no token, which per-token decode matches."""
    cfg = dataclasses.replace(model.cfg,
                              capacity_factor=float(model.cfg.n_experts))
    return models.Model(cfg, device=model.device,
                        params=models.param_tree(model))


def _launches():
    return fa.launches, rglru.launches, rwkv6.launches


def _zero_launches():
    fa.launches = rglru.launches = rwkv6.launches = 0


def _expected_launches(kinds, steps=1):
    """(flash attention, RG-LRU, RWKV6) launches of a pass over `kinds`:
    one per layer of each kind, `steps` times."""
    n_attn = sum(k not in ("rec", "rwkv") for k in kinds)
    return (n_attn * steps, kinds.count("rec") * steps,
            kinds.count("rwkv") * steps)


# ---------------------------------------------------------------------- #
# configs and weights
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_config_registry_is_a_faithful_copy(name, jx):
    assert sorted(ARCHS) == sorted(jx.ARCHS)
    for port, ref in ((ARCHS[name], jx.ARCHS[name]),
                      (reduced_config(ARCHS[name]),
                       jx.reduced(jx.ARCHS[name]))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()


@pytest.mark.parametrize("name", SLICE_ARCHS)
def test_conversion_round_trips_exactly(setups, name, jx):
    jax = jx.jax
    model, _, params, _, _ = setups(name)
    back = models.to_jax_params(model)
    want = jax.tree.map(np.asarray, params)
    assert (jax.tree.structure(back) == jax.tree.structure(want))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", SLICE_ARCHS)
def test_initialiser_builds_the_jax_shapes(name, jx):
    jax = jx.jax
    cfg = reduced_config(ARCHS[name])
    jcfg = jx.reduced(jx.ARCHS[name])
    model = models.Model(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    got = models.to_jax_params(model)
    want = jax.eval_shape(lambda: jx.models.init_params(
        jcfg, jax.random.PRNGKey(0)))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    again = models.Model(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)      # a seed fixes the weights


# ---------------------------------------------------------------------- #
# forward and decode against the JAX package
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", SLICE_ARCHS + TEXT_ARCHS)
@pytest.mark.parametrize("impl", ["cuda", "auto", "chunked"])
def test_forward_matches_jax(setups, name, impl):
    """Logits to 1e-4 and the MoE aux loss (0 without MoE) to 1e-6
    relative."""
    model, jcfg, _, want, want_aux = setups(name)
    before = _launches()
    logits, aux = models.forward(
        model, _batch(model, _tokens(jcfg.vocab_size)), impl=impl)
    assert _launches() == before    # CPU: plain versions
    assert logits.shape == want.shape
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert (want_aux == 0.0) == (not model.cfg.is_moe)
    assert abs(float(aux) - want_aux) <= 1e-6 * abs(want_aux)
    assert np.abs(logits.numpy() - want).max() < 1e-4


@pytest.mark.parametrize("name", SLICE_ARCHS + TEXT_ARCHS)
def test_decode_steps_match_jax(setups, name, jx):
    jax, jnp, jmodels = jx.jax, jx.jnp, jx.models
    model, jcfg, params, _, _ = setups(name)
    B, S = 2, 10
    toks = _tokens(jcfg.vocab_size, B=B, S=S, seed=1)
    jstep = jax.jit(lambda c, t, p: jmodels.decode_step(jcfg, params, c, t, p))
    jcache = jmodels.init_cache(jcfg, B, max_len=S)
    cache = models.init_cache(model, B, max_len=S)
    errs = []
    for t in range(S):
        jlog, jcache = jstep(jcache, jnp.asarray(toks[:, t], jnp.int32),
                             jnp.int32(t))
        logits, cache = models.decode_step(
            model, cache, torch.as_tensor(toks[:, t]), t)
        errs.append(float(np.abs(logits.numpy() - np.asarray(jlog)).max()))
    assert max(errs) < 1e-4, errs


@pytest.mark.parametrize("name,S", [("recurrentgemma-9b", 10),
                                    ("gemma2-27b", 10),
                                    ("gemma2-27b", 40),
                                    ("rwkv6-7b", 10),
                                    ("rwkv6-7b", 64),
                                    ("dbrx-132b", 10)])
def test_decode_matches_forward(setups, name, S):
    """The port's own decode-vs-forward equivalence; gemma2 at S=40
    decodes past its reduced window of 32 through the ring buffer, and
    rwkv6 at S=64 holds decode against a forward that runs the chunked
    form in 8 sub-blocks (auto on the CPU: chunked for the forward, ref
    for each step).  dbrx runs dropless (capacity factor = E, as the JAX
    package's own MoE test): decode routes each token as its own group,
    and matches the forward only where the forward drops nothing."""
    model = setups(name)[0]
    if model.cfg.is_moe:
        model = _dropless(model)
    if name == "gemma2-27b" and S > 32:
        assert model.cfg.local_window == 32
    toks = _tokens(model.cfg.vocab_size, B=1, S=S, seed=2)
    ref, _ = models.forward(model, _batch(model, toks))
    cache = models.init_cache(model, 1, max_len=S)
    errs = []
    for t in range(S):
        logits, cache = models.decode_step(
            model, cache, torch.as_tensor(toks[:, t]), t)
        errs.append(float((logits - ref[:, t]).abs().max()))
    assert max(errs) < 1e-4, errs


def test_prefill_returns_last_logits_and_an_empty_cache(setups):
    model = setups("recurrentgemma-9b")[0]
    batch = _batch(model, _tokens(model.cfg.vocab_size))
    full, _ = models.forward(model, batch)
    last, cache = models.prefill(model, batch, max_len=20)
    assert torch.equal(last, full[:, -1])
    assert torch.equal(make_prefill_step(model.cfg)(model, batch), last)
    assert len(cache) == model.cfg.n_layers
    assert all(float(t.abs().max()) == 0 for c in cache for t in c.values())


@pytest.mark.parametrize("name", SLICE_ARCHS)
def test_block_caches_take_no_default_device(name):
    """A block's `init_cache` has no default device, so a call without
    `device` raises instead of putting the cache on the CPU; the model's
    `init_cache` puts every tensor on the model's device, here `meta`."""
    cfg = reduced_config(get_config(name))
    for build in (lambda: GQA.init_cache(cfg, 2, 8),
                  lambda: RGLRUBlock.init_cache(cfg, 2),
                  lambda: RWKV6Block.init_cache(cfg, 2)):
        with pytest.raises(TypeError, match="device"):
            build()
    model = models.Model(cfg, device="cpu").to("meta")
    assert model.device.type == "meta"
    cache = models.init_cache(model, 2, max_len=8)
    assert len(cache) == cfg.n_layers
    assert all(t.device.type == "meta" for c in cache for t in c.values())


def test_serve_step_greedy(setups):
    model = setups("gemma2-27b")[0]
    step = make_serve_step(model.cfg)
    cache = models.init_cache(model, 2, max_len=8)
    nxt, cache = step(model, cache, torch.zeros(2, dtype=torch.int32), 0)
    assert nxt.shape == (2,) and nxt.dtype == torch.int32


def test_launcher_replay_matches_prefill():
    """The launcher's logits after replaying the prompt equal `prefill`'s
    last-position logits on the same prompts (what chip_smoke.py checks
    at full width)."""
    cfg = reduced_config(get_config("recurrentgemma-9b"))
    out = serve_mod.serve(cfg, batch=2, prompt_len=8, gen=4, device="cpu")
    assert out["generated"].shape == (2, 4)
    assert out["generated"].dtype == torch.int32
    last, _ = models.prefill(out["model"], {"tokens": out["prompts"]},
                             max_len=12)
    assert float((out["last_logits"] - last).abs().max()) < 1e-4


def test_launcher_serves_a_depth_cut_moe_config():
    """`serve` and `make_prefill_step` take an MoE config cut in depth as
    chip_smoke.py cuts dbrx-132b (fewer layers, dropless), unchanged."""
    cfg = reduced_config(get_config("dbrx-132b"))
    cfg = dataclasses.replace(cfg, n_layers=1,
                              capacity_factor=float(cfg.n_experts))
    out = serve_mod.serve(cfg, batch=2, prompt_len=8, gen=4, device="cpu")
    assert out["generated"].shape == (2, 4)
    assert out["model"].kinds == ["attn"]
    last = make_prefill_step(cfg)(out["model"], {"tokens": out["prompts"]})
    assert float((out["last_logits"] - last).abs().max()) < 1e-4


def test_launcher_main_runs_on_the_cpu(capsys):
    serve_mod.main(["--arch", "gemma-2b", "--reduced", "--batch", "2",
                    "--prompt-len", "4", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "serving gemma-2b-reduced: batch=2 prompt=4 gen=3" in out
    assert "sample generation ids" in out


# ---------------------------------------------------------------------- #
# layers
# ---------------------------------------------------------------------- #
def test_rope_and_mrope_match_jax(jx):
    jnp, jlayers = jx.jnp, jx.layers
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = np.tile(np.arange(6) + 3000, (2, 1))
    mpos = rng.integers(0, 50, (3, 2, 6))
    pairs = [
        (layers.rope(torch.from_numpy(x), torch.as_tensor(pos), 10_000.0),
         jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        (layers.mrope(torch.from_numpy(x), torch.as_tensor(mpos), (4, 2, 2)),
         jlayers.mrope(jnp.asarray(x), jnp.asarray(mpos), (4, 2, 2))),
    ]
    for got, want in pairs:
        assert np.abs(got.numpy() - np.asarray(want)).max() < 2e-5


def test_text_models_outside_the_slice_run_too(setups, jx):
    """qwen2-vl (M-RoPE) with no `mrope_pos`, where both packages give
    every stream the text positions, against the JAX package; the text
    models' forward with explicit positions and decode are held by
    test_forward_matches_jax and test_decode_steps_match_jax."""
    jnp = jx.jnp
    model, jcfg, params, _, _ = setups("qwen2-vl-2b")
    toks = _tokens(jcfg.vocab_size, S=5)
    want, _ = jx.models.forward(jcfg, params,
                                {"tokens": jnp.asarray(toks, jnp.int32)},
                                impl="pallas")
    logits, _ = models.forward(model, {"tokens": torch.as_tensor(toks)})
    assert logits.shape == (2, 5, jcfg.vocab_size)
    assert np.abs(logits.numpy() - np.asarray(want)).max() < 1e-4


@pytest.mark.parametrize("name,unset", [
    ("deepseek-v3-671b", ()), ("seamless-m4t-large-v2", ()),
    ("deepseek-v3-671b", ("use_mla",))])
def test_blocks_outside_the_slice_raise(name, unset):
    """Every config builds and runs: seamless-m4t-large-v2 with its
    encoder and a cross attention in each decoder block (its forward on
    frame embeddings finite), deepseek-v3 with MLA and with MLA turned
    off (GQA), its MoE layers and its MTP head alike
    (tests/test_torch_encdec.py and tests/test_torch_mla.py hold them to
    the JAX package)."""
    cfg = reduced_config(get_config(name))
    cfg = dataclasses.replace(cfg, **{field: False for field in unset})
    model = models.Model(cfg, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int64)}
    if cfg.n_encoder_layers:
        assert len(model.encoder) == cfg.n_encoder_layers
        assert all("xattn" in p and "ln_x" in p for p in model.layers)
        batch["frame_embeds"] = torch.ones((1, 3, cfg.d_model))
    else:
        assert ("wkv_a" in model.layers[0]["attn"].tree()) == cfg.use_mla
        assert len(model.mtp) == cfg.mtp_depth == 1
    logits, _ = models.forward(model, batch)
    assert logits.shape == (1, 4, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


def _patch_batch(cfg, seed=6):
    """qwen2-vl's batch with its vision frontend, as numpy arrays: 12
    tokens, explicit M-RoPE positions, and 4 patch embeddings in place
    of the first 4 tokens' (the JAX package's tests/test_models.py
    draws)."""
    rng = np.random.default_rng(seed)
    batch = _inputs(cfg, _tokens(cfg.vocab_size, seed=seed))
    batch["patch_embeds"] = rng.standard_normal(
        (2, 4, cfg.d_model)).astype(np.float32)
    return batch


def test_vision_frontend_and_training_raise(setups, jx):
    """The vision frontend (qwen2-vl-2b's patch embeddings, with explicit
    M-RoPE positions): `forward` and `loss_fn` against the JAX package's
    (1e-4), and the patches change the logits."""
    jax, jnp = jx.jax, jx.jnp
    model, jcfg, params, _, _ = setups("qwen2-vl-2b")
    batch = _patch_batch(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    want, _ = jx.models.forward(jcfg, params, jbatch, impl="pallas")
    logits, _ = models.forward(model, tbatch)
    assert float(np.abs(logits.numpy() - np.asarray(want)).max()) < 1e-4
    text, _ = models.forward(model, {k: v for k, v in tbatch.items()
                                     if k != "patch_embeds"})
    assert float((text - logits).abs().max()) > 1e-3
    jloss = jx.models.loss_fn(jcfg, params, jbatch)
    loss = models.loss_fn(model, tbatch)
    assert abs(float(loss) - float(jloss)) <= 1e-4 * max(1.0,
                                                         abs(float(jloss)))


# ---------------------------------------------------------------------- #
# on the card
# ---------------------------------------------------------------------- #
@pytest.mark.cuda
def test_default_prefill_launches_both_kernels(cuda_device):
    cfg = reduced_config(get_config("recurrentgemma-9b"))
    model = models.Model(cfg, device="cpu")
    gpu = models.from_jax_params(cfg, models.to_jax_params(model))
    assert gpu.device.type == "cuda"
    toks = _tokens(model.cfg.vocab_size)
    _zero_launches()
    last, _ = models.prefill(gpu, _batch(gpu, toks, cuda_device), max_len=16)
    torch.cuda.synchronize()
    assert _launches() == _expected_launches(gpu.kinds)
    want, _ = models.prefill(model, _batch(model, toks), max_len=16)
    assert float((last.cpu() - want).abs().max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("name", SLICE_ARCHS)
def test_forward_on_the_card_matches_the_cpu(name, cuda_device):
    """The kernel path on the card (GQA windows, softcap, head_dim 16, the
    WKV scan) against the plain versions on the host, on the same
    weights: one launch per layer of each kind."""
    cfg = reduced_config(get_config(name))
    model = models.Model(cfg, device="cpu")
    gpu = models.from_jax_params(cfg, models.to_jax_params(model))
    toks = _tokens(cfg.vocab_size, S=40)
    _zero_launches()
    got, _ = models.forward(gpu, _batch(gpu, toks, cuda_device))
    torch.cuda.synchronize()
    assert _launches() == _expected_launches(gpu.kinds)
    want, _ = models.forward(model, _batch(model, toks))
    assert float((got.cpu() - want).abs().max()) < 1e-4


@pytest.mark.cuda
def test_launcher_on_the_card(cuda_device):
    cfg = reduced_config(get_config("recurrentgemma-9b"))
    out = serve_mod.serve(cfg, batch=2, prompt_len=8, gen=4)
    assert out["generated"].device.type == "cuda"
    last, _ = models.prefill(out["model"], {"tokens": out["prompts"]},
                             max_len=12)
    assert float((out["last_logits"] - last).abs().max()) < 1e-4


@pytest.mark.cuda
def test_rwkv6_prefill_makes_one_launch_per_layer(cuda_device):
    """A reduced rwkv6-7b prefill on the card makes `n_layers` WKV
    launches and no other kernel's, and agrees with the host."""
    cfg = reduced_config(get_config("rwkv6-7b"))
    model = models.Model(cfg, device="cpu")
    gpu = models.from_jax_params(cfg, models.to_jax_params(model))
    toks = _tokens(cfg.vocab_size, S=70)
    _zero_launches()
    last = make_prefill_step(cfg)(gpu, _batch(gpu, toks, cuda_device))
    torch.cuda.synchronize()
    assert _launches() == (0, 0, cfg.n_layers)
    want = make_prefill_step(cfg)(model, _batch(model, toks))
    assert float((last.cpu() - want).abs().max()) < 1e-4


@pytest.mark.cuda
def test_rwkv6_decode_on_the_card_launches_the_kernel(cuda_device):
    """Each decode step launches the kernel once per layer with the cached
    state as s0, and the logits agree with the host's per-step form."""
    cfg = reduced_config(get_config("rwkv6-7b"))
    model = models.Model(cfg, device="cpu")
    gpu = models.from_jax_params(cfg, models.to_jax_params(model))
    S = 8
    toks = _tokens(cfg.vocab_size, S=S, seed=3)
    cache = models.init_cache(model, 2, max_len=S)
    gcache = models.init_cache(gpu, 2, max_len=S)
    _zero_launches()
    errs = []
    for t in range(S):
        want, cache = models.decode_step(model, cache,
                                         torch.as_tensor(toks[:, t]), t)
        got, gcache = models.decode_step(
            gpu, gcache, torch.as_tensor(toks[:, t], device=cuda_device), t)
        errs.append(float((got.cpu() - want).abs().max()))
    assert _launches() == _expected_launches(gpu.kinds, steps=S)
    assert max(errs) < 1e-4, errs
