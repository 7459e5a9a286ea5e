"""The port's MLA and MTP head (deepseek-v3-671b) against the JAX package.

Reduced deepseek-v3 (2 layers, d 64, 4 heads, q/k head dim 16 + 8 and v
16, 4 experts top-2, the MTP head of depth 1) is built by the JAX
package, its weights carried across as numpy arrays with
`repro_torch.models.convert`, and the same numpy-seeded tokens go through
both.  The JAX side runs `impl="ref"`: its Pallas flash attention takes no
v head dim apart from q's and raises on MLA's shapes, and `ref` is the
path that computes them.  The port runs its default dispatch (and
`cuda`, whose wrapper runs the plain version on a CPU tensor, and
`chunked`).

Tolerances: `MLA.apply` 1e-5; `forward` logits and ten `decode_step`s
1e-4 (the JAX package's own decode-vs-forward bound), the MoE aux 1e-6
relative; `loss_fn` and its gradients as tests/test_torch_train.py holds
dbrx's (the loss 1e-4·max(1, |loss|), every leaf 1e-4·max(1, max|g|),
remat against no remat 1e-6); the flash-attention kernel at (192, 128)
against its plain version 2e-5 in float32 and 2e-2 in bfloat16.  The
tests marked `cuda` run on the card.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import models  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models.attention import MLA  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402

ARCH = "deepseek-v3-671b"
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# one full-width layer and the embeddings, without the MTP head (what
# chip_smoke.py builds on the card)
ONE_LAYER_PARAMS = 13_360_651_264


@pytest.fixture(scope="module")
def jx():
    """The JAX package's model stack.  Imported here, not at the top, so
    the tests marked `cuda` also run where JAX is not installed."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import models as jmodels
    from repro.configs import ARCHS, reduced_config as jreduced
    from repro.models import attention as jattention
    return types.SimpleNamespace(jax=jax, jnp=jnp, models=jmodels,
                                 ARCHS=ARCHS, reduced=jreduced,
                                 attention=jattention)


def _configs(jx, **overrides):
    """(JAX cfg, port cfg) of reduced deepseek-v3 with `overrides`."""
    jcfg = dataclasses.replace(jx.reduced(jx.ARCHS[ARCH]), **overrides)
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@pytest.fixture(scope="module")
def setup(jx):
    """(JAX cfg, JAX params, port model) of reduced deepseek-v3."""
    jcfg, cfg = _configs(jx)
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


def _tokens(vocab, B=2, S=12, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


def _dropless(model):
    """The same weights at capacity factor n_experts / experts_per_token,
    the smallest that drops no token (C = S: a token's k experts are
    distinct), which per-token decode matches."""
    cfg = model.cfg
    cfg = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    return models.Model(cfg, device=model.device,
                        params=models.param_tree(model))


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


# ---------------------------------------------------------------------- #
# the block, the model and the conversion
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["auto", "cuda", "chunked"])
@pytest.mark.parametrize("q_lora_rank", [32, 0])
def test_mla_apply_matches_jax(q_lora_rank, impl, jx):
    """One MLA block, with the q LoRA and its norm and without them."""
    jax, jnp = jx.jax, jx.jnp
    jcfg, cfg = _configs(jx, q_lora_rank=q_lora_rank)
    p = jx.attention.MLA.init(jax.random.PRNGKey(1), jcfg)
    assert ("wq_a" in p) == bool(q_lora_rank) and ("wq" in p) != bool(
        q_lora_rank)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(9) + 5, (2, 1))
    want = jx.attention.MLA.apply(p, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                  impl="ref")
    pt = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    got = MLA.apply(pt, cfg, torch.from_numpy(x), torch.as_tensor(pos),
                    impl=impl)
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 1e-5


def test_initialiser_builds_the_jax_shapes(jx):
    """`init_params` builds the JAX tree's shapes, MTP head included, and
    a seed fixes the weights."""
    jax = jx.jax
    jcfg, cfg = _configs(jx)
    model = models.Model(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    got = models.to_jax_params(model)
    want = jax.eval_shape(lambda: jx.models.init_params(
        jcfg, jax.random.PRNGKey(0)))
    assert {"mtp", "mtp_ln"} <= set(got)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    again = models.Model(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_layers,mtp_depth", [(61, 1), (1, 0)])
def test_full_width_config_builds(n_layers, mtp_depth, jx):
    """`Model` takes deepseek-v3-671b's published config (61 layers and
    the MTP head) and the one-layer cut the card runs, with the JAX
    package's parameter counts; built as fake tensors, which hold shapes
    and no storage."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    jax = jx.jax
    cfg = dataclasses.replace(get_config(ARCH), n_layers=n_layers,
                              mtp_depth=mtp_depth)
    jcfg = dataclasses.replace(jx.ARCHS[ARCH], n_layers=n_layers,
                               mtp_depth=mtp_depth)
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        jax.eval_shape(lambda: jx.models.init_params(
            jcfg, jax.random.PRNGKey(0)))))
    with FakeTensorMode():
        model = models.Model(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
        n = sum(p.numel() for p in model.parameters())
    assert n == want
    assert (model.mtp is not None) == bool(mtp_depth)
    if n_layers == 1:
        assert n == ONE_LAYER_PARAMS


def test_conversion_round_trips_the_mtp_head(setup, jx):
    jax = jx.jax
    _, params, model = setup
    assert len(model.mtp) == 1
    back = models.to_jax_params(model)
    want = jax.tree.map(np.asarray, params)
    assert set(back["mtp"]) == {"b0_attn"}
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # any tree shaped like the params (gradients, moments) carries alike
    tree = models.from_jax_tree(model.cfg, want, device="cpu")
    assert len(tree["mtp"]) == 1 and "mtp_ln" in tree
    again = models.to_jax_tree(model.cfg, tree)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(want)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("impl", ["auto", "cuda", "chunked"])
def test_forward_matches_jax(setup, impl, jx):
    """Logits to 1e-4 and the MoE aux to 1e-6 relative, at the config's
    capacity factor (tokens dropped alike on both sides)."""
    jnp = jx.jnp
    jcfg, params, model = setup
    toks = _tokens(jcfg.vocab_size)
    want, want_aux = jx.models.forward(
        jcfg, params, {"tokens": jnp.asarray(toks, jnp.int32)}, impl="ref")
    before = fa.launches
    logits, aux = models.forward(model, {"tokens": torch.as_tensor(toks)},
                                 impl=impl)
    assert fa.launches == before     # CPU: plain versions
    assert logits.shape == want.shape
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))
    assert float(np.abs(logits.numpy() - np.asarray(want)).max()) < 1e-4


def test_decode_steps_match_jax(setup, jx):
    """Ten `decode_step`s (the absorbed form) against the JAX package's,
    dropless on both sides, and against the port's own forward."""
    jax, jnp = jx.jax, jx.jnp
    jcfg, params, model = setup
    model = _dropless(model)
    jcfg = dataclasses.replace(jcfg, capacity_factor=model.cfg.capacity_factor)
    B, S = 2, 10
    toks = _tokens(jcfg.vocab_size, B=B, S=S, seed=1)
    jstep = jax.jit(lambda c, t, p: jx.models.decode_step(jcfg, params, c,
                                                           t, p))
    jcache = jx.models.init_cache(jcfg, B, max_len=S)
    cache = models.init_cache(model, B, max_len=S)
    assert set(cache[0]) == {"ckv", "krope"}
    assert cache[0]["ckv"].shape == (B, S, model.cfg.kv_lora_rank)
    ref, _ = models.forward(model, {"tokens": torch.as_tensor(toks)})
    to_jax, to_forward = [], []
    for t in range(S):
        jlog, jcache = jstep(jcache, jnp.asarray(toks[:, t], jnp.int32),
                             jnp.int32(t))
        logits, cache = models.decode_step(
            model, cache, torch.as_tensor(toks[:, t]), t)
        to_jax.append(float(np.abs(logits.numpy() - np.asarray(jlog)).max()))
        to_forward.append(float((logits - ref[:, t]).abs().max()))
    assert max(to_jax) < 1e-4, to_jax
    assert max(to_forward) < 1e-4, to_forward
    # the cache was written in place, one position a step
    assert float(cache[0]["krope"][:, S - 1].abs().max()) > 0


@pytest.mark.parametrize("mtp_weight", [0.3, 0.0])
def test_loss_fn_and_its_gradients_match_jax(setup, mtp_weight, jx):
    """`loss_fn` with the MTP head's t+2 term weighted by `mtp_weight`,
    and its gradients, the head's included (none at weight 0)."""
    jax, jnp = jx.jax, jx.jnp
    jcfg, params, model = setup
    model = models.Model(model.cfg, device="cpu",
                         params=models.param_tree(model)).requires_grad_(True)
    toks = _tokens(jcfg.vocab_size, seed=4).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(lambda p: jx.models.loss_fn(
        jcfg, p, {"tokens": jnp.asarray(toks)}, impl="ref",
        mtp_weight=mtp_weight))(params)
    batch = {"tokens": torch.as_tensor(toks)}
    loss = models.loss_fn(model, batch, mtp_weight=mtp_weight)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-4 * max(
        1.0, abs(float(jloss)))
    tree = models.param_tree(model)
    grads = torch.autograd.grad(loss, tree_leaves(tree), allow_unused=True)
    it = iter(grads)
    gtree = models.to_jax_tree(model.cfg, tree_map(
        lambda p: (lambda g: torch.zeros_like(p) if g is None else g)(
            next(it)), tree))
    got, want = _flat(gtree), _flat(jax.tree.map(np.asarray, jgrads))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert _scaled_err(got[key], want[key]) < 1e-4, key
    head = [k for k in want if k.startswith("/mtp")]
    assert head and (max(float(np.abs(got[k]).max()) for k in head) > 0) \
        == (mtp_weight > 0)
    loss_r = models.loss_fn(model, batch, mtp_weight=mtp_weight, remat=True)
    grads_r = torch.autograd.grad(loss_r, tree_leaves(tree),
                                  allow_unused=True)
    assert abs(float(loss_r.detach()) - float(loss.detach())) <= 1e-6
    for a, b in zip(grads, grads_r):
        assert (a is None) == (b is None)
        if a is not None:
            assert float((a - b).abs().max()) <= 1e-6


def test_mla_gradients_at_published_head_dims_match_jax(jx):
    """Reduced deepseek-v3 with the published head dims (q/k 128 + 64, v
    128, so flash attention runs at (192, 128)): the gradient of `loss_fn`
    with respect to the MLA leaves only (each layer's and the MTP head's
    `attn`: what chip_smoke.py's path D differentiates on the card),
    through `impl="cuda"`, whose wrapper runs the plain version on a CPU
    tensor, against `jax.grad` of the JAX package's `loss_fn` restricted
    to the same leaves."""
    jax, jnp = jx.jax, jx.jnp
    jcfg, cfg = _configs(jx, qk_nope_head_dim=128, qk_rope_head_dim=64,
                         v_head_dim=128)
    params = jx.models.init_params(jcfg, jax.random.PRNGKey(2))
    model = models.from_jax_params(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    tree = models.param_tree(model)
    is_mla = {}

    def mark(path, leaf):
        is_mla[id(leaf)] = "/attn/" in path
        return leaf

    def walk(t, path=""):
        if isinstance(t, dict):
            return {k: walk(x, f"{path}/{k}") for k, x in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(x, f"{path}/{i}") for i, x in enumerate(t))
        return mark(path, t)

    walk(tree)
    leaves = [p for p in tree_leaves(tree) if is_mla[id(p)]]
    assert len(leaves) == 8 * (cfg.n_layers + cfg.mtp_depth)
    model.requires_grad_(False)
    for p in leaves:
        p.requires_grad_(True)
    toks = _tokens(jcfg.vocab_size, seed=6).astype(np.int32)
    before = (fa.launches, fa.launches_bwd)
    loss = models.loss_fn(model, {"tokens": torch.as_tensor(toks)},
                          impl="cuda")
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    assert (fa.launches, fa.launches_bwd) == before   # the plain versions
    jloss, jgrads = jax.value_and_grad(lambda p: jx.models.loss_fn(
        jcfg, p, {"tokens": jnp.asarray(toks)}, impl="ref"))(params)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-4 * max(
        1.0, abs(float(jloss)))
    # the port's gradients (zero off the MLA leaves) and a mask of the MLA
    # leaves, both carried to the JAX tree's layout
    gtree = models.to_jax_tree(cfg, tree_map(
        lambda p: grads.get(id(p), torch.zeros_like(p)), tree))
    mask = models.to_jax_tree(cfg, tree_map(
        lambda p: torch.full_like(p, float(is_mla[id(p)])), tree))
    got, want = _flat(gtree), _flat(jax.tree.map(np.asarray, jgrads))
    mask = _flat(mask)
    assert got.keys() == want.keys() == mask.keys()
    # the JAX tree stacks the layers: one key a leaf name, and the head's
    mla = [key for key in want if "/attn/" in key]
    assert len(mla) == 8 * (1 + bool(cfg.mtp_depth))
    assert all(mask[key].all() == (key in mla) and mask[key].any() ==
               (key in mla) for key in want)
    for key in mla:
        assert got[key].shape == want[key].shape, key
        assert _scaled_err(got[key], want[key]) < 1e-4, key
        assert float(np.abs(want[key]).max()) > 0, key


def test_dry_run_charges_the_backward_at_mla_head_dims():
    """The dry run of a train step (fake tensors, `impl="cuda"`: each
    kernel call one region) at the published head dims charges every
    MLA layer's flash-attention forward and its backward at (Dqk, Dv) =
    (192, 128) the functions' work, and nothing else as a kernel."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import analyze_program, hlo_cost
    cfg = dataclasses.replace(
        reduced_config(get_config(ARCH)), qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128)
    B, S = 2, 32
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        model = models.Model(cfg, device="cpu").requires_grad_(True)
        batch = {"tokens": torch.zeros((B, S), dtype=torch.int32)}
    leaves = tree_leaves(models.param_tree(model))

    def step():
        loss = models.loss_fn(model, batch, impl="cuda")
        return torch.autograd.grad(loss, leaves)

    with fake:
        cost = analyze_program(step)
    calls = cfg.n_layers + cfg.mtp_depth
    work = [f(B, S, S, cfg.n_heads, cfg.n_heads, 192, 128, True, None, 4)
            for f in (hlo_cost.attention_work, hlo_cost.attention_bwd_work)]
    assert cost.by_class["kernel"] == {
        "count": 2 * calls,
        "flops": float(calls * (work[0][0] + work[1][0])),
        "bytes": float(calls * (work[0][1] + work[1][1]))}


def test_a_tree_without_the_head_trains_without_its_term(setup, jx):
    """As in the JAX package, the MTP term needs the head's parameters:
    a tree without "mtp" gives the plain next-token loss."""
    jnp = jx.jnp
    jcfg, params, model = setup
    bare = {k: v for k, v in models.param_tree(model).items()
            if k not in ("mtp", "mtp_ln")}
    headless = models.Model(model.cfg, device="cpu", params=bare)
    assert headless.mtp is None and "mtp" not in models.param_tree(headless)
    toks = _tokens(jcfg.vocab_size, seed=5).astype(np.int32)
    jparams = {k: v for k, v in params.items() if k not in ("mtp", "mtp_ln")}
    want = jx.models.loss_fn(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                             impl="ref")
    got = models.loss_fn(headless, {"tokens": torch.as_tensor(toks)})
    assert abs(float(got) - float(want)) <= 1e-4 * max(1.0, abs(float(want)))
    with_head = models.loss_fn(model, {"tokens": torch.as_tensor(toks)})
    assert float(with_head) > float(got)


def test_launcher_serves_a_depth_cut_mla_config():
    """`serve` and `make_prefill_step` take MLA's per-layer cache unchanged
    on the cut chip_smoke.py runs (one layer, no MTP head, dropless)."""
    cfg = reduced_config(get_config(ARCH))
    cfg = dataclasses.replace(
        cfg, n_layers=1, mtp_depth=0,
        capacity_factor=cfg.n_experts / cfg.experts_per_token)
    out = serve_mod.serve(cfg, batch=2, prompt_len=8, gen=4, device="cpu")
    assert out["generated"].shape == (2, 4)
    assert out["model"].mtp is None
    last = make_prefill_step(cfg)(out["model"], {"tokens": out["prompts"]})
    assert float((out["last_logits"] - last).abs().max()) < 1e-4


# ---------------------------------------------------------------------- #
# the wrapper at MLA's head dims
# ---------------------------------------------------------------------- #
def _mla_qkv(B, Sq, Sk, Hq, Hkv, Dqk=192, Dv=128, dtype=torch.float32,
             device="cpu", seed=0):
    """Independent random q, k and v: a stride that reads v's columns for
    k's (or the other way round) cannot hide behind equal values."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device=device, dtype=dtype)
        for shape in ((B, Sq, Hq, Dqk), (B, Sk, Hkv, Dqk), (B, Sk, Hkv, Dv)))


def test_wrapper_takes_mla_head_dims_and_refuses_mismatches():
    assert (192, 128) in fa.HEAD_DIM_PAIRS
    assert all((d, d) in fa.HEAD_DIM_PAIRS for d in fa.HEAD_DIMS)
    q, k, v = _mla_qkv(1, 9, 9, 4, 2)
    out = fa.flash_attention(q, k, v, causal=True, scale=192 ** -0.5)
    want = ops.attention(q, k, v, causal=True, scale=192 ** -0.5,
                         impl="chunked")
    assert out.shape == (1, 9, 4, 128)
    assert float((out - want).abs().max()) < 1e-5
    with pytest.raises(ValueError, match="shapes"):      # batch of v
        fa.flash_attention(q, k, torch.cat([v, v]))
    with pytest.raises(ValueError, match="shapes"):      # heads of v
        fa.flash_attention(q, k, torch.cat([v, v], dim=2))
    with pytest.raises(ValueError, match="shapes"):      # length of v
        fa.flash_attention(q, k, v[:, :5])
    with pytest.raises(ValueError, match="shapes"):      # k's head dim
        fa.flash_attention(q, k[..., :128], v)
    with pytest.raises(ValueError, match="Hq=4"):        # heads of q
        fa.flash_attention(q, k[:, :, :1].expand(1, 9, 3, 192).contiguous(),
                           v[:, :, :1].expand(1, 9, 3, 128).contiguous())


def test_gradient_at_mla_head_dims_reaches_the_device_check_off_the_cpu():
    """Off the CPU a gradient request at MLA's (Dqk, Dv) = (192, 128) goes
    to the kernel path, as at equal head dims: a `meta` input that
    requires grad reaches the device-type check and raises there, as it
    does under no_grad, and nothing is launched; on the CPU the plain
    version's autograd runs."""
    q, k, v = _mla_qkv(1, 5, 5, 2, 2, device="meta")
    before = (fa.launches, fa.launches_bwd)
    for i in range(3):
        x = [q, k, v]
        x[i] = x[i].clone().requires_grad_(True)
        with pytest.raises(ValueError, match="CPU or CUDA"):
            fa.flash_attention(*x)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CPU or CUDA"):
            fa.flash_attention(q, k, v)
    assert (fa.launches, fa.launches_bwd) == before
    q, k, v = _mla_qkv(1, 5, 5, 2, 2)
    q.requires_grad_(True)
    fa.flash_attention(q, k, v).sum().backward()
    assert q.grad.shape == q.shape and bool(torch.isfinite(q.grad).all())


# ---------------------------------------------------------------------- #
# on the card
# ---------------------------------------------------------------------- #
# (B, Sq, Sk, Hq, Hkv, causal, window): chip_smoke.py's phase-5 MLA cases
MLA_CASES = [(2, 77, 77, 8, 8, True, None), (2, 77, 77, 8, 8, False, None),
             (2, 77, 77, 8, 8, True, 32), (2, 77, 77, 8, 2, True, None),
             (1, 20, 9, 4, 4, False, None), (1, 130, 130, 4, 1, True, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MLA_CASES)
def test_kernel_at_mla_head_dims_matches_plain(case, dt, cuda_device):
    B, Sq, Sk, Hq, Hkv, causal, window = case
    q, k, v = _mla_qkv(B, Sq, Sk, Hq, Hkv, dtype=getattr(torch, dt),
                       device=cuda_device, seed=Sq + Hkv)
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    scale=192 ** -0.5)
    assert got.shape == (B, Sq, Hq, 128) and got.dtype == q.dtype
    err = float((got.float() - want.float()).abs().max())
    assert err < TOL[dt], (case, dt, err)


@pytest.mark.cuda
def test_kernel_refuses_other_head_dim_pairs(cuda_device):
    q, k, v = _mla_qkv(1, 8, 8, 2, 2, Dqk=24, Dv=16, device=cuda_device)
    before = fa.launches
    with pytest.raises(ValueError, match="Dqk, Dv"):
        fa.flash_attention(q, k, v)
    assert fa.launches == before


# the plain version's gradient in float64 on the card is the reference:
# 5e-5 (float32) and 2e-2 (bfloat16) of max(1, max|g|)
BWD_TOL = {"float32": 5e-5, "bfloat16": 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MLA_CASES)
def test_backward_kernel_at_mla_head_dims_matches_plain(case, dt,
                                                        cuda_device):
    """The backward kernel's (192, 128) instantiation: one launch, dq, dk
    and dv each within BWD_TOL of the plain version's float64 autograd,
    two calls bit-identical, and the forward's output the same with and
    without its log-sum-exp write."""
    B, Sq, Sk, Hq, Hkv, causal, window = case
    q, k, v = _mla_qkv(B, Sq, Sk, Hq, Hkv, dtype=getattr(torch, dt),
                       device=cuda_device, seed=Sq + Hkv)
    dout = _mla_qkv(B, Sq, Sq, Hq, Hq, Dqk=128, dtype=getattr(torch, dt),
                    device=cuda_device, seed=Sq + Hkv + 1)[0]
    kw = dict(causal=causal, window=window, scale=192 ** -0.5)
    with torch.no_grad():
        plain_out = fa.flash_attention(q, k, v, **kw)
    grads = []
    for _ in range(2):
        qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = fa.launches_bwd
        out = fa.flash_attention(*qkv, **kw)
        assert torch.equal(out.detach(), plain_out)
        out.backward(dout)
        torch.cuda.synchronize()
        assert fa.launches_bwd == before + 1
        grads.append([x.grad for x in qkv])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    want = fa.flash_attention_bwd_plain(q.double(), k.double(), v.double(),
                                        dout.double(), **kw)
    for name, got, w in zip(("dq", "dk", "dv"), grads[0], want):
        assert got.dtype == q.dtype and got.shape == w.shape, name
        err = float((got.double() - w).abs().max()) / max(
            1.0, float(w.abs().max()))
        assert err < BWD_TOL[dt], (case, dt, name, err)


@pytest.mark.cuda
def test_forward_at_published_head_dims_goes_through_the_kernel(
        cuda_device):
    """Reduced deepseek-v3 with its published head dims (q/k 128 + 64, v
    128): the card's forward makes one flash-attention launch a layer and
    matches `impl="ref"` on the host, on the same weights."""
    cfg = dataclasses.replace(
        reduced_config(get_config(ARCH)), qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128)
    model = models.Model(cfg, device="cpu")
    gpu = models.from_jax_params(cfg, models.to_jax_params(model))
    toks = torch.as_tensor(_tokens(cfg.vocab_size, S=40))
    before = fa.launches
    got, _ = models.forward(gpu, {"tokens": toks.to(cuda_device)})
    torch.cuda.synchronize()
    assert fa.launches == before + cfg.n_layers
    want, _ = models.forward(model, {"tokens": toks}, impl="ref")
    assert float((got.cpu() - want).abs().max()) < 1e-4
