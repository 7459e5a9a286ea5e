"""The port's training path against the JAX package's.

The same numpy-seeded inputs go through the JAX package and the port:
the data pipeline (array-equal), AdamW and the cosine schedule, the int8
error-feedback compression, the straggler detector and the supervisor
(mirroring tests/test_substrate.py), the gradients of attention and of
the RG-LRU scan (against `jax.vjp` of the JAX package's differentiable
paths, `impl="auto"`: `attention_ref`/`_attention_chunked`, `rglru_ref`),
`loss_fn` with its gradients and `make_train_step` on reduced configs
with weights carried across, and the training launcher with checkpoints
that either package resumes from.  The tests marked `cuda` run the
backward kernels inside a train step on the card.

Tolerances:
- the cosine schedule 1e-7 of its peak, clipping and the AdamW update 1e-6
  (float32 and bfloat16 moments), compression codes and scales exactly,
  the error-feedback cycle 1e-7;
- attention and RG-LRU gradients 1e-4·max(1, max|g|) in float32 and
  2e-2·max(1, max|g|) in bfloat16;
- `loss_fn`: the loss 1e-4·max(1, |loss|), every gradient leaf
  1e-4·max(1, max|g|), remat against no remat 1e-6;
- `make_train_step` (2 steps): each package's step, the port's and the
  JAX package's jitted one alike, against the same step evaluated from
  float64 gradients at that package's own state before it: loss 1e-5
  relative, grad_norm 1e-5 relative (with a bfloat16 accumulator, plus
  one bfloat16 rounding step of the largest gradient entry,
  2^-7·max|g|^2 / grad_norm), lr exactly, the params within 2.2·lr
  everywhere and 1e-5 where the float64 |g| > 1e-3·max|g| (Adam's first
  step is a sign where the gradient is noise); the two packages' m
  1e-4·max(1, max|m|) of each other.
"""
import contextlib
import io
import sys
import types
from contextlib import redirect_stdout
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import models  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM, host_shard  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, rglru, rwkv6  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, clip_by_global_norm,
                               compress_grads, compressed_bytes,
                               cosine_schedule, decompress_grads,
                               ef_compress_cycle, init_error_feedback)
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from repro_torch.runtime import (ElasticMesh, StragglerDetector,  # noqa: E402
                                 TrainSupervisor)

GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LOSS_ARCHS = ["smollm-360m", "recurrentgemma-9b", "gemma2-27b", "rwkv6-7b",
              "dbrx-132b"]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's training stack.  Imported here, not at the top,
    so the tests marked `cuda` also run where JAX is not installed."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import models as jmodels
    from repro import optim as joptim
    from repro.checkpoint import CheckpointManager as JCkpt
    from repro.configs import ARCHS, reduced_config as jreduced
    from repro.configs.base import ParallelConfig as JPar
    from repro.data import SyntheticLM as JSynth, DataConfig as JData
    from repro.kernels import ops as jops, ref as jref
    from repro.launch import steps as jsteps
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, models=jmodels, optim=joptim, Ckpt=JCkpt,
        ARCHS=ARCHS, reduced=jreduced, Par=JPar, Synth=JSynth, Data=JData,
        ops=jops, ref=jref, steps=jsteps)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _t(a, dtype="float32", device="cpu"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        device=device, dtype=getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


def _scaled_err(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.abs(got - want).max()) / max(1.0, float(
        np.abs(want).max())) if want.size else 0.0


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------- #
# data (tests/test_substrate.py:18-44, and array-equal to the JAX package)
# ---------------------------------------------------------------------- #
def test_data_deterministic_resume():
    cfg = DataConfig(vocab_size=1000, seq_len=32, global_batch=8)
    d1, d2 = SyntheticLM(cfg), SyntheticLM(cfg)
    np.testing.assert_array_equal(d1.batch(7)["tokens"],
                                  d2.batch(7)["tokens"])
    assert not np.array_equal(d1.batch(7)["tokens"], d1.batch(8)["tokens"])


def test_data_host_sharding_partitions_batch():
    cfg = DataConfig(vocab_size=1000, seq_len=16, global_batch=8)
    full = SyntheticLM(cfg, shard_id=0, num_shards=1).batch(3)["tokens"]
    parts = [SyntheticLM(cfg, shard_id=i, num_shards=4).batch(3)["tokens"]
             for i in range(4)]
    np.testing.assert_array_equal(full, np.concatenate(parts))
    with pytest.raises(AssertionError):
        host_shard(10, 0, 3)


def test_data_microbatch_split():
    cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=8)
    assert SyntheticLM(cfg).batch(0, n_micro=4)["tokens"].shape == (4, 2, 8)


@pytest.mark.parametrize("seed,step,shard,n_micro", [
    (0, 0, 0, 1), (0, 7, 1, 2), (3, 11, 3, 1), (5, 2, 0, 4)])
def test_data_batches_equal_the_jax_package(seed, step, shard, n_micro, jx):
    kw = dict(vocab_size=777, seq_len=24, global_batch=16, seed=seed)
    got = SyntheticLM(DataConfig(**kw), shard, 4).batch(step, n_micro)
    want = jx.Synth(jx.Data(**kw), shard, 4).batch(step, n_micro)
    assert got["tokens"].dtype == want["tokens"].dtype
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


# ---------------------------------------------------------------------- #
# optim (tests/test_substrate.py:45-80, and against the JAX package)
# ---------------------------------------------------------------------- #
def test_adamw_reduces_quadratic_loss():
    cfg = AdamWConfig(lr=0.1, warmup_steps=1, total_steps=100,
                      weight_decay=0.0, clip_norm=1e9)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params, cfg)
    for _ in range(60):
        params, state, _ = adamw_update(params, {"w": 2 * params["w"]},
                                        state, cfg)
    assert float(params["w"].abs().max()) < 0.5


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(cosine_schedule(cfg, 0)) == 0.0
    assert float(cosine_schedule(cfg, 10)) == pytest.approx(1.0)
    assert float(cosine_schedule(cfg, 100)) == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 7), (20, 50),
                                          (100, 10_000)])
def test_cosine_schedule_equals_the_jax_package(warmup, total, jx):
    """Every step to 1e-7 of the peak rate.  Relative to the rate itself
    the decay's tail cannot hold 1e-7: there 1 + cos(pi t) cancels, and
    XLA's float32 cos and PyTorch's differ by an ulp on some arguments
    (as on 222 of these 10,000 steps), which the cancellation makes a
    relative error of up to ~1e-4 on a rate near 0."""
    cfg = AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    jcfg = jx.optim.AdamWConfig(lr=3e-4, warmup_steps=warmup,
                                total_steps=total)
    steps = np.arange(total + 3, dtype=np.int32)
    want = np.asarray(jx.jax.vmap(lambda s: jx.optim.cosine_schedule(
        jcfg, s))(jx.jnp.asarray(steps)))
    got = cosine_schedule(cfg, torch.as_tensor(steps)).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.abs(got.astype(np.float64) - want).max() <= 1e-7 * cfg.lr


def test_clip_by_global_norm():
    clipped, gn = clip_by_global_norm({"a": torch.full((4,), 10.0)}, 1.0)
    assert float(gn) == pytest.approx(20.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(
        1.0, rel=1e-5)


def test_bf16_moments_supported():
    cfg = AdamWConfig(moment_dtype=torch.bfloat16)
    params = {"w": torch.ones((8,), dtype=torch.bfloat16)}
    state = adamw_init(params, cfg)
    assert state["m"]["w"].dtype == torch.bfloat16
    p2, _, _ = adamw_update(params, {"w": torch.ones((8,),
                                                     dtype=torch.bfloat16)},
                            state, cfg)
    assert p2["w"].dtype == torch.bfloat16


def _opt_tree(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 2)}}
    def draw(s, scale):
        if isinstance(s, dict):
            return {k: draw(v, scale) for k, v in s.items()}
        return (rng.standard_normal(s) * scale).astype(np.float32)
    return draw(shapes, 1.0), draw(shapes, 3.0)


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [1.0, 1e9])
def test_adamw_update_matches_the_jax_package(moment, clip_norm, jx):
    params, grads = _opt_tree()
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip_norm)
    cfg = AdamWConfig(moment_dtype=getattr(torch, moment), **kw)
    jcfg = jx.optim.AdamWConfig(moment_dtype=getattr(jx.jnp, moment), **kw)
    to_t = lambda tr: {k: to_t(v) if isinstance(v, dict) else _t(v)  # noqa
                       for k, v in tr.items()}
    p, st = to_t(params), adamw_init(to_t(params), cfg)
    jp = jx.jax.tree.map(jx.jnp.asarray, params)
    jst = jx.optim.adamw_init(jp, jcfg)
    for i in range(3):
        g_tree = jx.jax.tree.map(lambda x: x * (1 + i), grads)
        jp, jst, jm = jx.optim.adamw_update(
            jp, jx.jax.tree.map(jx.jnp.asarray, g_tree), jst, jcfg)
        p, st, m = adamw_update(p, to_t(g_tree), st, cfg)
        assert _scaled_err(m["grad_norm"], jm["grad_norm"]) < 1e-6
        assert abs(float(m["lr"]) - float(jm["lr"])) <= 1e-7 * float(jm["lr"])
        for key, want in _flat(jx.jax.tree.map(np.asarray, jp)).items():
            assert _scaled_err(_flat(p)[key], want) < 1e-6, (i, key)
        for part in ("m", "v"):
            for key, want in _flat(jx.jax.tree.map(np.asarray,
                                                   jst[part])).items():
                got = _flat(st[part])[key]
                assert got.dtype == getattr(torch, moment)
                assert _scaled_err(got, want) < 1e-6, (i, part, key)
        assert int(st["step"]) == int(jst["step"]) == i + 1


def test_adamw_in_place_equals_the_functional_form():
    params, grads = _opt_tree(1)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    to_t = lambda tr: {k: to_t(v) if isinstance(v, dict) else _t(v)  # noqa
                       for k, v in tr.items()}
    p1, p2 = to_t(params), to_t(params)
    s1, s2 = adamw_init(p1, cfg), adamw_init(p2, cfg)
    for _ in range(2):
        p1, s1, m1 = adamw_update(p1, to_t(grads), s1, cfg)
        ids = [id(t) for t in tree_leaves(p2)]
        p2, s2, m2 = adamw_update(p2, to_t(grads), s2, cfg, inplace=True)
        assert [id(t) for t in tree_leaves(p2)] == ids
    for a, b in zip(tree_leaves((p1, s1)), tree_leaves((p2, s2))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------- #
# compression (tests/test_substrate.py:83-100, and against the JAX package)
# ---------------------------------------------------------------------- #
def test_error_feedback_compression_unbiased_over_time():
    rng = np.random.default_rng(0)
    g = {"w": _t(rng.standard_normal(1000))}
    ef = init_error_feedback(g)
    applied = torch.zeros(1000)
    for _ in range(20):
        out, ef = ef_compress_cycle(g, ef)
        applied = applied + out["w"]
    assert float((applied / 20 - g["w"]).abs().max()) < 0.05


def test_compression_ratio_about_4x():
    raw, comp = compressed_bytes({"w": torch.zeros((10_000,))})
    assert raw / comp > 3.5


def test_compression_matches_the_jax_package(jx):
    rng = np.random.default_rng(3)
    tree = {"a": (rng.standard_normal((300, 7)) * 5).astype(np.float32),
            "b": {"c": rng.standard_normal(256).astype(np.float32),
                  "z": np.zeros(10, np.float32)}}
    jtree = jx.jax.tree.map(jx.jnp.asarray, tree)
    ttree = {"a": _t(tree["a"]), "b": {k: _t(v) for k, v in
                                       tree["b"].items()}}
    got, want = compress_grads(ttree), jx.optim.compress_grads(jtree)
    for key in ("a", "b/c", "b/z"):
        g = got
        w = want
        for part in key.split("/"):
            g, w = g[part], w[part]
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w[0]))
        np.testing.assert_array_equal(g[1].numpy(), np.asarray(w[1]))
    back = decompress_grads(got, ttree)
    jback = jx.optim.decompress_grads(want, jtree)
    np.testing.assert_array_equal(back["a"].numpy(), np.asarray(jback["a"]))
    assert compressed_bytes(ttree) == jx.optim.compressed_bytes(jtree)
    ef, jef = init_error_feedback(ttree), jx.optim.init_error_feedback(jtree)
    for _ in range(3):
        out, ef = ef_compress_cycle(ttree, ef)
        jout, jef = jx.optim.ef_compress_cycle(jtree, jef)
        for key in ("a", "b/c"):
            assert np.abs(_np(_flat(out)["/" + key]) - np.asarray(
                _flat(jout)["/" + key])).max() <= 1e-7
            assert np.abs(_np(_flat(ef)["/" + key]) - np.asarray(
                _flat(jef)["/" + key])).max() <= 1e-7


# ---------------------------------------------------------------------- #
# runtime (tests/test_substrate.py:180-247, on the port's checkpoints)
# ---------------------------------------------------------------------- #
def test_straggler_detector_flags_outlier():
    det = StragglerDetector(threshold_sigma=3.0, warmup=3)
    for i in range(20):
        det.observe(i, 1.0 + 0.01 * (i % 3))
    assert det.observe(20, 10.0) is True
    assert 20 in det.flagged


def test_elastic_mesh_replan():
    em = ElasticMesh(model_parallel=16)
    assert em.plan(512) == {"pod": 2, "data": 16, "model": 16,
                            "devices_used": 512, "devices_idle": 0}
    degraded = em.plan(480)
    assert degraded["devices_used"] <= 480 and degraded["model"] == 16
    assert em.rebatch(256, old_data=32, new_data=degraded["pod"]
                      * degraded["data"]) > 0
    with pytest.raises(RuntimeError):
        em.plan(8)


def test_supervisor_recovers_from_failures(tmp_path):
    sup = TrainSupervisor(CheckpointManager(str(tmp_path), keep=5),
                          save_every=2, max_restarts=5)
    fail_at = {5}

    def fail_hook(step):
        if step in fail_at:
            fail_at.discard(step)
            raise RuntimeError("simulated host failure")

    state, step = sup.run({"count": torch.tensor(0, dtype=torch.int32)},
                          lambda s, i: {"count": s["count"] + 1},
                          n_steps=10, fail_hook=fail_hook)
    assert step == 10 and sup.restarts == 1
    assert int(state["count"]) >= 10


def test_supervisor_restarts_through_async_save_failure(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    real_write = mgr._write
    armed = {"on": True}

    def flaky_write(step, state, meta):
        if step == 4 and armed["on"]:
            armed["on"] = False
            raise OSError("simulated disk failure")
        real_write(step, state, meta)

    mgr._write = flaky_write
    sup = TrainSupervisor(mgr, save_every=2, max_restarts=5,
                          save_blocking=False)
    state, step = sup.run({"count": torch.tensor(0, dtype=torch.int32)},
                          lambda s, i: {"count": s["count"] + 1},
                          n_steps=8)
    assert step == 8 and sup.restarts == 1
    assert int(state["count"]) >= 8
    assert mgr.latest_step() == 8


# ---------------------------------------------------------------------- #
# gradients of the kernels' paths against jax.vjp of the JAX package's
# ---------------------------------------------------------------------- #
# tests/test_kernels.py::FA_CASES, plus one past CHUNK_THRESHOLD (the
# chunked path on both sides)
FA_CASES = [
    (2, 128, 128, 4, 2, 64, True, None, None, "float32"),
    (1, 256, 256, 8, 1, 64, True, 64, None, "float32"),
    (2, 64, 64, 4, 4, 128, True, None, 50.0, "float32"),
    (1, 100, 100, 2, 2, 64, False, None, None, "float32"),
    (1, 192, 320, 4, 2, 64, True, None, None, "float32"),
    (2, 128, 128, 4, 2, 64, True, None, None, "bfloat16"),
    (1, 128, 128, 6, 3, 32, True, 32, 30.0, "float32"),
]
CHUNKED_CASE = (1, 16, 1100, 2, 1, 16, True, 600, 20.0, "float32")


def _fa_inputs(case, seed=0):
    B, Sq, Sk, Hq, Hkv, D = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
             (B, Sq, Hq, D))]


@pytest.mark.parametrize("entry", ["flash_attention", "ops.attention"])
@pytest.mark.parametrize("case", FA_CASES + [CHUNKED_CASE])
def test_attention_gradients_match_jax(case, entry, jx):
    causal, window, cap, dt = case[6:]
    q, k, v, dout = _fa_inputs(case)
    q_offset = case[2] - case[1] if case is CHUNKED_CASE else 0
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset)
    jd = getattr(jx.jnp, dt)
    jfn = (jx.ops.attention if entry == "ops.attention"
           else jx.ref.attention_ref)
    _, vjp = jx.jax.vjp(lambda a, b, c: jfn(a, b, c, **kw),
                        *(jx.jnp.asarray(x, jd) for x in (q, k, v)))
    want = vjp(jx.jnp.asarray(dout, jd))
    tq, tk, tv = (_t(x, dt).requires_grad_(True) for x in (q, k, v))
    fn = ops.attention if entry == "ops.attention" else fa.flash_attention
    before = (fa.launches, fa.launches_bwd)
    out = fn(tq, tk, tv, **kw)
    out.backward(_t(dout, dt))
    assert (fa.launches, fa.launches_bwd) == before
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == getattr(torch, dt)
        assert _scaled_err(got, w) < GRAD_TOL[dt], case


RGLRU_CASES = [(2, 64, 128, "float32"), (1, 33, 96, "float32"),
               (2, 64, 128, "bfloat16")]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,D,dt", RGLRU_CASES)
def test_rglru_gradients_match_jax(B, S, D, dt, with_h0, jx):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    a = rng.uniform(0.05, 0.99, (B, S, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    dh = rng.standard_normal((B, S, D)).astype(np.float32)
    dlast = rng.standard_normal((B, D)).astype(np.float32)
    jd = getattr(jx.jnp, dt)
    ins = [x, a] + ([h0] if with_h0 else [])
    jins = [jx.jnp.asarray(t, jd if i < 2 else jx.jnp.float32)
            for i, t in enumerate(ins)]

    def jfn(*t):
        return jx.ops.rglru(t[0], t[1], t[2] if with_h0 else None)

    _, vjp = jx.jax.vjp(jfn, *jins)
    want = vjp((jx.jnp.asarray(dh, jd), jx.jnp.asarray(dlast, jd)))
    tins = [_t(t, dt if i < 2 else "float32").requires_grad_(True)
            for i, t in enumerate(ins)]
    h, last = rglru.rglru_scan(*tins) if with_h0 else \
        rglru.rglru_scan(tins[0], tins[1])
    torch.autograd.backward((h, last), (_t(dh, dt), _t(dlast, dt)))
    for got, w in zip((t.grad for t in tins), want):
        assert _scaled_err(got, w) < GRAD_TOL[dt], (B, S, D, dt)


def test_backward_plain_versions_are_the_autograd_of_the_plain_forward():
    """flash_attention_bwd_plain and rglru_bwd_plain (what the card tests
    and chip_smoke.py hold the backward kernels to) give the gradients
    that autograd of the plain forward gives."""
    case = (1, 40, 40, 4, 2, 16, True, 9, 30.0, "float32")
    q, k, v, dout = (_t(x) for x in _fa_inputs(case))
    kw = dict(causal=True, window=9, softcap=30.0)
    got = fa.flash_attention_bwd_plain(q, k, v, dout, **kw)
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fa.flash_attention(*qkv, **kw).backward(dout)
    for g, x in zip(got, qkv):
        assert torch.equal(g, x.grad)
    x, a = torch.randn(2, 9, 8), torch.rand(2, 9, 8)
    h0, dh, dl = torch.randn(2, 8), torch.randn(2, 9, 8), torch.randn(2, 8)
    for init in (None, h0):
        got = rglru.rglru_bwd_plain(x, a, init, dh, dl)
        ins = [t.clone().requires_grad_(True) for t in (x, a)] + (
            [init.clone().requires_grad_(True)] if init is not None else [])
        hh, ll = rglru.rglru_scan(*ins)
        torch.autograd.backward((hh, ll), (dh, dl))
        for g, t in zip(got, ins):
            assert torch.equal(g, t.grad)
        assert (got[2] is None) == (init is None)


# ---------------------------------------------------------------------- #
# loss_fn and make_train_step on reduced configs with carried weights
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def carried(jx):
    """name -> (JAX cfg, JAX params, port cfg)."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg = jx.reduced(jx.ARCHS[name])
            params = jx.models.init_params(jcfg, jx.jax.random.PRNGKey(0))
            cache[name] = (jcfg, params, reduced_config(get_config(name)))
        return cache[name]

    return get


def _port_model(jx, cfg, params):
    tree = jx.jax.tree.map(np.asarray, params)
    return models.from_jax_params(cfg, tree, device="cpu").requires_grad_(
        True)


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("name", LOSS_ARCHS)
def test_loss_fn_and_its_gradients_match_jax(name, carried, jx):
    jcfg, params, cfg = carried(name)
    toks = _tokens(cfg.vocab_size, (2, 12))
    jloss, jgrads = jx.jax.value_and_grad(
        lambda p: jx.models.loss_fn(jcfg, p, {"tokens": jx.jnp.asarray(
            toks)}))(params)
    model = _port_model(jx, cfg, params)
    batch = {"tokens": torch.as_tensor(toks)}
    loss = models.loss_fn(model, batch)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-4 * max(1.0, abs(
        float(jloss)))
    tree = models.param_tree(model)
    grads = torch.autograd.grad(loss, tree_leaves(tree))
    it = iter(grads)
    gtree = models.to_jax_tree(cfg, tree_map(lambda p: next(it), tree))
    want = _flat(jx.jax.tree.map(np.asarray, jgrads))
    got = _flat(gtree)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert _scaled_err(got[key], want[key]) < 1e-4, (name, key)
    loss_r = models.loss_fn(model, batch, remat=True)
    grads_r = torch.autograd.grad(loss_r, tree_leaves(tree))
    assert abs(float(loss_r.detach()) - float(loss.detach())) <= 1e-6
    for a, b in zip(grads, grads_r):
        assert float((a - b).abs().max()) <= 1e-6


def test_loss_fn_raises_for_blocks_outside_the_slice(carried, jx):
    """seamless-m4t-large-v2 trains through its encoder: `loss_fn` on a
    batch with frame embeddings and every gradient leaf, the encoder's
    and the cross attentions' included, against the JAX package's, with
    and without remat (deepseek-v3's MLA and MTP head are held in
    tests/test_torch_mla.py)."""
    jcfg, params, cfg = carried("seamless-m4t-large-v2")
    toks = _tokens(cfg.vocab_size, (2, 12))
    frames = np.random.default_rng(1).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    jloss, jgrads = jx.jax.value_and_grad(
        lambda p: jx.models.loss_fn(jcfg, p, {
            "tokens": jx.jnp.asarray(toks),
            "frame_embeds": jx.jnp.asarray(frames)}))(params)
    model = _port_model(jx, cfg, params)
    batch = {"tokens": torch.as_tensor(toks),
             "frame_embeds": torch.as_tensor(frames)}
    tree = models.param_tree(model)
    want = _flat(jx.jax.tree.map(np.asarray, jgrads))
    losses = []
    for remat in (False, True):
        loss = models.loss_fn(model, batch, remat=remat)
        assert abs(float(loss.detach()) - float(jloss)) <= 1e-4 * max(
            1.0, abs(float(jloss)))
        grads = torch.autograd.grad(loss, tree_leaves(tree))
        it = iter(grads)
        got = _flat(models.to_jax_tree(cfg, tree_map(lambda p: next(it),
                                                     tree)))
        assert got.keys() == want.keys()
        assert any(k.startswith("/encoder") for k in got)
        for key in want:
            assert _scaled_err(got[key], want[key]) < 1e-4, (remat, key)
        losses.append(float(loss.detach()))
    assert abs(losses[1] - losses[0]) <= 1e-6


@pytest.mark.parametrize("n_micro,accum", [
    (1, "float32"), (2, "float32"), (1, "bfloat16"), (2, "bfloat16")])
def test_make_train_step_matches_jax(n_micro, accum, carried, jx):
    _train_step_matches_jax("smollm-360m", n_micro, accum, carried, jx)


@pytest.mark.parametrize("n_micro,accum", [(2, "float32"), (1, "bfloat16")])
def test_make_train_step_matches_jax_for_rwkv6(n_micro, accum, carried, jx):
    """rwkv6-7b reduced: the RWKV6 scan's gradient through the chunked
    form on both sides (impl="auto" on the CPU)."""
    _train_step_matches_jax("rwkv6-7b", n_micro, accum, carried, jx)


def test_make_train_step_matches_jax_for_dbrx(carried, jx):
    """dbrx-132b reduced: the MoE layer's gradients (the router's through
    the renormalised top-k probabilities and the aux loss, tokens dropped
    by capacity) inside the step."""
    _train_step_matches_jax("dbrx-132b", 2, "float32", carried, jx)


def _f64(tree, jx):
    return jx.jax.tree.map(
        lambda p: jx.jnp.asarray(np.asarray(p, np.float64)), tree)


def _float32_aux(jx, jcfg):
    """Under x64 the JAX package's MoE aux loss comes out float64 (its
    `one_hot` takes the default float type), which its layer scan's
    float32 carry refuses; cast it to the float32 it has in the package's
    own runs.  Its router softmax is float32 in either mode."""
    if not jcfg.is_moe:
        return contextlib.nullcontext()
    moe = jx.models.moe.MoE
    aux_loss = moe.aux_loss
    return mock.patch.object(moe, "aux_loss", staticmethod(
        lambda p, cfg, x: aux_loss(p, cfg, x).astype(jx.jnp.float32)))


def _exact_step(jx, jcfg, jopt_cfg, jpar, accum, params, opt, toks):
    """The train step evaluated from float64 gradients, from one package's
    own params and optimizer state before the step: (params after it,
    metrics, the float64 gradient of the step's loss), every leaf float64.
    The JAX package's step, un-jitted under x64, the accumulator float64
    (bfloat16 for a bfloat16 accumulator, whose rounding is part of the
    step)."""
    with jx.jax.enable_x64(True), _float32_aux(jx, jcfg):
        acc = jx.jnp.bfloat16 if accum == "bfloat16" else jx.jnp.float64
        step = jx.steps.make_train_step(jcfg, jopt_cfg, jpar,
                                        accum_dtype=acc)
        p64 = _f64(params, jx)
        o64 = {"m": _f64(opt["m"], jx), "v": _f64(opt["v"], jx),
               "step": jx.jnp.asarray(np.asarray(opt["step"]))}
        batch = {"tokens": jx.jnp.asarray(toks)}
        new_p, _, metrics = step(p64, o64, batch)
        micro = toks.reshape(jpar.microbatches, -1, toks.shape[-1])
        g = jx.jax.grad(lambda p: sum(jx.models.loss_fn(
            jcfg, p, {"tokens": jx.jnp.asarray(t)}) for t in micro)
            / len(micro))(p64)
        return (_flat(jx.jax.tree.map(np.asarray, new_p)),
                {k: float(v) for k, v in metrics.items()},
                _flat(jx.jax.tree.map(np.asarray, g)))


def _grad_norm_tol(accum, metrics, g):
    """1e-5 of the float64 grad_norm, and with a bfloat16 accumulator one
    rounding step of the largest gradient entry besides: an entry whose
    float64 value lies within float32 error of a bfloat16 tie rounds
    either way, and a step of 2^-7·|g| there moves the norm by up to
    2^-7·max|g|^2 / grad_norm."""
    gn = metrics["grad_norm"]
    tol = 1e-5 * gn
    if accum == "bfloat16":
        gmax = max(float(np.abs(v).max()) for v in g.values())
        tol += 2.0 ** -7 * gmax ** 2 / gn
    return tol


def _train_step_matches_jax(name, n_micro, accum, carried, jx):
    """Both packages' steps against the step evaluated from float64
    gradients at each package's own state before the step: the port's
    float32 step and the JAX package's jitted one are held to the same
    bounds (the two differ from each other by more than either differs
    from float64, since XLA's CPU fusion moves the JAX step's float32
    sums by host), and their moments to each other."""
    jcfg, params, cfg = carried(name)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    opt_cfg = AdamWConfig(**kw)
    jopt_cfg = jx.optim.AdamWConfig(**kw)
    par = ParallelConfig(microbatches=n_micro)
    jpar = jx.Par(microbatches=n_micro)
    step = make_train_step(cfg, opt_cfg, par,
                           accum_dtype=getattr(torch, accum))
    jstep = jx.jax.jit(jx.steps.make_train_step(
        jcfg, jopt_cfg, jpar, accum_dtype=getattr(jx.jnp, accum)))
    model = _port_model(jx, cfg, params)
    opt = adamw_init(models.param_tree(model), opt_cfg)
    jparams, jopt = params, jx.optim.adamw_init(params, jopt_cfg)
    shape = (n_micro, 4 // n_micro, 16) if n_micro > 1 else (4, 16)
    for i in range(2):
        toks = _tokens(cfg.vocab_size, shape, seed=i)
        port_before = (models.to_jax_params(model), {
            "m": models.to_jax_tree(cfg, opt["m"]),
            "v": models.to_jax_tree(cfg, opt["v"]), "step": opt["step"]})
        exact = {
            "port": _exact_step(jx, jcfg, jopt_cfg, jpar, accum,
                                *port_before, toks),
            "jax": _exact_step(jx, jcfg, jopt_cfg, jpar, accum, jparams,
                               jopt, toks)}
        jparams, jopt, jm = jstep(jparams, jopt,
                                  {"tokens": jx.jnp.asarray(toks)})
        model, opt, m = step(model, opt, {"tokens": torch.as_tensor(toks)})
        after = {"port": (_flat(models.to_jax_params(model)), m),
                 "jax": (_flat(jx.jax.tree.map(np.asarray, jparams)), jm)}
        assert float(m["lr"]) == float(jm["lr"]), i
        lr = float(jm["lr"])
        for who, (got_p, got_m) in after.items():
            want_p, want_m, g = exact[who]
            assert float(got_m["lr"]) == want_m["lr"], (i, who)
            assert abs(float(got_m["loss"]) - want_m["loss"]) <= 1e-5 * abs(
                want_m["loss"]), (i, who)
            assert abs(float(got_m["grad_norm"]) - want_m["grad_norm"]) <= (
                _grad_norm_tol(accum, want_m, g)), (i, who)
            for key, want in want_p.items():
                diff = np.abs(got_p[key].astype(np.float64) - want)
                assert diff.max() <= 2.2 * lr, (i, who, key, diff.max())
                big = np.abs(g[key]) > 1e-3 * np.abs(g[key]).max()
                assert diff[big].max(initial=0.0) <= 1e-5, (i, who, key)
    got_m = _flat(models.to_jax_tree(cfg, opt["m"]))
    want_m = _flat(jx.jax.tree.map(np.asarray, jopt["m"]))
    for key in want_m:
        assert _scaled_err(got_m[key], want_m[key]) <= 1e-4, key
    assert int(opt["step"]) == int(jopt["step"]) == 2


# ---------------------------------------------------------------------- #
# the launcher, and checkpoints both packages resume from
# ---------------------------------------------------------------------- #
TRAIN_ARGS = ["--arch", "smollm-360m", "--reduced", "--batch", "4",
              "--seq", "32", "--log-every", "1"]


def _run(main, argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_launcher_trains_flags_stragglers_and_resumes(tmp_path, monkeypatch):
    class Flagging(StragglerDetector):
        def observe(self, step, dt):
            super().observe(step, dt)
            return step == 3

    monkeypatch.setattr(train_mod, "StragglerDetector", Flagging)
    ck = str(tmp_path / "ck")
    out = _run(train_mod.main, TRAIN_ARGS + [
        "--steps", "30", "--lr", "3e-3", "--device", "cpu",
        "--ckpt-dir", ck, "--save-every", "10"])
    assert "(improved)" in out
    assert "step     3 " in out and out.count("[straggler]") == 1
    assert CheckpointManager(ck).latest_step() == 30
    out = _run(train_mod.main, TRAIN_ARGS + [
        "--steps", "32", "--device", "cpu", "--ckpt-dir", ck,
        "--microbatches", "2"])
    assert "resumed from step 30" in out and "step    31 " in out


def test_launcher_trains_rwkv6_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    args = ["--arch", "rwkv6-7b", "--reduced", "--batch", "4", "--seq",
            "32", "--log-every", "1", "--device", "cpu", "--ckpt-dir", ck]
    out = _run(train_mod.main, args + ["--steps", "4"])
    assert "arch=rwkv6-7b-reduced" in out and "step     3 " in out
    assert "resumed" not in out
    assert CheckpointManager(ck).latest_step() == 4
    out = _run(train_mod.main, args + ["--steps", "6", "--microbatches",
                                       "2"])
    assert "resumed from step 4" in out and "step     5 " in out
    assert CheckpointManager(ck).latest_step() == 6


def test_launcher_asks_for_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train_mod.main(TRAIN_ARGS + ["--steps", "1"])


def _jax_train_main(jx, argv):
    from repro.launch import train as jtrain
    old = sys.argv
    sys.argv = ["repro.launch.train"] + argv
    try:
        buf = io.StringIO()
        with redirect_stdout(buf):
            jtrain.main()
        return buf.getvalue()
    finally:
        sys.argv = old


def _restored(jx, ck, jcfg, cfg):
    """The directory's latest (params, opt_state), read by the JAX
    package's store and by the port's, both in the JAX layout."""
    params = jx.models.init_params(jcfg, jx.jax.random.PRNGKey(0))
    opt = jx.optim.adamw_init(params, jx.optim.AdamWConfig())
    jstate, _ = jx.Ckpt(ck).restore((params, opt))
    model = models.Model(cfg, device="cpu")
    topt = adamw_init(models.param_tree(model), AdamWConfig())
    tstate, _ = CheckpointManager(ck).restore(
        train_mod.train_state_to_jax(model, topt))
    return (_flat({"p": jx.jax.tree.map(np.asarray, jstate[0]),
                   "o": jx.jax.tree.map(np.asarray, jstate[1])}),
            _flat({"p": tstate[0], "o": tstate[1]}))


@pytest.mark.parametrize("first", ["port", "jax"])
def test_checkpoints_move_between_the_packages(first, tmp_path, jx):
    """Each trainer resumes from the other's directory, and both stores
    read the same arrays from it."""
    _checkpoints_move("smollm-360m", first, tmp_path, jx)


@pytest.mark.parametrize("first", ["port", "jax"])
def test_rwkv6_checkpoints_move_between_the_packages(first, tmp_path, jx):
    """The same for rwkv6-7b reduced: every RWKV6 parameter group, its
    AdamW moments and the step, both ways."""
    _checkpoints_move("rwkv6-7b", first, tmp_path, jx)


def _checkpoints_move(arch, first, tmp_path, jx):
    ck = str(tmp_path / "ck")
    args = ["--arch", arch] + TRAIN_ARGS[2:] + ["--ckpt-dir", ck]
    port = lambda n: _run(train_mod.main, args + [  # noqa: E731
        "--steps", str(n), "--device", "cpu"])
    jax_ = lambda n: _jax_train_main(jx, args + ["--steps", str(n)])  # noqa
    (port if first == "port" else jax_)(2)
    jcfg = jx.reduced(jx.ARCHS[arch], vocab_size=4096)
    cfg = reduced_config(get_config(arch), vocab_size=4096)
    want, got = _restored(jx, ck, jcfg, cfg)
    assert want.keys() == got.keys()
    for key in want:
        assert want[key].dtype == got[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])
    out = (jax_ if first == "port" else port)(3)
    assert "resumed from step 2" in out and "step     2 " in out
    want, got = _restored(jx, ck, jcfg, cfg)
    assert int(got["/o/step"]) == 3
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


# ---------------------------------------------------------------------- #
# on the card: the train step through the forward and backward kernels
# ---------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("name", ["smollm-360m", "recurrentgemma-9b",
                                  "rwkv6-7b"])
def test_train_step_on_the_card_matches_the_cpu(name, cuda_device):
    """Two steps of make_train_step on the card (flash attention, RG-LRU
    and RWKV6 forward and backward kernels, one launch of each per layer
    of its kind and microbatch) against the same steps on the host (the
    plain versions): loss and grad_norm within 1e-4 relative."""
    cfg = reduced_config(get_config(name))
    host = models.Model(cfg, device="cpu")
    card = models.from_jax_params(cfg, models.to_jax_params(host))
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, opt_cfg, ParallelConfig(microbatches=2))
    opts = [adamw_init(models.param_tree(m.requires_grad_(True)), opt_cfg)
            for m in (host, card)]
    n_attn = sum(k not in ("rec", "rwkv") for k in card.kinds)
    n_rec = card.kinds.count("rec")
    n_rwkv = card.kinds.count("rwkv")
    for i in range(2):
        toks = torch.as_tensor(_tokens(cfg.vocab_size, (2, 2, 64), seed=i))
        _, _, hm = step(host, opts[0], {"tokens": toks})
        fa.launches = fa.launches_bwd = 0
        rglru.launches = rglru.launches_bwd = 0
        rwkv6.launches = rwkv6.launches_bwd = 0
        _, _, cm = step(card, opts[1], {"tokens": toks.to(cuda_device)})
        torch.cuda.synchronize()
        assert (fa.launches, fa.launches_bwd) == (2 * n_attn, 2 * n_attn)
        assert (rglru.launches, rglru.launches_bwd) == (2 * n_rec,
                                                        2 * n_rec)
        assert (rwkv6.launches, rwkv6.launches_bwd) == (2 * n_rwkv,
                                                        2 * n_rwkv)
        for key in ("loss", "grad_norm"):
            assert abs(float(cm[key]) - float(hm[key])) <= 1e-4 * abs(
                float(hm[key])), (name, i, key)


@pytest.mark.cuda
def test_rwkv6_loss_fn_with_remat_on_the_card(cuda_device):
    """remat=True on the card: each layer's forward kernel runs again in
    the backward (two forward launches a layer, one backward), and the
    loss and gradients are the run's without remat, to 1e-6 as on the
    CPU."""
    cfg = reduced_config(get_config("rwkv6-7b"))
    model = models.from_jax_params(cfg, models.to_jax_params(
        models.Model(cfg, device="cpu"))).requires_grad_(True)
    batch = {"tokens": torch.as_tensor(_tokens(cfg.vocab_size, (2, 40)),
                                       device=cuda_device)}
    leaves = tree_leaves(models.param_tree(model))
    runs = []
    for remat in (False, True):
        rwkv6.launches = rwkv6.launches_bwd = 0
        loss = models.loss_fn(model, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        n = cfg.n_layers
        assert (rwkv6.launches, rwkv6.launches_bwd) == (
            (2 * n if remat else n), n)
        runs.append((loss.detach(), grads))
    assert abs(float(runs[0][0]) - float(runs[1][0])) <= 1e-6
    for a, b in zip(runs[0][1], runs[1][1]):
        assert float((a - b).abs().max()) <= 1e-6
