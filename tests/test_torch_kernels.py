"""The port's attention and RG-LRU kernels against the JAX package's.

On the CPU the port's wrappers run their plain versions; they are held
against the JAX package's Pallas kernels in interpret mode (as
`tests/test_kernels.py` runs them) on the same numpy inputs, at the
tolerances of `tests/test_kernels.py`.  The tests marked `cuda` hold each
CUDA kernel against its plain version on the card and skip without one.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, rglru  # noqa: E402
from repro_torch.kernels.ref import attention_ref, rglru_ref  # noqa: E402

# (B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, dtype): the cases of
# tests/test_kernels.py::FA_CASES
FA_CASES = [
    (2, 128, 128, 4, 2, 64, True, None, None, "float32"),
    (1, 256, 256, 8, 1, 64, True, 64, None, "float32"),     # MQA + window
    (2, 64, 64, 4, 4, 128, True, None, 50.0, "float32"),    # softcap
    (1, 100, 100, 2, 2, 64, False, None, None, "float32"),  # non-divisible
    (1, 192, 320, 4, 2, 64, True, None, None, "float32"),   # Sq != Sk
    (2, 128, 128, 4, 2, 64, True, None, None, "bfloat16"),
    (1, 128, 128, 6, 3, 32, True, 32, 30.0, "float32"),     # all features
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(case, seed=0):
    B, Sq, Sk, Hq, Hkv, D = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32))


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernels and oracles.  Imported here, not at the
    top, so the tests marked `cuda` also run where JAX is not installed."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref
    from repro.kernels.flash_attention import flash_attention
    from repro.kernels.rglru import rglru_scan
    return types.SimpleNamespace(
        ref=ref, flash=flash_attention, rglru=rglru_scan,
        a=lambda x, dt="float32": jnp.asarray(x, getattr(jnp, dt)))


def _t(a, dtype="float32", device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x.astype("float32"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


# ---------------------------------------------------------------------- #
# flash attention, CPU: the port against the Pallas kernel
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_matches_pallas(case, jx):
    causal, window, cap, dt = case[6:]
    q, k, v = _qkv(case)
    want = jx.flash(jx.a(q, dt), jx.a(k, dt), jx.a(v, dt), causal=causal,
                    window=window, softcap=cap, block_q=64, block_k=64,
                    interpret=True)
    before = fa.launches
    got = fa.flash_attention(_t(q, dt), _t(k, dt), _t(v, dt), causal=causal,
                             window=window, softcap=cap)
    assert fa.launches == before     # a CPU tensor runs the plain version
    assert got.dtype == getattr(torch, dt) and got.shape == q.shape
    assert np.abs(_np(got) - _np(want)).max() < TOL[dt], case


@pytest.mark.parametrize("q_offset,kv_len", [(900, 1000), (0, None)])
def test_attention_ref_matches_jax_ref(q_offset, kv_len, jx):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 4, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 1100, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 1100, 2, 32)).astype(np.float32)
    want = jx.ref.attention_ref(jx.a(q), jx.a(k), jx.a(v), causal=True,
                                window=512, softcap=20.0, q_offset=q_offset,
                                kv_len=kv_len)
    got = attention_ref(_t(q), _t(k), _t(v), causal=True, window=512,
                        softcap=20.0, q_offset=q_offset, kv_len=kv_len)
    assert np.abs(_np(got) - _np(want)).max() < 1e-5


def test_chunked_attention_vs_ref_decode_path():
    """Dynamic q_offset (a tensor) and kv_len go to the chunked path."""
    rng = np.random.default_rng(1)
    q = _t(rng.standard_normal((2, 4, 4, 32)).astype(np.float32))
    k = _t(rng.standard_normal((2, 1500, 2, 32)).astype(np.float32))
    v = _t(rng.standard_normal((2, 1500, 2, 32)).astype(np.float32))
    kv_len = torch.tensor(1000)
    want = attention_ref(q, k, v, causal=True, q_offset=900, kv_len=kv_len)
    before = fa.launches
    for impl in ("chunked", "cuda"):
        got = ops.attention(q, k, v, causal=True,
                            q_offset=torch.tensor(900), kv_len=kv_len,
                            impl=impl)
        assert float((got - want).abs().max()) < 1e-5, impl
    assert fa.launches == before


def test_chunked_attention_mla_head_dims():
    """Distinct qk and v head dims, as MLA has (192 vs 128)."""
    rng = np.random.default_rng(2)
    q = _t(rng.standard_normal((1, 80, 4, 24)).astype(np.float32))
    k = _t(rng.standard_normal((1, 80, 4, 24)).astype(np.float32))
    v = _t(rng.standard_normal((1, 80, 4, 16)).astype(np.float32))
    want = attention_ref(q, k, v, causal=True, scale=24 ** -0.5)
    got = ops.attention(q, k, v, causal=True, scale=24 ** -0.5,
                        impl="chunked")
    assert float((got - want).abs().max()) < 1e-5


@pytest.mark.parametrize("Sk,picked", [(128, "ref"), (1500, "chunked")])
def test_auto_on_the_cpu_keeps_the_jax_choice(monkeypatch, Sk, picked):
    calls = []
    monkeypatch.setattr(ops, "_attention_chunked",
                        lambda *a, **kw: calls.append("chunked"))
    monkeypatch.setattr(ops._ref, "attention_ref",
                        lambda *a, **kw: calls.append("ref"))
    monkeypatch.setattr(ops, "_flash", lambda *a, **kw: calls.append("cuda"))
    q = torch.zeros((1, 4, 2, 16))
    k = torch.zeros((1, Sk, 2, 16))
    ops.attention(q, k, k)
    ops.attention(q, k, k, impl="cuda")
    ops.attention(q, k, k, impl="cuda", kv_len=3)
    assert calls == [picked, "cuda", "chunked"]


def test_static_q_offset_reaches_the_kernel_path():
    """The JAX package's kernel path drops a static q_offset; the port's
    passes it on, so it agrees with the reference at any offset."""
    rng = np.random.default_rng(3)
    q = _t(rng.standard_normal((1, 8, 2, 16)).astype(np.float32))
    k = _t(rng.standard_normal((1, 40, 1, 16)).astype(np.float32))
    v = _t(rng.standard_normal((1, 40, 1, 16)).astype(np.float32))
    want = attention_ref(q, k, v, causal=True, window=16, q_offset=30)
    got = ops.attention(q, k, v, causal=True, window=16, q_offset=30,
                        impl="cuda")
    assert float((got - want).abs().max()) < 1e-6


def test_flash_attention_rejects_what_the_kernel_cannot_take():
    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="Hq=3"):
        fa.flash_attention(torch.zeros((1, 4, 3, 16)), q, q)
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_attention(q, q.double(), q)
    with pytest.raises(TypeError, match="static int q_offset"):
        fa.flash_attention(q, q, q, q_offset=torch.tensor(1))
    with pytest.raises(ValueError, match="shapes"):
        fa.flash_attention(q, torch.zeros((1, 4, 2, 8)), q)


# ---------------------------------------------------------------------- #
# RG-LRU, CPU: the port against the Pallas kernel
# ---------------------------------------------------------------------- #
RGLRU_CASES = [
    (2, 64, 128, 64, "float32"),
    (1, 33, 96, 128, "float32"),       # non-divisible feature block
    (2, 64, 128, 64, "bfloat16"),
]


def _xa(B, S, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, D)).astype(np.float32),
            rng.uniform(0.05, 0.99, (B, S, D)).astype(np.float32))


@pytest.mark.parametrize("B,S,D,bd,dt", RGLRU_CASES)
def test_rglru_matches_pallas(B, S, D, bd, dt, jx):
    x, a = _xa(B, S, D)
    want_h, want_last = jx.rglru(jx.a(x, dt), jx.a(a, dt), block_d=bd,
                                  interpret=True)
    before = rglru.launches
    h, last = rglru.rglru_scan(_t(x, dt), _t(a, dt))
    assert rglru.launches == before
    assert h.dtype == getattr(torch, dt) and last.shape == (B, D)
    tol = 1e-5 if dt == "float32" else 3e-2
    assert np.abs(_np(h) - _np(want_h)).max() < tol
    assert np.abs(_np(last) - _np(want_last)).max() < tol


def test_rglru_h0_matches_pallas(jx):
    x, a = _xa(2, 40, 96, seed=4)
    h0 = np.random.default_rng(5).standard_normal((2, 96)).astype(np.float32)
    want_h, want_last = jx.rglru(jx.a(x), jx.a(a), jx.a(h0), interpret=True)
    h, last = rglru.rglru_scan(_t(x), _t(a), _t(h0))
    assert np.abs(_np(h) - _np(want_h)).max() < 1e-5
    assert np.abs(_np(last) - _np(want_last)).max() < 1e-5


def test_rglru_carries_state():
    x, a = _xa(1, 16, 8, seed=1)
    x, a = _t(x), _t(a)
    full, last = rglru.rglru_scan(x, a)
    h1, s1 = rglru.rglru_scan(x[:, :8], a[:, :8])
    h2, s2 = rglru.rglru_scan(x[:, 8:], a[:, 8:], s1)
    np.testing.assert_allclose(_np(full), np.concatenate(
        [_np(h1), _np(h2)], axis=1), atol=1e-6)
    np.testing.assert_allclose(_np(last), _np(s2), atol=1e-6)


def test_rglru_ref_matches_jax_ref(jx):
    x, a = _xa(2, 24, 16, seed=6)
    want_h, want_last = jx.ref.rglru_ref(jx.a(x), jx.a(a))
    h, last = rglru_ref(_t(x), _t(a))
    assert np.abs(_np(h) - _np(want_h)).max() < 1e-6
    assert np.abs(_np(last) - _np(want_last)).max() < 1e-6


def test_rwkv6_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*item 4"):
        ops.rwkv6(*[torch.zeros(1)] * 5)


# ---------------------------------------------------------------------- #
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_CASES + [
    (1, 300, 300, 16, 1, 256, True, 128, None, "float32"),
    (1, 70, 70, 4, 1, 16, True, None, None, "float32"),
])
def test_flash_attention_kernel_matches_plain(case, cuda_device):
    causal, window, cap, dt = case[6:]
    q, k, v = (_t(a, dt, cuda_device) for a in _qkv(case))
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             softcap=cap)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    softcap=cap)
    assert got.device.type == "cuda" and got.dtype == q.dtype
    assert float((got.float() - want.float()).abs().max()) < TOL[dt], case


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,bd,dt", RGLRU_CASES + [
    (2, 300, 4096, 128, "float32")])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_kernel_matches_plain(B, S, D, bd, dt, with_h0, cuda_device):
    x, a = (_t(t, dt, cuda_device) for t in _xa(B, S, D))
    h0 = torch.randn((B, D), device=cuda_device) if with_h0 else None
    before = rglru.launches
    h, last = rglru.rglru_scan(x, a, h0)
    torch.cuda.synchronize()
    assert rglru.launches == before + 1
    want_h, want_last = rglru.rglru_plain(x, a, h0)
    tol = 1e-5 if dt == "float32" else 3e-2
    assert float((h.float() - want_h.float()).abs().max()) < tol
    assert float((last.float() - want_last.float()).abs().max()) < tol
