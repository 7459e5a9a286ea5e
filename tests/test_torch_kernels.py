"""The port's attention, RG-LRU and RWKV6 kernels against the JAX package's.

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
from repro_torch.kernels import ops, rglru, rwkv6  # noqa: E402
from repro_torch.kernels.ref import (attention_ref, rglru_ref,  # noqa: E402
                                     rwkv6_chunked, rwkv6_ref)

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
    import jax
    from repro.kernels import ops as jops
    from repro.kernels import ref
    from repro.kernels.flash_attention import flash_attention
    from repro.kernels.rglru import rglru_scan
    from repro.kernels.rwkv6 import rwkv6_scan
    return types.SimpleNamespace(
        jax=jax, ops=jops, ref=ref, flash=flash_attention, rglru=rglru_scan,
        rwkv6=rwkv6_scan,
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


def _attention_np(q, k, v, causal, window, softcap, q_offset):
    """Attention in float64 numpy: what attention_ref's float64 path must
    compute (scale D^-0.5, GQA, softcap, the -1e30 mask, softmax)."""
    Sq, Sk = q.shape[1], k.shape[1]
    groups = q.shape[2] // k.shape[2]
    kk = np.repeat(k, groups, axis=2)
    vv = np.repeat(v, groups, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q * q.shape[3] ** -0.5, kk)
    if softcap is not None:
        s = np.tanh(s / softcap) * softcap
    pos = np.arange(Sq)[:, None] + q_offset
    kp = np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= kp <= pos
    if window is not None:
        ok &= kp > pos - window
    s = np.where(ok, s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, vv)


# (B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, q_offset)
ATTN_F64_CASES = [
    (2, 33, 33, 4, 2, 16, True, None, None, 0),
    (1, 40, 72, 6, 3, 32, True, 16, 30.0, 32),
    (1, 20, 9, 16, 1, 64, False, None, None, 0),
]


@pytest.mark.parametrize("case", ATTN_F64_CASES)
def test_attention_ref_computes_float64_inputs_in_float64(case):
    """Float64 inputs are computed in float64 (the backward checks' float64
    reference); the same inputs in float32 miss the float64 result by far
    more than float64 rounding."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, cap, off = case
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s) for s in (
        (B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    want = _attention_np(q, k, v, causal, window, cap, off)
    got = attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - want).max() < 1e-12
    got32 = attention_ref(*(torch.from_numpy(x).float() for x in (q, k, v)),
                          **kw)
    assert got32.dtype == torch.float32
    assert np.abs(got32.double().numpy() - want).max() > 1e-10


@pytest.mark.parametrize("case", [c for c in FA_CASES if c[-1] == "float32"])
def test_attention_ref_float32_inputs_still_match_jax_ref(case, jx):
    causal, window, cap, _ = case[6:]
    q, k, v = _qkv(case)
    want = jx.ref.attention_ref(jx.a(q), jx.a(k), jx.a(v), causal=causal,
                                window=window, softcap=cap)
    got = attention_ref(_t(q), _t(k), _t(v), causal=causal, window=window,
                        softcap=cap)
    assert got.dtype == torch.float32
    assert np.abs(_np(got) - _np(want)).max() < 1e-6, case


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
# flash attention, CPU: the split-TF32 arithmetic of the float32 kernel
# ---------------------------------------------------------------------- #
def _tf32_rna(x):
    """`cvt.rna.tf32.f32` on float32 bits: round the magnitude to 10
    mantissa bits, ties away from zero (finite inputs)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(
        np.float32)


def _tf32_rz(x):
    """What the tensor core reads of a float32 register given as a TF32
    operand: its top 19 bits, i.e. the value rounded toward zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xffffe000)).view(np.float32)


def _split_tf32(x, lo_round=_tf32_rna):
    hi = _tf32_rna(x)
    return hi, lo_round((x - hi).astype(np.float32))


def _mm_3xtf32(a, b, lo_round=_tf32_rna):
    """a @ b.T as the kernel's float32 path forms it: hi*hi + (hi*lo +
    lo*hi) with TF32 operands (their products are exact in float32) and
    float32 sums."""
    ah, al = _split_tf32(a, lo_round)
    bh, bl = _split_tf32(b, lo_round)
    return ah @ bh.T + (ah @ bl.T + al @ bh.T)


def _mm_1xtf32(a, b):
    return _tf32_rna(a) @ _tf32_rna(b).T


def test_tf32_rounding_is_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)            # TF32's at 1.0
    x = np.array([1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, -(1 + 2.0 ** -11),
                  1 + 2.0 ** -12, 1 + 2.0 ** -11 + 2.0 ** -20, 3.0],
                 np.float32)
    want = np.array([one + ulp, one + 2 * ulp, -(one + ulp), one,
                     one + ulp, 3.0], np.float32)
    np.testing.assert_array_equal(_tf32_rna(x), want)
    np.testing.assert_array_equal(
        _tf32_rz(x), np.array([one, one + ulp, -one, one, one, 3.0],
                              np.float32))
    hi, lo = _split_tf32(x)
    np.testing.assert_array_equal(hi.astype(np.float64) + lo, x)
    assert not (hi.view(np.uint32) & 0x1fff).any()
    assert not (lo.view(np.uint32) & 0x1fff).any()


@pytest.mark.parametrize("lo_round", ["nearest", "toward_zero"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_tf32_meets_the_float32_tolerance_where_tf32_does_not(
        seed, lo_round):
    """Attention at head_dim 256 over a 2,048-key window (the serving
    shape's), with both products (scores and P.V) on TF32 operands: the
    split form stays within FA_TOL["float32"] (2e-5) of a float64
    evaluation, one TF32 product per operand pair does not.  The kernel
    passes lo unrounded, which the tensor core reads rounded toward zero;
    rounding it to nearest is the textbook split."""
    rounding = {"nearest": _tf32_rna, "toward_zero": _tf32_rz}[lo_round]
    D, keys, rows = 256, 2048, 8
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((rows, D)).astype(np.float32)
    k = rng.standard_normal((keys, D)).astype(np.float32)
    v = rng.standard_normal((keys, D)).astype(np.float32)
    scale = np.float32(D ** -0.5)

    def attention(mm):
        s = mm(q, k) * scale
        p = np.exp(s - s.max(axis=1, keepdims=True)).astype(np.float32)
        return mm(p, v.T) / p.sum(axis=1, keepdims=True)

    s64 = q.astype(np.float64) @ k.T.astype(np.float64) * float(scale)
    p64 = np.exp(s64 - s64.max(axis=1, keepdims=True))
    want = p64 @ v / p64.sum(axis=1, keepdims=True)
    split_err = np.abs(attention(
        lambda a, b: _mm_3xtf32(a, b, rounding)) - want).max()
    single_err = np.abs(attention(_mm_1xtf32) - want).max()
    assert split_err < TOL["float32"] / 20, split_err
    assert single_err > TOL["float32"], single_err


# flash_attention.cu's float32 orders within each 8 of a contraction:
# Q's rows are stored d 0, 4, 1, 5, 2, 6, 3, 7 (two float4 of d 0..3 and
# 4..7 interleaved); an A register of k index t is read at position 2t,
# of t + 4 at 2t + 1; S's accumulator holds keys 2t, 2t + 1 at k index t,
# t + 4 of P's A fragment; a thread of the V split writes keys p, p + 2,
# p + 4, p + 6 at positions 4p .. 4p + 3 of V^T's row
_Q_D_OF_POS = np.array([0, 4, 1, 5, 2, 6, 3, 7])
_A_POS_OF_K = np.array([2 * t for t in range(4)] + [2 * t + 1
                                                   for t in range(4)])
_P_KEY_OF_K = np.array([2 * t for t in range(4)] + [2 * t + 1
                                                   for t in range(4)])
_VT_KEY_OF_POS = np.array([p + 2 * j for p in (0, 1) for j in range(4)])


def _gather8(x, idx):
    """x [n, 8c] with each 8 columns taken in the order idx"""
    n, w = x.shape
    return x.reshape(n, w // 8, 8)[:, :, idx].reshape(n, w)


def _fa_fwd_kernel_algorithm(q, k, v, *, causal, window, scale, q_offset,
                             wg, nk, halves=False):
    """`csrc/flash_attention.cu`'s float32 body on the CPU, in numpy
    float32, for q [B, Sq, Hq, Dqk], k [B, Sk, Hkv, Dqk], v [B, Sk, Hkv,
    Dv]; returns (out, lse [B, Hq, Sq]).

    A block is `wg` warpgroups of 64 q rows and walks the `nk`-key tiles
    of its rows' band (zero past Sk); a warpgroup skips a tile that hides
    all its rows.  S = Q K^T reads Q from rows stored with d t and t + 4
    side by side (the A registers of k index t and t + 4) against K as it
    lands; P's A fragment is S's accumulator as it stands (k index t <->
    key 2t, t + 4 <-> 2t + 1 within 8), so V^T's keys are stored in that
    order.  Every product is split TF32 (hi rounded to nearest, lo the
    remainder, read rounded toward zero).  Then the scale, the mask
    (-1e30), the online softmax's rescale alpha = exp(m - m_new) of l and
    O, and out = O / l (l = 0 divides by 1), lse = m + log l (+inf).
    `halves`: float32 at D = 256, each K and V tile streamed as two
    column halves, S summed over K's halves in one float32 accumulator
    and O's columns of each half from V^T's half."""
    f32 = np.float32
    B, Sq, Hq, Dqk = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    groups = Hq // Hkv
    rows = 64 * wg

    def mm(a, b):
        return _mm_3xtf32(a, b, _tf32_rz)

    out = np.zeros((B, Sq, Hq, Dv), f32)
    lse = np.zeros((B, Hq, Sq), f32)
    for b in range(B):
        for h in range(Hq):
            hk = h // groups
            for q0 in range(0, Sq, rows):
                n = min(rows, Sq - q0)
                pos_lo, pos_hi = q_offset + q0, q_offset + q0 + n - 1
                k_end = min(Sk, pos_hi + 1) if causal else Sk
                k_begin = max(0, pos_lo - window + 1) if window else 0
                tiles = range(k_begin // nk * nk, k_end, nk) \
                    if k_end > k_begin else ()
                for w in range(wg):
                    wq0 = q0 + 64 * w
                    wn = max(0, min(64, Sq - wq0))
                    if wn == 0:
                        continue
                    qt = np.zeros((64, Dqk), f32)
                    qt[:wn] = q[b, wq0:wq0 + wn, h]
                    # Q's rows as stored, then the A registers' k order
                    a_q = _gather8(_gather8(qt, _Q_D_OF_POS), _A_POS_OF_K)
                    qi = (q_offset + wq0 + np.arange(64))[:, None]
                    m = np.full((64, 1), -1e30, f32)
                    l = np.zeros((64, 1), f32)
                    acc = np.zeros((64, Dv), f32)
                    for k0 in tiles:
                        if (causal and k0 > q_offset + wq0 + wn - 1) or (
                                window and k0 + nk - 1
                                <= q_offset + wq0 - window):
                            continue
                        kt = np.zeros((nk, Dqk), f32)
                        vt = np.zeros((nk, Dv), f32)
                        kn = max(0, min(nk, Sk - k0))
                        kt[:kn] = k[b, k0:k0 + kn, hk]
                        vt[:kn] = v[b, k0:k0 + kn, hk]
                        if halves:
                            hw = Dqk // 2
                            s = (mm(a_q[:, :hw], kt[:, :hw]).astype(f32)
                                 + mm(a_q[:, hw:], kt[:, hw:])).astype(f32)
                        else:
                            s = mm(a_q, kt)
                        s = (s * f32(scale)).astype(f32)
                        kj = (k0 + np.arange(nk))[None, :]
                        ok = kj < Sk
                        if causal:
                            ok = ok & (kj <= qi)
                        if window:
                            ok = ok & (kj > qi - window)
                        s = np.where(ok, s, f32(-1e30))
                        m_new = np.maximum(m, s.max(axis=1, keepdims=True))
                        p = np.exp(s - m_new).astype(f32)
                        alpha = np.exp(m - m_new).astype(f32)
                        l = (alpha * l + p.sum(axis=1, keepdims=True)
                             ).astype(f32)
                        m = m_new
                        # P's fragment and V^T [Dv, keys] as stored, both
                        # read along the same k index
                        a_p = _gather8(p, _P_KEY_OF_K)
                        v_t = _gather8(np.ascontiguousarray(vt.T),
                                       _VT_KEY_OF_POS)
                        if halves:
                            hw = Dv // 2
                            pv = np.concatenate([mm(a_p, v_t[:hw]),
                                                 mm(a_p, v_t[hw:])], axis=1)
                        else:
                            pv = mm(a_p, v_t)
                        acc = (acc * alpha + pv).astype(f32)
                    lsum = np.where(l == 0, f32(1), l)
                    out[b, wq0:wq0 + wn, h] = (acc / lsum)[:wn]
                    lse[b, h, wq0:wq0 + wn] = np.where(
                        l[:, 0] == 0, np.inf,
                        m[:, 0] + np.log(l[:, 0]))[:wn]
    return out, lse


@pytest.mark.parametrize(
    "B,Sq,Sk,Hq,Hkv,Dqk,Dv,causal,window,q_offset,wg,nk,halves", [
        # D = 256 float32 (the D-halved body): two warpgroups, 32-key
        # tiles, K and V as 128-column halves; windowed MQA, ragged tiles
        (1, 100, 100, 2, 1, 256, 256, True, 40, 0, 2, 32, True),
        (1, 150, 190, 4, 1, 256, 256, True, 70, 40, 2, 32, True),
        # MLA's (192, 128) with a GQA group: two warpgroups, 16-key tiles
        (1, 130, 130, 4, 2, 192, 128, True, None, 0, 2, 16, False),
        # ragged Sq != Sk without a mask: two warpgroups, 64-key tiles
        (1, 70, 150, 2, 2, 64, 64, False, None, 0, 2, 64, False),
        # a static q_offset with causal and window at D = 128
        (1, 65, 129, 2, 1, 128, 128, True, 48, 60, 2, 32, False),
    ])
def test_fa_forward_kernel_algorithm_meets_the_tolerance(
        B, Sq, Sk, Hq, Hkv, Dqk, Dv, causal, window, q_offset, wg, nk,
        halves):
    """The forward kernel's float32 algorithm (64-row warpgroup tiles,
    `nk`-key tiles, split TF32 with lo read rounded toward zero, the
    permuted contraction orders, the online softmax's rescale; at D = 256
    the tiles' column halves) stays within
    TOL["float32"] of the plain version in float64, and its log-sum-exp
    within the same of float64's."""
    rng = np.random.default_rng(Dqk + Sq)
    q = rng.standard_normal((B, Sq, Hq, Dqk)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, Dqk)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, Dv)).astype(np.float32)
    scale = Dqk ** -0.5
    got, got_lse = _fa_fwd_kernel_algorithm(
        q, k, v, causal=causal, window=window, scale=scale,
        q_offset=q_offset, wg=wg, nk=nk, halves=halves)
    q64, k64, v64 = (torch.from_numpy(x).double() for x in (q, k, v))
    want = attention_ref(q64, k64, v64, causal=causal, window=window,
                         scale=scale, q_offset=q_offset).numpy()
    s = torch.einsum("bihd,bjhd->bhij", q64, k64.repeat_interleave(
        Hq // Hkv, dim=2)) * scale
    qi = torch.arange(Sq)[:, None] + q_offset
    kj = torch.arange(Sk)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        ok &= kj <= qi
    if window:
        ok &= kj > qi - window
    want_lse = torch.logsumexp(s.masked_fill(~ok, -torch.inf), dim=-1)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err < TOL["float32"], err
    lse_err = float(np.abs(got_lse - want_lse.numpy()).max())
    assert lse_err < TOL["float32"], lse_err


# ---------------------------------------------------------------------- #
# flash attention backward, CPU: the backward kernel's algorithm
# ---------------------------------------------------------------------- #
_LOG2E = np.float32(1.4426950408889634)


def _fa_bwd_kernel_algorithm(q, k, v, out, lse, dout, *, causal, scale,
                             kno, rows=64, window=None, halves=False):
    """`csrc/flash_attention_bwd.cu`'s float32 path on the CPU, in numpy
    float32, for q [B, Sq, Hq, Dqk], k [B, Sk, Hkv, Dqk], v [B, Sk, Hkv,
    Dv] and the forward's out [B, Sq, Hq, Dv] and lse [B, Hq, Sq].

    delta_kernel: D_i = sum_d dO_id O_id.  Then two passes of one body: a
    block owns `kno` rows of one side (K and V for dK/dV, Q and dO for
    dQ) and streams `rows`-row tiles of the other (zero past the end) over
    its band, for dK/dV through every q head of the kv head's group in
    head order.  Each tile forms T1 = Y1 X1^T (S, over Dqk) and T2 = Y2
    X2^T (dP, over Dv), then P = exp2(s log2 e - L log2 e), dS = P (dP -
    D) (0 where masked), then A1 = Y2^T P (dV^T) and A2 = Y1^T dS (dK^T or
    dQ^T), each in a fresh accumulator added to the block's sums in that
    order; the dQ pass forms S and dP again.  Every product is split TF32:
    hi rounded to nearest, lo the remainder, which the tensor core reads
    rounded toward zero.  `halves` (float32 at D = 256): the streamed
    tiles come as two column halves, T1 and T2 summed over them in one
    float32 accumulator.  `window`: the band and the mask of a sliding
    window."""
    B, Sq, Hq, Dqk = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    groups = Hq // Hkv
    def mm(a, b):
        """a @ b.T as the tensor cores form it from split operands."""
        return _mm_3xtf32(a, b, _tf32_rz)

    def mt(y, x):
        """T = y x^T over the head dim, by halves when `halves`."""
        if not halves:
            return mm(y, x)
        hw = y.shape[1] // 2
        return (mm(y[:, :hw], x[:, :hw]).astype(np.float32)
                + mm(y[:, hw:], x[:, hw:])).astype(np.float32)

    delta = np.einsum("bihd,bihd->bhi", dout, out).astype(np.float32)
    l2 = (lse * _LOG2E).astype(np.float32)
    s2 = np.float32(scale) * _LOG2E

    def tile(x, i0):
        """rows [i0, i0 + rows) of x [S, D], zero past its end."""
        t = np.zeros((rows, x.shape[1]), np.float32)
        part = x[i0:i0 + rows]
        t[:len(part)] = part
        return t

    def p_ds(t1, t2, L2, Dl, qi, kj):
        """P and dS of one tile: t1, t2, qi, kj [rows-or-kno, ...] laid
        out alike."""
        p = np.exp2((t1 * s2 - L2).astype(np.float32)).astype(np.float32)
        ds = (p * (t2 - Dl)).astype(np.float32)
        ok = (qi < Sq) & (kj < Sk) & ((kj <= qi) if causal else True)
        if window:
            ok = ok & (kj > qi - window)
        return np.where(ok, p, 0).astype(np.float32), \
            np.where(ok, ds, 0).astype(np.float32)

    dq = np.zeros_like(q)
    dk = np.zeros_like(k)
    dv = np.zeros((B, Sk, Hkv, v.shape[3]), np.float32)
    for b in range(B):
        for hk in range(Hkv):                      # dK, dV
            for o0 in range(0, Sk, kno):
                kj = (o0 + np.arange(kno))[None, :]
                X1, X2 = tile(k[b, :, hk], o0)[:kno], \
                    tile(v[b, :, hk], o0)[:kno]
                acc_k = np.zeros((Dqk, kno), np.float32)
                acc_v = np.zeros((v.shape[3], kno), np.float32)
                lo = (o0 // rows) * rows if causal else 0
                hi = min(Sq, o0 + kno - 1 + window) if window else Sq
                for h in range(hk * groups, (hk + 1) * groups):
                    for i0 in range(lo, hi, rows):
                        qi = (i0 + np.arange(rows))[:, None]
                        Y1, Y2 = tile(q[b, :, h], i0), \
                            tile(dout[b, :, h], i0)
                        rl = np.full(rows, np.inf, np.float32)
                        rd = np.zeros(rows, np.float32)
                        n = min(rows, Sq - i0)
                        rl[:n], rd[:n] = l2[b, h, i0:i0 + n], \
                            delta[b, h, i0:i0 + n]
                        p, ds = p_ds(mt(Y1, X1), mt(Y2, X2), rl[:, None],
                                     rd[:, None], qi, kj)
                        acc_v = (acc_v + mm(Y2.T, p.T)).astype(np.float32)
                        acc_k = (acc_k + mm(Y1.T, ds.T)).astype(np.float32)
                n = min(kno, Sk - o0)
                dk[b, o0:o0 + n, hk] = (acc_k.T * np.float32(scale))[:n]
                dv[b, o0:o0 + n, hk] = acc_v.T[:n]
        for h in range(Hq):                        # dQ
            hk = h // groups
            for o0 in range(0, Sq, kno):
                qi = (o0 + np.arange(kno))[None, :]
                X1, X2 = tile(q[b, :, h], o0)[:kno], \
                    tile(dout[b, :, h], o0)[:kno]
                ol = np.full(kno, np.inf, np.float32)
                od = np.zeros(kno, np.float32)
                n = min(kno, Sq - o0)
                ol[:n], od[:n] = l2[b, h, o0:o0 + n], delta[b, h, o0:o0 + n]
                acc = np.zeros((Dqk, kno), np.float32)
                hi = min(Sk, o0 + kno) if causal else Sk
                lo = (max(0, o0 - window + 1) // rows * rows if window
                      else 0)
                for i0 in range(lo, hi, rows):
                    kj = (i0 + np.arange(rows))[:, None]
                    Y1, Y2 = tile(k[b, :, hk], i0), \
                        tile(v[b, :, hk], i0)
                    _, ds = p_ds(mt(Y1, X1), mt(Y2, X2), ol[None, :],
                                 od[None, :], qi, kj)
                    acc = (acc + mm(Y1.T, ds.T)).astype(np.float32)
                dq[b, o0:o0 + n, h] = (acc.T * np.float32(scale))[:n]
    return dq, dk, dv


def _bf16(x):
    """x (float32) rounded to the nearest bfloat16, ties to even, as
    float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7fff) + ((u >> 16) & 1)) & np.uint32(0xffff0000)
    return u.view(np.float32)


def _fa_bwd_mla_kernel_algorithm(q, k, v, out, lse, dout, *, causal, scale,
                                 own=64, wgs=2, rows_kv=32, rows_q=64):
    """`csrc/flash_attention_bwd_mla.cuh`'s bf16 body on the CPU, in numpy
    float32, for q, k [B, S, H, 192], v [B, Sk, Hkv, 128] (every input
    already bfloat16 values) and the forward's out and lse.

    delta_kernel: D_i = sum_d dO_id O_id.  Then two launches of one body:
    a block owns `wgs` x `own` rows of one side (K and V for dK/dV, Q and
    dO for dQ), `own` a consumer warpgroup, and streams tiles of the other
    (`rows_kv` rows for dK/dV, `rows_q` for dQ, zero past the end) over
    the block's band, for dK/dV through every q head of the group in head
    order.  A warpgroup skips a
    tile its mask hides wholly.  Each tile forms S^T = K Q^T and dP^T = V
    dO^T (or S = Q K^T, dP = dO V^T) on bf16 operands with float32 sums,
    then P = exp2(s log2 e - L log2 e) (0 where masked) rounded to bf16,
    dS = P (dP - D) from that P, then adds P^T dO to dV and dS^T Q to dK
    (dS K to dQ) with dS rounded to bf16, into float32 sums that run over
    the whole band and group in that order; the dQ launch forms S and dP
    again.  The outputs are rounded to bf16 (dK and dQ after the scale)."""
    B, Sq, Hq, Dqk = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    groups = Hq // Hkv
    cta = own * wgs
    f32 = np.float32

    def mm(a, b):
        return (a.astype(f32) @ b.T.astype(f32)).astype(f32)

    delta = np.einsum("bihd,bihd->bhi", dout, out).astype(f32)
    l2 = (lse * _LOG2E).astype(f32)
    s2 = f32(scale) * _LOG2E

    def tile(x, i0, n):
        t = np.zeros((n, x.shape[1]), f32)
        part = x[i0:i0 + n]
        t[:len(part)] = part
        return t

    def p_ds(t1, t2, L2, Dl, qi, kj):
        """P rounded to bf16 (0 where masked), and dS from it"""
        p = np.exp2((t1 * s2 - L2).astype(f32)).astype(f32)
        ok = (qi < Sq) & (kj < Sk) & ((kj <= qi) if causal else True)
        p = _bf16(np.where(ok, p, 0).astype(f32))
        return p, (p * (t2 - Dl)).astype(f32)

    def band(o_cta, n_own, S_str, dq_pass, rows):
        """the block's streamed tiles' first rows"""
        lo, hi = 0, S_str
        valid = min(n_own - o_cta, cta)
        if causal and dq_pass:
            hi = min(hi, o_cta + valid)
        if causal and not dq_pass:
            lo = max(lo, o_cta)
        return range((lo // rows) * rows, hi, rows) if hi > lo else ()

    def hidden(q_lo, q_hi, k_lo):
        return causal and k_lo > q_hi

    dq = np.zeros_like(q)
    dk = np.zeros_like(k)
    dv = np.zeros((B, Sk, Hkv, v.shape[3]), f32)
    for b in range(B):
        for hk in range(Hkv):                      # dK, dV
            for o_cta in range(0, Sk, cta):
                rows = rows_kv
                tiles = band(o_cta, Sk, Sq, False, rows)
                for o0 in range(o_cta, min(o_cta + cta, Sk), own):
                    kj = (o0 + np.arange(own))[:, None]
                    X1, X2 = tile(k[b, :, hk], o0, own), \
                        tile(v[b, :, hk], o0, own)
                    acc_k = np.zeros((own, Dqk), f32)
                    acc_v = np.zeros((own, v.shape[3]), f32)
                    for h in range(hk * groups, (hk + 1) * groups):
                        for i0 in tiles:
                            if hidden(i0, i0 + rows - 1, o0):
                                continue
                            qi = (i0 + np.arange(rows))[None, :]
                            Y1, Y2 = tile(q[b, :, h], i0, rows), \
                                tile(dout[b, :, h], i0, rows)
                            rl = tile(l2[b, h][:, None], i0, rows)[:, 0]
                            rd = tile(delta[b, h][:, None], i0, rows)[:, 0]
                            p, ds = p_ds(mm(X1, Y1), mm(X2, Y2),
                                         rl[None, :], rd[None, :], qi, kj)
                            acc_v = (acc_v + mm(p, Y2.T)).astype(f32)
                            acc_k = (acc_k + mm(_bf16(ds), Y1.T)).astype(f32)
                    n = min(own, Sk - o0)
                    dk[b, o0:o0 + n, hk] = _bf16(acc_k * f32(scale))[:n]
                    dv[b, o0:o0 + n, hk] = _bf16(acc_v)[:n]
        for h in range(Hq):                        # dQ
            hk = h // groups
            for o_cta in range(0, Sq, cta):
                rows = rows_q
                tiles = band(o_cta, Sq, Sk, True, rows)
                for o0 in range(o_cta, min(o_cta + cta, Sq), own):
                    qi = (o0 + np.arange(own))[:, None]
                    X1, X2 = tile(q[b, :, h], o0, own), \
                        tile(dout[b, :, h], o0, own)
                    ol = tile(l2[b, h][:, None], o0, own)
                    od = tile(delta[b, h][:, None], o0, own)
                    acc = np.zeros((own, Dqk), f32)
                    for i0 in tiles:
                        if hidden(o0, o0 + own - 1, i0):
                            continue
                        kj = (i0 + np.arange(rows))[None, :]
                        Y1, Y2 = tile(k[b, :, hk], i0, rows), \
                            tile(v[b, :, hk], i0, rows)
                        _, ds = p_ds(mm(X1, Y1), mm(X2, Y2), ol, od, qi, kj)
                        acc = (acc + mm(_bf16(ds), Y1.T)).astype(f32)
                    n = min(own, Sq - o0)
                    dq[b, o0:o0 + n, h] = _bf16(acc * f32(scale))[:n]
    return dq, dk, dv


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,Dqk,Dv,causal,window,kno", [
    (1, 130, 130, 2, 1, 192, 128, True, None, 16),   # MLA's, a GQA group
    (2, 100, 150, 2, 2, 64, 64, False, None, 48),    # Sq != Sk, ragged
    # D = 256 float32: 32 owned rows, the streamed tiles by halves;
    # windowed MQA, ragged tiles
    (1, 150, 150, 4, 1, 256, 256, True, 70, "halves"),
    # the bf16 (192, 128) body: a GQA group and ragged 64- and 128-row
    # tiles, causal; Sq != Sk without a mask
    (1, 200, 200, 4, 2, 192, 128, True, None, "mla"),
    (1, 100, 150, 2, 2, 192, 128, False, None, "mla"),
])
def test_fa_backward_kernel_algorithm_meets_the_tolerance(
        B, Sq, Sk, Hq, Hkv, Dqk, Dv, causal, window, kno):
    """The backward kernels' algorithms stay within BWD_TOL of the plain
    version's autograd in float64, for dQ, dK and dV each; the forward's
    out and log-sum-exp as the forward kernel writes them.  An int `kno`:
    `bwd_kernel`'s float32 path (split TF32, 64-row streamed tiles, `kno`
    owned rows, a fresh accumulator a tile, S and dP formed again for dQ)
    against BWD_TOL["float32"].  "mla": the bf16 (192, 128) body
    (bfloat16 inputs, 64 owned rows a warpgroup and two a block, 32-row
    streamed tiles for dK/dV and 64-row for dQ, P and dS rounded to bf16,
    float32 sums over the band)
    against BWD_TOL["bfloat16"], the reference taking the same bfloat16
    inputs.  "halves": the float32 path at D = 256 (32 owned rows, the
    streamed tiles' column halves summed in one accumulator), windowed."""
    mla = kno == "mla"
    rng = np.random.default_rng(Dqk + Sq)
    q, k = (rng.standard_normal((B, S, H, Dqk)).astype(np.float32)
            for S, H in ((Sq, Hq), (Sk, Hkv)))
    v = rng.standard_normal((B, Sk, Hkv, Dv)).astype(np.float32)
    dout = rng.standard_normal((B, Sq, Hq, Dv)).astype(np.float32)
    if mla:
        q, k, v, dout = (_bf16(x) for x in (q, k, v, dout))
    scale = Dqk ** -0.5
    q64, k64, v64 = (torch.from_numpy(x).double() for x in (q, k, v))
    s = torch.einsum("bihd,bjhd->bhij", q64, k64.repeat_interleave(
        Hq // Hkv, dim=2)) * scale
    qi = torch.arange(Sq)[:, None]
    kj = torch.arange(Sk)[None, :]
    if causal:
        s = s.masked_fill(kj > qi, -1e30)
    if window:
        s = s.masked_fill(kj <= qi - window, -1e30)
    lse = torch.logsumexp(s, dim=-1)
    out = attention_ref(q64, k64, v64, causal=causal, window=window,
                        scale=scale)
    out32 = out.float().numpy()
    if mla:
        got = _fa_bwd_mla_kernel_algorithm(
            q, k, v, _bf16(out32), lse.float().numpy(), dout,
            causal=causal, scale=scale)
    else:
        halves = kno == "halves"
        got = _fa_bwd_kernel_algorithm(
            q, k, v, out32, lse.float().numpy(), dout, causal=causal,
            scale=scale, kno=32 if halves else kno, window=window,
            halves=halves)
    want = fa.flash_attention_bwd_plain(q64, k64, v64,
                                        torch.from_numpy(dout).double(),
                                        causal=causal, window=window,
                                        scale=scale)
    tol = BWD_TOL["bfloat16" if mla else "float32"]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == tuple(w.shape), name
        err = float(np.abs(g - w.numpy()).max()) / max(
            1.0, float(w.abs().max()))
        assert err < tol, (name, err)


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


def _rglru_np(x, a, h0):
    """The recurrence evaluated in float64 with numpy."""
    h = np.zeros((x.shape[0], x.shape[2])) if h0 is None else h0
    hs = np.empty(x.shape)
    for t in range(x.shape[1]):
        h = a[:, t] * h + np.sqrt(np.clip(1.0 - a[:, t] ** 2, 0.0, 1.0)) * x[
            :, t]
        hs[:, t] = h
    return hs, h


def _rglru_ref_float32(x, a, h0=None):
    """`rglru_ref` as it computed before float64 inputs were computed in
    float64: float32 inside whatever the input."""
    xf, af = x.float(), a.float()
    gated = torch.sqrt(torch.clamp(1.0 - af * af, 0.0, 1.0)) * xf
    h = (torch.zeros(x.shape[:1] + x.shape[2:], dtype=torch.float32)
         if h0 is None else h0.float())
    hs = torch.empty_like(xf)
    for t in range(x.shape[1]):
        h = af[:, t] * h + gated[:, t]
        hs[:, t] = h
    return hs.to(x.dtype), h.to(x.dtype)


@pytest.mark.parametrize("B,S,D,with_h0", [(2, 33, 16, False),
                                           (1, 40, 24, True)])
def test_rglru_ref_computes_float64_inputs_in_float64(B, S, D, with_h0, jx):
    """Float64 inputs are computed in float64 (the RG-LRU backward
    checks' float64 reference); float32 and bfloat16 inputs give the bits
    they gave before, within a float32 rounding (1e-6) or one bfloat16
    step of the JAX package's `rglru_ref`, and miss the float64 result by
    far more than float64 rounding."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, S, D))
    a = rng.uniform(0.05, 0.99, (B, S, D))
    h0 = rng.standard_normal((B, D)) if with_h0 else None
    want_h, want_last = _rglru_np(x, a, h0)
    got_h, got_last = rglru_ref(torch.from_numpy(x), torch.from_numpy(a),
                                None if h0 is None else torch.from_numpy(h0))
    assert got_h.dtype == got_last.dtype == torch.float64
    assert np.abs(got_h.numpy() - want_h).max() < 1e-12
    assert np.abs(got_last.numpy() - want_last).max() < 1e-12
    for dt in ("float32", "bfloat16"):
        xt, at = _t(x, dt), _t(a, dt)
        h0t = None if h0 is None else _t(h0)
        got = rglru_ref(xt, at, h0t)
        assert all(g.dtype == getattr(torch, dt) for g in got)
        for g, old in zip(got, _rglru_ref_float32(xt, at, h0t)):
            assert torch.equal(g, old), dt
        want = jx.ref.rglru_ref(jx.a(x, dt), jx.a(a, dt),
                                h0=None if h0 is None else jx.a(h0))
        for g, wt in zip(got, want):     # XLA rounds a step differently
            g, wt = _np(g), _np(wt)
            ulp = 1e-6 if dt == "float32" else 2.0 ** -7 * np.maximum(
                1.0, np.abs(wt))
            assert (np.abs(g - wt) <= ulp).all(), dt
    got32 = rglru_ref(_t(x), _t(a), None if h0 is None else _t(h0))[0]
    assert np.abs(got32.double().numpy() - want_h).max() > 1e-10


# ---------------------------------------------------------------------- #
# RG-LRU backward, CPU: the backward kernel's time-parallel algorithm
# ---------------------------------------------------------------------- #
def _rglru_bwd_kernel_algorithm(x, a, h0, dh, dh_last, chunk):
    """`csrc/rglru_bwd.cu`'s three launches in float32 on the CPU, with
    chunks of `chunk` steps.  A step's walk: g = dh_t + carry, the gate's
    gradient one autograd rule at a time, carry = g * a_t.  Launch 1
    walks every chunk but the first from a zero carry: alpha the carry
    leaving it, beta the product of its a (last step first); launch 2
    walks the chunks from the last, carry_in = dh_last (or 0) there and
    carry_in_{j-1} = fmaf(beta_j, carry_in_j, alpha_j); launch 3 walks
    each chunk again from its carry_in, and the first chunk's last carry
    is dh0.  h_{t-1} is the forward's h (`rglru_ref`'s bits)."""
    B, S, D = x.shape
    xf, af, gf = x.float(), a.float(), dh.float()
    hf = rglru_ref(x, a, h0)[0].float()
    first = (h0.float() if h0 is not None else torch.zeros((B, D)))
    hprev = torch.cat([first[:, None], hf[:, :-1]], dim=1)
    n = -(-S // chunk)
    span = lambda j: range(j * chunk, min(S, (j + 1) * chunk))
    alpha, beta = torch.zeros((B, n, D)), torch.zeros((B, n, D))
    for j in range(1, n):
        carry, prod = torch.zeros((B, D)), torch.ones((B, D))
        for t in reversed(span(j)):
            carry = (gf[:, t] + carry) * af[:, t]
            prod = prod * af[:, t]
        alpha[:, j], beta[:, j] = carry, prod
    c = (dh_last.float() if dh_last is not None else torch.zeros((B, D)))
    carry_in = torch.zeros((B, n, D))
    for j in reversed(range(n)):
        carry_in[:, j] = c
        if j >= 1:
            c = _fmaf(beta[:, j], c, alpha[:, j])
    dx, da = torch.empty_like(xf), torch.empty_like(xf)
    dh0 = c
    for j in range(n):
        carry = carry_in[:, j]
        for t in reversed(span(j)):
            ai = af[:, t]
            g = gf[:, t] + carry
            v = 1.0 - ai * ai
            c = torch.sqrt(torch.clamp(v, 0.0, 1.0))
            gc = torch.where((v >= 0.0) & (v <= 1.0),
                             (g * xf[:, t]) / (2.0 * c), torch.zeros(()))
            gaa = -gc
            dx[:, t] = g * c
            da[:, t] = g * hprev[:, t] + (gaa * ai + gaa * ai)
            carry = g * ai
        if j == 0:
            dh0 = carry
    return dx, da, dh0 if h0 is not None else None


def _finite_err(got, want) -> float:
    """The scaled error over the finite entries of `want`, after checking
    that the others (the gate's infinite gradient at a = 1) are the same
    infinities and NaNs in `got`."""
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(got[~fin].double().nan_to_num(),
                       want[~fin].nan_to_num())
    got, want = got[fin].double(), want[fin]
    if want.numel() == 0:
        return 0.0
    return float((got - want).abs().max()) / max(1.0, float(
        want.abs().max()))


@pytest.mark.parametrize("B,S,D,chunk,a_case,with_h0,with_dl", [
    (2, 37, 8, 16, "uniform", True, True),      # a ragged last chunk
    (1, 5, 8, 16, "uniform", False, True),      # S < chunk
    (2, 30, 6, 7, "edges", True, False),        # a = 0, 1, 1 - 2^-24
    (1, 24, 4, 1, "uniform", True, True),       # chunks of one step
    (1, 48, 8, 16, "near_one", False, False),   # every a near 1
    (1, 1, 16, 7, "edges", True, True),         # one step
])
def test_rglru_backward_kernel_algorithm_meets_the_tolerance(
        B, S, D, chunk, a_case, with_h0, with_dl):
    """The time-parallel backward's algorithm stays within
    1e-5·max(1, max|g|) of the plain version's autograd in float64, and
    gives its infinities and NaNs where the gate's gradient is infinite
    (a = 1)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    a = rng.uniform(0.05, 0.99, (B, S, D)).astype(np.float32)
    near = np.float32(1 - 2.0 ** -24)
    if a_case == "edges":
        a.reshape(-1)[::3] = 0.0
        a.reshape(-1)[1::5] = 1.0
        a.reshape(-1)[2::7] = near
    elif a_case == "near_one":
        a[:] = near
    x, a = _t(x), _t(a)
    h0 = _t(rng.standard_normal((B, D)).astype(np.float32)) if with_h0 \
        else None
    dh = _t(rng.standard_normal((B, S, D)).astype(np.float32))
    dl = _t(rng.standard_normal((B, D)).astype(np.float32)) if with_dl \
        else None
    got = _rglru_bwd_kernel_algorithm(x, a, h0, dh, dl, chunk)
    want = rglru.rglru_bwd_plain(
        x.double(), a.double(), None if h0 is None else h0.double(),
        dh.double(), torch.zeros((B, D), dtype=torch.float64)
        if dl is None else dl.double())
    for g, wt in zip(got, want):
        assert (g is None) == (wt is None)
        if wt is not None:
            assert g.shape == wt.shape
            assert _finite_err(g, wt) < 1e-5, (a_case, chunk)


def test_rglru_backward_kernel_algorithm_at_s_zero():
    """S = 0: no chunk; dh0 is dh_last, as the plain version's h_last =
    h0 gives it."""
    x = torch.zeros((2, 0, 5))
    dl = torch.randn((2, 5))
    dx, da, dh0 = _rglru_bwd_kernel_algorithm(x, x, torch.randn((2, 5)),
                                              x, dl, 16)
    assert dx.shape == da.shape == (2, 0, 5)
    assert torch.equal(dh0, dl)


# ---------------------------------------------------------------------- #
# RWKV6, CPU: the port against the Pallas kernel and the jnp oracles
# ---------------------------------------------------------------------- #
# (B, S, H, Dk, Dv): the cases of tests/test_kernels.py::test_rwkv6_kernel_vs_ref
RWKV_CASES = [
    (2, 32, 2, 16, 16),
    (1, 48, 4, 32, 32),
    (1, 16, 1, 8, 24),     # Dk != Dv
]
# (B, S, H, D, chunk): the cases of tests/test_kernels.py::test_rwkv6_chunked_vs_ref
CHUNKED_CASES = [(2, 128, 2, 16, 32), (1, 256, 4, 32, 64), (1, 64, 2, 16, 64)]


def _rkvwu(B, S, H, Dk, Dv, seed=0, w_lo=0.4, w_hi=0.99):
    """r, v normal; k normal * 0.3; w uniform; u normal * 0.1 — the draws
    of tests/test_kernels.py::test_rwkv6_kernel_vs_ref, in its order."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, S, H, Dk)).astype(np.float32)
    k = (rng.standard_normal((B, S, H, Dk)) * 0.3).astype(np.float32)
    v = rng.standard_normal((B, S, H, Dv)).astype(np.float32)
    w = rng.uniform(w_lo, w_hi, (B, S, H, Dk)).astype(np.float32)
    u = (rng.standard_normal((H, Dk)) * 0.1).astype(np.float32)
    return r, k, v, w, u


def _chunked_inputs(B, S, H, D, seed=0, logw_lo=-6):
    """The draws of tests/test_kernels.py::test_rwkv6_chunked_vs_ref:
    w = exp(-exp(uniform)), with an s0."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = (rng.standard_normal((B, S, H, D)) * 0.3).astype(np.float32)
    v = rng.standard_normal((B, S, H, D)).astype(np.float32)
    w = np.exp(-np.exp(rng.uniform(logw_lo, 1.5, (B, S, H, D))))
    u = (rng.standard_normal((H, D)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, H, D, D)) * 0.1).astype(np.float32)
    return r, k, v, w.astype(np.float32), u, s0


@pytest.mark.parametrize("B,S,H,Dk,Dv", RWKV_CASES)
def test_rwkv6_matches_pallas(B, S, H, Dk, Dv, jx):
    arrays = _rkvwu(B, S, H, Dk, Dv)
    want_o, want_s = jx.rwkv6(*map(jx.a, arrays), interpret=True)
    before = rwkv6.launches
    out, s_last = rwkv6.rwkv6_scan(*map(_t, arrays))
    assert rwkv6.launches == before     # a CPU tensor runs the plain version
    assert out.shape == (B, S, H, Dv) and out.dtype == torch.float32
    assert s_last.shape == (B, H, Dk, Dv) and s_last.dtype == torch.float32
    assert np.abs(_np(out) - _np(want_o)).max() < 1e-5
    assert np.abs(_np(s_last) - _np(want_s)).max() < 1e-5


@pytest.mark.parametrize("B,S,H,Dk,Dv", RWKV_CASES)
def test_rwkv6_ref_matches_jax_ref(B, S, H, Dk, Dv, jx):
    arrays = _rkvwu(B, S, H, Dk, Dv, seed=3)
    s0 = np.random.default_rng(4).standard_normal(
        (B, H, Dk, Dv)).astype(np.float32)
    want_o, want_s = jx.ref.rwkv6_ref(*map(jx.a, arrays), s0=jx.a(s0))
    out, s_last = rwkv6_ref(*map(_t, arrays), s0=_t(s0))
    assert np.abs(_np(out) - _np(want_o)).max() < 1e-5
    assert np.abs(_np(s_last) - _np(want_s)).max() < 1e-5


def test_rwkv6_state_carry():
    """tests/test_kernels.py::test_rwkv6_state_carry, through the port's
    scan: two halves with the state carried equal the whole."""
    r, k, v, w, u = map(_t, _rkvwu(1, 20, 2, 8, 8, seed=1, w_lo=0.5,
                                   w_hi=0.95))
    full, s_full = rwkv6.rwkv6_scan(r, k, v, w, u)
    o1, s1 = rwkv6.rwkv6_scan(r[:, :10], k[:, :10], v[:, :10], w[:, :10], u)
    o2, s2 = rwkv6.rwkv6_scan(r[:, 10:], k[:, 10:], v[:, 10:], w[:, 10:], u,
                              s0=s1)
    np.testing.assert_allclose(_np(full), np.concatenate(
        [_np(o1), _np(o2)], axis=1), atol=1e-5)
    np.testing.assert_allclose(_np(s_full), _np(s2), atol=1e-5)


@pytest.mark.parametrize("B,S,H,D,chunk", CHUNKED_CASES)
def test_rwkv6_chunked_vs_ref(B, S, H, D, chunk):
    r, k, v, w, u, s0 = map(_t, _chunked_inputs(B, S, H, D))
    o_ref, s_ref = rwkv6_ref(r, k, v, w, u, s0=s0)
    o_ch, s_ch = rwkv6_chunked(r, k, v, w, u, s0=s0, chunk=chunk)
    assert float((o_ref - o_ch).abs().max()) < 5e-4
    assert float((s_ref - s_ch).abs().max()) < 5e-4


@pytest.mark.parametrize("B,S,H,D,chunk", CHUNKED_CASES)
def test_rwkv6_chunked_matches_jax_chunked(B, S, H, D, chunk, jx):
    arrays = _chunked_inputs(B, S, H, D, seed=5)
    want_o, want_s = jx.ref.rwkv6_chunked(*map(jx.a, arrays[:5]),
                                          s0=jx.a(arrays[5]), chunk=chunk)
    out, s_last = rwkv6_chunked(*map(_t, arrays[:5]), s0=_t(arrays[5]),
                                chunk=chunk)
    assert np.abs(_np(out) - _np(want_o)).max() < 5e-5
    assert np.abs(_np(s_last) - _np(want_s)).max() < 5e-5


def test_rwkv6_chunked_adversarial_decay():
    """Harsh constant decay channel: the two-level factorisation must not
    overflow (the failure mode of a single-level log-space split)."""
    rng = np.random.default_rng(1)
    B, S, H, D = 1, 128, 2, 16
    r = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = (rng.standard_normal((B, S, H, D)) * 0.3).astype(np.float32)
    v = rng.standard_normal((B, S, H, D)).astype(np.float32)
    wnp = np.exp(-np.exp(rng.uniform(-6, 1.5, (B, S, H, D))))
    wnp[..., 0] = np.exp(-np.exp(2.3))    # ~1e-4 decay every step
    u = (rng.standard_normal((H, D)) * 0.1).astype(np.float32)
    r, k, v, w, u = map(_t, (r, k, v, wnp.astype(np.float32), u))
    o_ref, _ = rwkv6_ref(r, k, v, w, u)
    o_ch, _ = rwkv6_chunked(r, k, v, w, u, chunk=64)
    assert bool(torch.isfinite(o_ch).all())
    assert float((o_ref - o_ch).abs().max()) < 5e-4


def test_rwkv6_chunked_grad_finite():
    r, k, v, w, u, _ = _chunked_inputs(1, 64, 2, 8, seed=2, logw_lo=-4)
    leaves = [_t(a).requires_grad_() for a in (r, k, v, w)]
    out, _ = rwkv6_chunked(*leaves, _t(u), chunk=32)
    (out ** 2).mean().backward()
    for leaf in leaves:
        assert leaf.grad is not None
        assert bool(torch.isfinite(leaf.grad).all())


@pytest.mark.parametrize("S,picked", [
    (1, ("ref", None)), (10, ("chunked", 10, 10)), (64, ("chunked", 64, 8)),
    (128, ("chunked", 64, 8)), (100, ("ref", None))])
def test_rwkv6_auto_on_the_cpu_keeps_the_jax_choice(monkeypatch, S, picked):
    calls = []
    monkeypatch.setattr(ops._ref, "rwkv6_chunked", lambda *a, chunk, subchunk,
                        **kw: calls.append(("chunked", chunk, subchunk)))
    monkeypatch.setattr(ops._ref, "rwkv6_ref",
                        lambda *a, s0=None: calls.append(("ref", s0)))
    monkeypatch.setattr(ops, "_rwkv6_cuda",
                        lambda *a: calls.append(("cuda",)))
    r = torch.zeros((1, S, 2, 8))
    u = torch.zeros((2, 8))
    ops.rwkv6(r, r, r, r, u)
    ops.rwkv6(r, r, r, r, u, impl="cuda")
    assert calls == [picked, ("cuda",)]


def test_rwkv6_rejects_what_the_kernel_cannot_take():
    r = torch.zeros((1, 4, 2, 8))
    u = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="parallel"):
        rwkv6.rwkv6_scan(r, torch.zeros((1, 4, 2, 4)), r, r, u)
    with pytest.raises(ValueError, match="v must be"):
        rwkv6.rwkv6_scan(r, r, torch.zeros((1, 3, 2, 8)), r, u)
    with pytest.raises(ValueError, match="u must be"):
        rwkv6.rwkv6_scan(r, r, r, r, torch.zeros((8,)))
    with pytest.raises(ValueError, match="s0 must be"):
        rwkv6.rwkv6_scan(r, r, r, r, u, s0=torch.zeros((1, 2, 8)))
    with pytest.raises(TypeError, match="one dtype"):
        rwkv6.rwkv6_scan(r, r, r.double(), r, u)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.rwkv6(r, r, r, r, u, impl="pallas")


# ---------------------------------------------------------------------- #
# RWKV6, CPU: the arithmetic of the register-tiled CUDA kernel
# ---------------------------------------------------------------------- #
def _fmaf(a, b, c):
    """`fmaf` in float32: a*b is exact in float64, the sum is rounded to
    float64 and then to float32 (one fma, up to double rounding)."""
    return (a.double() * b.double() + c.double()).float()


def _pairwise(x):
    """Sum over the last dim as ((x0 + x1) + (x2 + x3)) + ..., in float32."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _rwkv6_kernel_arithmetic(r, k, v, w, u, s0=None, rows=8):
    """`csrc/rwkv6.cu`'s operations in its order, float32 on the CPU.

    Dk is padded to the kernel's 64 rows with zeros; lane `l` of a column
    group holds rows l*rows .. l*rows + rows - 1.  Per step the lane sums
    r*S_old over its rows (a product, then fmaf row by row) and updates S
    as w*S + kv (two rounded operations); the shuffle tree adds the lanes'
    sums pairwise, ((l0 + l1) + (l2 + l3)) + ....  The u term,
    sum_rows (r*u)*k, is summed pairwise over the 64 rows by the staging
    threads, and out = fmaf(v, u term, the lanes' total)."""
    B, S, H, Dk = r.shape
    Dv = v.shape[-1]
    lanes = 64 // rows

    def padded(x):      # [..., Dk] -> [..., 64]
        return torch.nn.functional.pad(x.float(), (0, 64 - Dk))

    rp, kp, wp, up = padded(r), padded(k), padded(w), padded(u)
    vf = v.float()
    state = torch.zeros((B, H, 64, Dv))
    if s0 is not None:
        state[:, :, :Dk] = s0.float()
    state = state.reshape(B, H, lanes, rows, Dv)
    out = torch.empty((B, S, H, Dv))
    for t in range(S):
        rr, kr, wr = (x[:, t].reshape(B, H, lanes, rows)
                      for x in (rp, kp, wp))
        vv = vf[:, t, :, None, :]                      # [B, H, 1, Dv]
        acc = rr[..., 0, None] * state[:, :, :, 0]     # [B, H, lanes, Dv]
        for i in range(rows):
            old = state[:, :, :, i]
            if i:
                acc = _fmaf(rr[..., i, None], old, acc)
            state[:, :, :, i] = wr[..., i, None] * old + kr[..., i, None] * vv
        total = _pairwise(acc.transpose(2, 3))         # [B, H, Dv]
        u_term = _pairwise(rp[:, t] * up * kp[:, t])   # [B, H]
        out[:, t] = _fmaf(vf[:, t], u_term[..., None], total)
    return out, state.reshape(B, H, 64, Dv)[:, :, :Dk].contiguous()


def _rwkv6_f64(r, k, v, w, u, s0=None):
    """The recurrence evaluated in float64."""
    B, S, H, Dk = r.shape
    rd, kd, vd, wd = (x.double() for x in (r, k, v, w))
    ud = u.double()[None, :, :, None]
    state = (torch.zeros((B, H, Dk, v.shape[-1]), dtype=torch.float64)
             if s0 is None else s0.double())
    out = []
    for t in range(S):
        kv = kd[:, t, :, :, None] * vd[:, t, :, None, :]
        out.append(torch.einsum("bhk,bhkv->bhv", rd[:, t], state + ud * kv))
        state = wd[:, t, :, :, None] * state + kv
    return torch.stack(out, dim=1), state


@pytest.mark.parametrize("rows", [8, 4])     # the source's tile, another
@pytest.mark.parametrize("B,S,H,Dk,Dv,with_s0", [
    (1, 256, 64, 64, 64, False),
    (1, 256, 64, 64, 64, True),
    (2, 64, 3, 40, 20, True),       # rows and columns the tiles mask
])
def test_rwkv6_kernel_arithmetic_meets_the_tolerance(B, S, H, Dk, Dv,
                                                     with_s0, rows):
    """The kernel's output arithmetic (lane partial sums over contiguous
    rows, the v * sum r u k term folded in, the shuffle tree) stays within
    1e-5 * max(1, max|out|) of a float64 evaluation and of `rwkv6_ref`, on
    the draws of the JAX package's kernel test; its state update equals
    `rwkv6_ref`'s S_last bit for bit."""
    r, k, v, w, u = map(_t, _rkvwu(B, S, H, Dk, Dv, seed=7))
    s0 = (_t(np.random.default_rng(8).standard_normal(
        (B, H, Dk, Dv)).astype(np.float32)) if with_s0 else None)
    got_o, got_s = _rwkv6_kernel_arithmetic(r, k, v, w, u, s0, rows)
    ref_o, ref_s = rwkv6_ref(r, k, v, w, u, s0=s0)
    f64_o, _ = _rwkv6_f64(r, k, v, w, u, s0)
    assert torch.equal(got_s, ref_s)
    tol = 1e-5 * max(1.0, float(f64_o.abs().max()))
    assert float((got_o.double() - f64_o).abs().max()) < tol
    assert float((got_o - ref_o).abs().max()) < tol


# ---------------------------------------------------------------------- #
# RWKV6 backward, CPU: the plain gradient against the JAX package's, and
# the backward kernel's algorithm
# ---------------------------------------------------------------------- #
# (B, S, H, Dk, Dv): Dk != Dv both ways; S of one chunk of the JAX
# package's chunked form (48) and of two (128)
RWKV_BWD_CASES = [(2, 48, 2, 16, 24), (1, 128, 3, 32, 16)]


def _rwkv_bwd_inputs(B, S, H, Dk, Dv, seed=0):
    """_rkvwu's draws, then s0, dout and dS_last, all normal."""
    rng = np.random.default_rng(seed + 100)
    return _rkvwu(B, S, H, Dk, Dv, seed=seed) + tuple(
        rng.standard_normal(s).astype(np.float32) for s in
        ((B, H, Dk, Dv), (B, S, H, Dv), (B, H, Dk, Dv)))


@pytest.mark.parametrize("form", ["rwkv6_ref", "ops.rwkv6"])
@pytest.mark.parametrize("B,S,H,Dk,Dv", RWKV_BWD_CASES)
def test_rwkv6_bwd_plain_matches_jax(B, S, H, Dk, Dv, form, jx):
    """`rwkv6_bwd_plain` (what the backward kernel is held to) against
    `jax.vjp` of the JAX package's `rwkv6_ref` and of `ops.rwkv6` with
    impl="auto" (the chunked form it trains with off the TPU), with s0
    and the gradients of both outputs: every gradient within
    1e-5·max(1, max|g|) in float32."""
    arrays = _rwkv_bwd_inputs(B, S, H, Dk, Dv)
    r, k, v, w, u, s0, dout, dsl = arrays
    jfn = (jx.ref.rwkv6_ref if form == "rwkv6_ref"
           else lambda *a, s0: jx.ops.rwkv6(*a, s0=s0, impl="auto"))
    _, vjp = jx.jax.vjp(lambda *a: jfn(*a[:5], s0=a[5]),
                        *map(jx.a, arrays[:6]))
    want = vjp((jx.a(dout), jx.a(dsl)))
    got = rwkv6.rwkv6_bwd_plain(*map(_t, arrays))
    assert len(got) == len(want) == 6
    for g, wt in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == wt.shape
        wt = _np(wt).astype(np.float64)
        err = np.abs(_np(g) - wt).max() / max(1.0, np.abs(wt).max())
        assert err < 1e-5, (form, err)


def test_rwkv6_bwd_plain_without_s0_or_an_output_gradient():
    """No s0: ds0 is None; a missing output gradient counts as zero."""
    r, k, v, w, u, s0, dout, dsl = map(_t, _rwkv_bwd_inputs(1, 9, 2, 8, 4))
    full = rwkv6.rwkv6_bwd_plain(r, k, v, w, u, None, dout, dsl)
    assert len(full) == 6 and full[5] is None
    ins = [x.clone().requires_grad_(True) for x in (r, k, v, w, u)]
    out, _ = rwkv6.rwkv6_plain(*ins)
    out.backward(dout)
    for g, x in zip(rwkv6.rwkv6_bwd_plain(r, k, v, w, u, None, dout, None),
                    ins):
        assert torch.equal(g, x.grad)


def _halving(x):
    """Sum over the last dim as (x[:n/2] + x[n/2:]) halved again, in
    float32: the order of the backward kernels' shuffle trees (a
    butterfly over lane bits from the highest, or the reduce-scatter of
    k G over a warp's 8 rows, lane bits 4, 3, 2 pairing rows 4, 2, 1
    apart)."""
    while x.shape[-1] > 1:
        n = x.shape[-1] // 2
        x = x[..., :n] + x[..., n:]
    return x[..., 0]


def _in_order(x):
    """Sum over the last dim one term after another, in float32."""
    total = x[..., 0]
    for i in range(1, x.shape[-1]):
        total = total + x[..., i]
    return total


def _rwkv6_bwd_kernel_algorithm(r, k, v, w, u, s0, dout, dS_last,
                                chunk=16, intervals=16):
    """`csrc/rwkv6_bwd.cu`'s algorithm in float32 on the CPU.

    Time is cut into chunks of `intervals` checkpoint intervals.  G
    entering each chunk comes first: for each chunk but the first the G
    its steps produce from a zero G, sum_t c_t dout_t^T with c_t = r_t D
    and D the running product of w (D = 1 at the chunk's first step,
    then D = D w_t), added over t in ascending order by fmaf; then those
    summaries walked from the last chunk (dS_last there) by
    fmaf(D at the chunk's end, G, walk).  Each chunk then runs on its own
    from its G.  A head's columns fall into groups of 32, walked by the R ranks of a
    cluster (R the power of two covering the groups, at most 8; a rank
    walks n_my groups in turn), a thread holding two rows and four
    columns, eight threads a row pair.  The state is recomputed from the
    forward's checkpoints (every `chunk` steps) one interval at a time and
    G walked backwards; a thread sums its 4 columns by fmaf in column
    order, a row's 8 threads add pairwise ((t0 + t1) + (t2 + t3)) + ...,
    a rank adds its groups in order and the epilogue adds the ranks in
    rank order; v·dout is a product a column halved over a group's 32
    columns, then groups and ranks in order; k G over a row pair by
    fmaf(k1, G1, k0 * G0), over a warp's 4 row pairs by the shuffle
    tree's order, then the 8 warps in order; sum r u k over rows l and
    l + 32 by fmaf,
    halved over the 32 lanes; du a (step slot, row) over a chunk's
    intervals by fmaf, then the 16 slots, then the batch and the chunks
    (b first) in order."""
    B, S, H, Dk = r.shape
    Dv = v.shape[-1]
    groups = -(-Dv // 32)
    R = 1
    while R < groups and R < 8:
        R *= 2
    n_my = -(-groups // R)
    ncol = R * n_my * 32
    pad_r = lambda x: torch.nn.functional.pad(x.float(), (0, 64 - Dk))
    pad_c = lambda x: torch.nn.functional.pad(x.float(), (0, ncol - Dv))
    rp, kp, wp, up = (pad_r(x) for x in (r, k, w, u))
    vp = pad_c(v)
    dp = pad_c(dout) if dout is not None else torch.zeros_like(vp)
    P = torch.zeros((B, H, 64, ncol))
    if s0 is not None:
        P[:, :, :Dk, :Dv] = s0.float()
    ckpts = []
    for t in range(S):
        if t % chunk == 0:
            ckpts.append(P)
        P = wp[:, t, :, :, None] * P + kp[:, t, :, :, None] * vp[:, t, :,
                                                                   None]
    G = torch.zeros_like(P)
    if dS_last is not None:
        G[:, :, :Dk, :Dv] = dS_last.float()
    # G entering each time chunk
    n_tc = -(-len(ckpts) // intervals)
    steps = lambda c: range(c * intervals * chunk,
                            min(S, (c + 1) * intervals * chunk))
    walk, decay = {}, {}
    for c in range(1, n_tc):
        g0, a = torch.zeros_like(P), torch.ones((B, H, 64))
        for t in steps(c):
            g0 = _fmaf((rp[:, t] * a)[..., None], dp[:, t, :, None], g0)
            a = a * wp[:, t]
        walk[c], decay[c] = g0, a
    g_in = {n_tc - 1: G}
    for c in range(n_tc - 1, 0, -1):
        g_in[c - 1] = _fmaf(decay[c][..., None], g_in[c], walk[c])
    dr, dk, dw = (torch.zeros((B, S, H, 64)) for _ in range(3))
    dv = torch.zeros((B, S, H, ncol))
    du_parts = torch.zeros((B, n_tc, H, 64))
    # [..., ncol] -> [..., rank, group of the rank, thread, column]
    split = lambda x: x.reshape(x.shape[:-1] + (R, n_my, 8, 4))
    for n in reversed(range(len(ckpts))):
        if n % intervals == intervals - 1 or n == len(ckpts) - 1:
            G = g_in[n // intervals]
            du_slots = torch.zeros((B, H, 64, chunk))
        P, states = ckpts[n], []
        for t in range(n * chunk, min(S, (n + 1) * chunk)):
            states.append(P)
            P = wp[:, t, :, :, None] * P + kp[:, t, :, :, None] * vp[:, t, :,
                                                                       None]
        for s in reversed(range(len(states))):
            t = n * chunk + s
            Pt, Gt = split(states[s]), split(G)
            vv, dd = split(vp[:, t, :, None]), split(dp[:, t, :, None])
            acc = torch.zeros((3,) + Pt.shape[:-1])
            for c in range(4):
                acc[0] = _fmaf(Pt[..., c], dd[..., c], acc[0])
                acc[1] = _fmaf(Gt[..., c], vv[..., c], acc[1])
                acc[2] = _fmaf(Gt[..., c], Pt[..., c], acc[2])
            rows = _in_order(_in_order(_pairwise(acc)))    # [3, B, H, 64]
            vd_g = _halving((vv * dd)[:, :, 0].flatten(-2))  # [B,H,R,n_my]
            vd = _in_order(_in_order(vd_g))[..., None]     # [B, H, 1]
            ru = rp[:, t] * up
            ruk = _halving(_fmaf(ru[..., 32:], kp[:, t, :, 32:],
                                 ru[..., :32] * kp[:, t, :, :32]))
            dr[:, t] = _fmaf(up * kp[:, t], vd, rows[0])
            dk[:, t] = _fmaf(ru, vd, rows[1])
            dw[:, t] = rows[2]
            du_slots[..., s] = _fmaf(rp[:, t] * kp[:, t], vd,
                                     du_slots[..., s])
            kg = (kp[:, t, :, :, None] * G).reshape(B, H, 8, 4, 2, -1)
            kG = G.reshape(B, H, 8, 4, 2, -1)
            kk = kp[:, t].reshape(B, H, 8, 4, 2, 1)
            pairs = _fmaf(kk[..., 1, :], kG[..., 1, :], kg[..., 0, :])
            warps = _halving(pairs.transpose(-1, -2))     # [B, H, 8, ncol]
            dv[:, t] = _fmaf(ruk[..., None], dp[:, t],
                             _in_order(warps.transpose(-1, -2)))
            G = _fmaf(wp[:, t, :, :, None], G,
                      rp[:, t, :, :, None] * dp[:, t, :, None])
        if n % intervals == 0:
            du_parts[:, n // intervals] = _in_order(du_slots)
    du = _in_order(du_parts.permute(2, 3, 0, 1).flatten(-2))[:, :Dk]
    ds0 = G[:, :, :Dk, :Dv] if s0 is not None else None
    return (dr[..., :Dk], dk[..., :Dk], dv[..., :Dv], dw[..., :Dk], du,
            ds0)


@pytest.mark.parametrize("B,S,H,Dk,Dv,w_case,with_s0,with_dsl,intervals", [
    (2, 37, 2, 16, 24, "uniform", True, True, 16),  # a ragged last interval
    (1, 33, 1, 40, 20, "zero", True, False, 16),
    (1, 20, 2, 8, 72, "tiny", False, True, 16),     # three groups on 4 ranks
    (1, 48, 1, 64, 64, "one", True, True, 16),
    (1, 16, 2, 64, 16, "uniform", False, False, 16),  # one interval, one rank
    (1, 18, 1, 16, 272, "uniform", True, True, 16),   # two groups a rank
    (2, 100, 2, 16, 24, "uniform", True, True, 2),   # four time chunks
])
def test_rwkv6_backward_kernel_algorithm_meets_the_tolerance(
        B, S, H, Dk, Dv, w_case, with_s0, with_dsl, intervals):
    """The backward kernel's algorithm (no division by w anywhere: states
    from checkpoints, not run backwards) stays within 1e-5·max(1, max|g|)
    of the gradient in float64, w = 0, w = 1 and w down to e^-69
    included."""
    r, k, v, w, u, s0, dout, dsl = map(_t, _rwkv_bwd_inputs(B, S, H, Dk,
                                                            Dv, seed=3))
    rng = np.random.default_rng(4)
    w = {"uniform": w, "zero": torch.zeros_like(w),
         "one": torch.ones_like(w),
         "tiny": _t(np.exp(-rng.uniform(0, 69, w.shape)).astype(
             np.float32))}[w_case]
    s0 = s0 if with_s0 else None
    dsl = dsl if with_dsl else None
    got = _rwkv6_bwd_kernel_algorithm(r, k, v, w, u, s0, dout, dsl,
                                      intervals=intervals)
    want = rwkv6.rwkv6_bwd_plain(*(x.double() if x is not None else None
                                   for x in (r, k, v, w, u, s0, dout, dsl)))
    for g, wt in zip(got, want):
        assert (g is None) == (wt is None)
        if wt is not None:
            assert g.shape == wt.shape
            err = float((g.double() - wt).abs().max()) / max(
                1.0, float(wt.abs().max()))
            assert err < 1e-5, (w_case, err)


# ---------------------------------------------------------------------- #
# every wrapper is differentiable: off the CPU a tensor that autograd
# would follow reaches the kernel path, and the CPU keeps the
# differentiable plain version
# ---------------------------------------------------------------------- #
def _wrapper_calls(device):
    """Each wrapper's call, taking its inputs as a list so one of them can
    be made to require grad: (name, inputs, call)."""
    q = torch.ones((1, 4, 2, 16), device=device)
    # MLA's head dims: q and k of 192, v of 128
    qk = torch.full((1, 4, 2, 192), 0.1, device=device)
    x = torch.full((1, 4, 16), 0.5, device=device)
    u = torch.ones((2, 16), device=device)
    s0 = torch.ones((1, 2, 16, 16), device=device)
    return [
        ("flash_attention", [q, q.clone(), q.clone()],
         lambda t: fa.flash_attention(*t)),
        ("flash_attention_mla",
         [qk, qk.clone(), torch.ones((1, 4, 2, 128), device=device)],
         lambda t: fa.flash_attention(*t)),
        ("rglru_scan", [x, x.clone(), torch.ones((1, 16), device=device)],
         lambda t: rglru.rglru_scan(*t)),
        ("rwkv6_scan", [q, q.clone(), q.clone(), q.clone(), u, s0],
         lambda t: rwkv6.rwkv6_scan(*t)),
    ]


GRAD_CASES = [(w, i) for w, n in (("flash_attention", 3),
                                  ("flash_attention_mla", 3),
                                  ("rglru_scan", 3), ("rwkv6_scan", 6))
              for i in range(n)]


def _grad_case(device, wrapper, i):
    name, inputs, call = next(c for c in _wrapper_calls(device)
                              if c[0] == wrapper)
    inputs = [t.clone() for t in inputs]
    inputs[i].requires_grad_(True)
    return inputs, call


@pytest.mark.parametrize("wrapper,i", GRAD_CASES)
def test_kernel_wrappers_with_grad_reach_the_device_check_off_the_cpu(
        wrapper, i):
    """Off the CPU every wrapper takes an input that requires grad to its
    kernel path (each has its backward kernel): a `meta` input reaches the
    device-type check and raises there, as it does under no_grad and
    inference_mode; nothing is launched."""
    inputs, call = _grad_case("meta", wrapper, i)
    before = (fa.launches, rglru.launches, rwkv6.launches,
              fa.launches_bwd, rglru.launches_bwd, rwkv6.launches_bwd)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        call(inputs)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CPU or CUDA"):
            call(inputs)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="CPU or CUDA"):
            call([t.detach() for t in inputs])
    assert (fa.launches, rglru.launches, rwkv6.launches,
            fa.launches_bwd, rglru.launches_bwd,
            rwkv6.launches_bwd) == before


@pytest.mark.parametrize("wrapper,i", GRAD_CASES)
def test_kernel_wrappers_stay_differentiable_on_the_cpu(wrapper, i):
    inputs, call = _grad_case("cpu", wrapper, i)
    out = call(inputs)
    out = out[0] if isinstance(out, tuple) else out
    assert out.grad_fn is not None
    out.sum().backward()
    assert inputs[i].grad is not None
    assert bool(torch.isfinite(inputs[i].grad).all())


# ---------------------------------------------------------------------- #
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_CASES + [
    (1, 300, 300, 16, 1, 256, True, 128, None, "float32"),
    (1, 70, 70, 4, 1, 16, True, None, None, "float32"),
    # float32 (256, 256)'s halves body: MQA with a window over several
    # 32-key tiles, a softcap and Sq != Sk, ragged in both
    (1, 200, 333, 16, 1, 256, True, 100, 50.0, "float32"),
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


# (Sq, Sk, Hq, Hkv, causal, window, softcap, q_offset): edges of the
# 64-row q tile and 32-key k tile
FA_EDGES = [
    (77, 77, 2, 1, True, None, None, 0),        # Sq, Sk not tile multiples
    (20, 9, 2, 2, False, None, None, 0),        # Sk shorter than one tile
    (100, 100, 4, 2, True, 7, None, 0),         # window smaller than a tile
    (70, 130, 2, 1, True, 48, 30.0, 60),        # softcap, static q_offset
    # lengths one short of, at and one past the wgmma body's tiles: 64 q
    # rows a warpgroup, 64 or 128 a block, 16-, 32-, 64- and 128-key tiles
    (127, 127, 2, 1, True, None, None, 0),
    (128, 128, 2, 2, True, 16, None, 0),
    (129, 129, 4, 2, False, None, None, 0),
    (63, 65, 2, 1, False, None, None, 0),
    (65, 33, 2, 1, True, None, None, 32),
    (64, 31, 2, 2, False, None, None, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("edge", FA_EDGES)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_flash_attention_kernel_every_head_dim(D, dt, edge, cuda_device):
    Sq, Sk, Hq, Hkv, causal, window, cap, q_offset = edge
    q, k, v = (_t(a, dt, cuda_device) for a in _qkv(
        (2, Sq, Sk, Hq, Hkv, D), seed=D))
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             softcap=cap, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    softcap=cap, q_offset=q_offset)
    assert got.dtype == q.dtype and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    assert err < TOL[dt], (D, dt, edge, err)
    # two calls give the same bits, and the log-sum-exp leaves out as it is
    again = fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=cap, q_offset=q_offset)
    with_lse, lse = fa._launch(q, k, v, causal, window, cap, D ** -0.5,
                               q_offset, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, with_lse)
    assert lse.shape == (2, Hq, Sq) and bool(torch.isfinite(lse).all())


# (B, S, D, dtype): D of a ragged, an unaligned and a full row; S of one
# step, shorter than a tile and one short of a tile multiple
RGLRU_STRESS = [(2 if D == 4096 else 1, S, D, "float32")
                for D in (33, 96, 4096) for S in (1, 33, 3071)] + [
    (1, 33, 33, "bfloat16"), (2, 3071, 96, "bfloat16"),
    (2, 33, 4096, "bfloat16"), (1, 1, 4096, "bfloat16")]


def _rglru_on_card(x, a, h0, dt):
    """Run the kernel once and hold it to the plain version: float32 bit
    for bit (the kernel rounds each operation as the plain version does),
    bfloat16 within 3e-2."""
    before = rglru.launches
    h, last = rglru.rglru_scan(x, a, h0)
    torch.cuda.synchronize()
    assert rglru.launches == before + 1
    want_h, want_last = rglru.rglru_plain(x, a, h0)
    assert h.dtype == x.dtype and last.dtype == x.dtype
    if dt == "float32":
        assert torch.equal(h, want_h) and torch.equal(last, want_last)
    else:
        assert float((h.float() - want_h.float()).abs().max()) < 3e-2
        assert float((last.float() - want_last.float()).abs().max()) < 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,bd,dt", RGLRU_CASES + [
    (2, 300, 4096, 128, "float32")] + [
    (B, S, D, 0, dt) for B, S, D, dt in RGLRU_STRESS])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_kernel_matches_plain(B, S, D, bd, dt, with_h0, cuda_device):
    x, a = (_t(t, dt, cuda_device) for t in _xa(B, S, D))
    h0 = torch.randn((B, D), device=cuda_device) if with_h0 else None
    _rglru_on_card(x, a, h0, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rglru_kernel_on_an_unaligned_view(dt, cuda_device):
    """x and a one element into their storage: contiguous, but not 16-byte
    aligned, so the kernel takes its element-wise path."""
    B, S, D = 2, 70, 4096
    xs, as_ = (np.concatenate([[0.5], t.ravel()]).astype(np.float32)
               for t in _xa(B, S, D, seed=3))
    x = _t(xs, dt, cuda_device)[1:].view(B, S, D)
    a = _t(as_, dt, cuda_device)[1:].view(B, S, D)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _rglru_on_card(x, a, torch.randn((B, D), device=cuda_device), dt)


@pytest.mark.cuda
def test_rglru_kernel_gate_is_exact_for_every_a(cuda_device):
    """S = 1, x = 1, h0 = 0: h is the kernel's gate sqrt(clip(1 - a^2, 0,
    1)), whose square root is branch-free and not sqrtf.  It equals the
    plain version's for every float a in [0, 1] and for -0.5, 1.5 and 2."""
    a = torch.arange(0, 0x3F800001, dtype=torch.int32, device=cuda_device)
    a = torch.cat([a.view(torch.float32), torch.tensor(
        [-0.5, 1.5, 2.0], device=cuda_device)]).view(1, 1, -1)
    x = torch.ones_like(a)
    h, last = rglru.rglru_scan(x, a)
    torch.cuda.synchronize()
    want_h, want_last = rglru.rglru_plain(x, a)
    assert torch.equal(h, want_h) and torch.equal(last, want_last)


def _rwkv_on(device, dtype, B, S, H, Dk, Dv, seed=0):
    return tuple(_t(a, dtype, device)
                 for a in _rkvwu(B, S, H, Dk, Dv, seed=seed))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Dk,Dv,dt", [
    *(c + ("float32",) for c in RWKV_CASES),
    (2, 100, 4, 64, 64, "float32"),     # a ragged last round of steps
    (1, 70, 3, 40, 20, "float32"),      # Dk not a multiple of 16
    (2, 48, 4, 64, 64, "bfloat16"),
    # the register tiles: Dk of 1, 5 and all 8 row lanes, Dv short of the
    # block's 64 columns, 33 steps (not a multiple of a round)
    *((1, 33, 2, Dk, Dv, "float32") for Dk in (8, 40, 64)
      for Dv in (20, 24, 64)),
    (4, 1, 8, 64, 64, "float32"),       # one step: the decode shape
    (2, 1, 3, 40, 24, "bfloat16"),
    (1, 37, 2, 8, 20, "bfloat16"),
])
@pytest.mark.parametrize("with_s0", [False, True])
def test_rwkv6_kernel_matches_plain(B, S, H, Dk, Dv, dt, with_s0,
                                    cuda_device):
    """out to 1e-5 (the JAX package's kernel tolerance; bfloat16 2e-2),
    both relative to max(1, max|out|); S_last exactly: the kernel rounds
    w*S + kv as the plain version's two operations do."""
    r, k, v, w, _ = _rwkv_on(cuda_device, dt, B, S, H, Dk, Dv)
    u = _t(_rkvwu(B, S, H, Dk, Dv)[4], device=cuda_device)
    s0 = (torch.randn((B, H, Dk, Dv), device=cuda_device)
          if with_s0 else None)
    before = rwkv6.launches
    out, s_last = rwkv6.rwkv6_scan(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert rwkv6.launches == before + 1
    want_o, want_s = rwkv6.rwkv6_plain(r, k, v, w, u, s0)
    assert out.dtype == r.dtype and s_last.dtype == torch.float32
    tol = (1e-5 if dt == "float32" else 2e-2) * max(
        1.0, float(want_o.float().abs().max()))
    assert float((out.float() - want_o.float()).abs().max()) < tol
    assert torch.equal(s_last, want_s)


@pytest.mark.cuda
def test_rwkv6_kernel_decode_step_with_state(cuda_device):
    """S=1 with s0: the decode shape, as every decode step launches it."""
    r, k, v, w, _ = _rwkv_on(cuda_device, "float32", 4, 1, 64, 64, 64)
    u = _t(_rkvwu(4, 1, 64, 64, 64)[4], device=cuda_device)
    s0 = torch.randn((4, 64, 64, 64), device=cuda_device)
    out, s_last = ops.rwkv6(r, k, v, w, u, s0=s0)
    torch.cuda.synchronize()
    want_o, want_s = rwkv6.rwkv6_plain(r, k, v, w, u, s0)
    tol = 1e-5 * max(1.0, float(want_o.abs().max()))
    assert float((out - want_o).abs().max()) < tol
    assert torch.equal(s_last, want_s)
    empty = r[:, :0].contiguous()
    before = rwkv6.launches
    out, s_last = rwkv6.rwkv6_scan(empty, empty, empty, empty, u, s0)
    assert rwkv6.launches == before and out.shape == (4, 0, 64, 64)
    assert torch.equal(s_last, s0)


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper,i", [c for c in GRAD_CASES
                                       if c[0] == "rwkv6_scan"])
def test_kernel_wrappers_with_grad_return_a_grad_fn_on_the_card(
        wrapper, i, cuda_device):
    """The RWKV6 wrapper, given any one input that requires grad, launches
    its forward kernel and returns outputs with a `grad_fn`, whose
    backward launches the backward kernel once; under no_grad the forward
    alone, with no `grad_fn`."""
    inputs, call = _grad_case(cuda_device, wrapper, i)
    before, before_bwd = rwkv6.launches, rwkv6.launches_bwd
    out, s_last = call(inputs)
    assert out.grad_fn is not None and s_last.grad_fn is not None
    assert rwkv6.launches == before + 1
    (out.sum() + s_last.sum()).backward()
    torch.cuda.synchronize()
    assert rwkv6.launches_bwd == before_bwd + 1
    assert bool(torch.isfinite(inputs[i].grad).all())
    with torch.no_grad():
        out = call(inputs)
    torch.cuda.synchronize()
    assert rwkv6.launches == before + 2
    assert rwkv6.launches_bwd == before_bwd + 1
    out = out[0] if isinstance(out, tuple) else out
    assert out.device.type == "cuda" and out.grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper,i", [c for c in GRAD_CASES
                                       if c[0] != "rwkv6_scan"])
def test_kernel_wrappers_are_differentiable_on_the_card(wrapper, i,
                                                        cuda_device):
    """Flash attention (at equal head dims and at MLA's) and RG-LRU launch
    their forward kernel with an output autograd follows, and their
    backward kernel for its gradient; under no_grad the forward alone."""
    inputs, call = _grad_case(cuda_device, wrapper, i)
    mod = {"flash_attention": fa, "flash_attention_mla": fa,
           "rglru_scan": rglru}[wrapper]
    before, before_bwd = mod.launches, mod.launches_bwd
    out = call(inputs)
    out = out[0] if isinstance(out, tuple) else out
    assert out.grad_fn is not None and mod.launches == before + 1
    out.sum().backward()
    torch.cuda.synchronize()
    assert mod.launches_bwd == before_bwd + 1
    assert bool(torch.isfinite(inputs[i].grad).all())
    with torch.no_grad():
        out = call(inputs)
    out = out[0] if isinstance(out, tuple) else out
    assert out.grad_fn is None and mod.launches == before + 2
    assert mod.launches_bwd == before_bwd + 1


# ---------------------------------------------------------------------- #
# on the card: the backward kernels against the plain versions' autograd
# ---------------------------------------------------------------------- #
# the plain version's gradient in float64 on the card is the reference
BWD_TOL = {"float32": 5e-5, "bfloat16": 2e-2}
# the training shapes: one smollm-360m layer (15 heads of 64 on 5 kv
# heads, causal) and one recurrentgemma-9b attention layer (16 heads of
# 256 on one kv head, window 2048), at shorter sequences; then
# seamless-m4t-large-v2's (16 heads of 64 on 16): the cross attention
# (Sq 300 by 1,000 frames) and the encoder (1,000 by itself), no mask,
# and the decoder's self-attention, causal
FA_BWD_CASES = FA_CASES + [
    (1, 512, 512, 15, 5, 64, True, None, None, "float32"),
    (1, 512, 512, 15, 5, 64, True, None, None, "bfloat16"),
    (1, 2304, 2304, 16, 1, 256, True, 2048, None, "float32"),
    (1, 2304, 2304, 16, 1, 256, True, 2048, None, "bfloat16"),
    (1, 70, 130, 4, 2, 128, True, 48, 30.0, "float32"),   # q_offset 60
    # float32 (256, 256) by column halves: MQA, a window over several
    # tiles, a softcap, Sq != Sk, ragged 64-row and 32-row tiles
    (1, 200, 333, 16, 1, 256, True, 100, 50.0, "float32"),
] + [(1, Sq, Sk, 16, 16, 64, causal, None, None, dt)
     for Sq, Sk, causal in ((300, 1000, False), (1000, 1000, False),
                            (1000, 1000, True))
     for dt in ("float32", "bfloat16")]


def _grad_err(got, want) -> float:
    """max |got - want| over max(1, max |want|), the tolerance's scale."""
    want = want.double()
    return float((got.double() - want).abs().max()) / max(
        1.0, float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_BWD_CASES)
def test_flash_attention_backward_kernel_matches_plain(case, cuda_device):
    causal, window, cap, dt = case[6:]
    q_offset = 60 if case[1:3] == (70, 130) else 0
    q, k, v = (_t(a, dt, cuda_device) for a in _qkv(case))
    dout = _t(np.random.default_rng(7).standard_normal(q.shape).astype(
        np.float32), dt, cuda_device)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset)
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = fa.launches_bwd
    out = fa.flash_attention(*qkv, **kw)
    out.backward(dout)
    torch.cuda.synchronize()
    assert fa.launches_bwd == before + 1
    want = fa.flash_attention_bwd_plain(q.double(), k.double(), v.double(),
                                        dout.double(), **kw)
    for x, w in zip(qkv, want):
        assert x.grad.dtype == x.dtype and x.grad.shape == x.shape
        err = _grad_err(x.grad, w)
        assert err < BWD_TOL[dt], (case, err)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, (192, 128)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flash_attention_backward_is_deterministic_and_keeps_out(
        dt, D, cuda_device):
    """Two backward calls give the same bits (no atomics), and the forward
    output is the same with and without the log-sum-exp write: at head
    dim 64 (15 heads on 5) and at MLA's (192, 128) (8 heads on 2)."""
    Dqk, Dv = D if isinstance(D, tuple) else (D, D)
    Hq, Hkv = (15, 5) if Dqk == Dv else (8, 2)
    case = (2, 384, 384, Hq, Hkv, Dqk, True, None, None, dt)
    q, k, v = _qkv(case)
    if Dv != Dqk:
        v = _qkv(case[:5] + (Dv,) + case[6:], seed=1)[2]
    q, k, v = (_t(a, dt, cuda_device) for a in (q, k, v))
    dout = torch.randn(q.shape[:3] + (Dv,), device=q.device).to(q.dtype)
    with torch.no_grad():
        plain_out = fa.flash_attention(q, k, v)
    grads = []
    for _ in range(2):
        qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fa.flash_attention(*qkv)
        assert torch.equal(out.detach(), plain_out)
        out.backward(dout)
        grads.append([x.grad for x in qkv])
    torch.cuda.synchronize()
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# FA_EDGES, then GQA groups of 3 (path A's 15 heads on 5) and 16 (MQA), at
# lengths that are not a multiple of the backward's tiles (64 streamed
# rows; 48, 64 or fewer owned rows a warpgroup), then last 64-row tiles of
# 2 and 3 rows, Sq != Sk without a mask, then lengths around the bf16
# (192, 128) body's 128 owned rows a block (127, 129, 200)
FA_BWD_EDGES = FA_EDGES + [
    (150, 150, 15, 5, True, None, None, 0),
    (100, 100, 16, 1, True, 7, None, 0),
    (66, 66, 4, 2, True, None, None, 0),
    (131, 195, 2, 2, False, None, None, 0),
    (127, 127, 4, 2, True, None, None, 0),
    (129, 200, 2, 2, False, None, None, 0),
    (200, 200, 8, 2, True, 64, None, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("edge", FA_BWD_EDGES)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", fa.HEAD_DIMS + ((192, 128),))
def test_flash_attention_backward_every_head_dim(D, dt, edge, cuda_device):
    """Every instantiation of the backward (each head dim, and MLA's
    (Dqk, Dv) = (192, 128) with independent q, k and v) against the plain
    version's autograd in float64, dq, dk and dv each, and two calls
    bit-identical."""
    Sq, Sk, Hq, Hkv, causal, window, cap, q_offset = edge
    Dqk, Dv = D if isinstance(D, tuple) else (D, D)
    q, k, v = _qkv((2, Sq, Sk, Hq, Hkv, Dqk), seed=Dqk)
    if Dv != Dqk:
        v = _qkv((2, Sq, Sk, Hq, Hkv, Dv), seed=Dqk + 1)[2]
    q, k, v = (_t(a, dt, cuda_device) for a in (q, k, v))
    dout = _t(np.random.default_rng(Dqk + 1).standard_normal(
        (2, Sq, Hq, Dv)).astype(np.float32), dt, cuda_device)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset)
    grads = []
    for _ in range(2):
        qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = fa.launches_bwd
        fa.flash_attention(*qkv, **kw).backward(dout)
        torch.cuda.synchronize()
        assert fa.launches_bwd == before + 1
        grads.append([x.grad for x in qkv])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    want = fa.flash_attention_bwd_plain(q.double(), k.double(), v.double(),
                                        dout.double(), **kw)
    for got, w in zip(grads[0], want):
        assert got.dtype == q.dtype and got.shape == w.shape
        err = _grad_err(got, w)
        assert err < BWD_TOL[dt], (D, dt, edge, err)


def _rglru_grads(x, a, h0, dh, dh_last):
    ins = [t.clone().requires_grad_(True) for t in (x, a)]
    if h0 is not None:
        ins.append(h0.clone().requires_grad_(True))
    h, h_last = rglru.rglru_scan(*ins)
    torch.autograd.backward((h, h_last), (dh, dh_last))
    return [t.grad for t in ins] + ([None] if h0 is None else [])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,bd,dt", RGLRU_CASES + [
    (1, 3072, 4096, 0, "float32"), (1, 3072, 4096, 0, "bfloat16"),
    (2, 33, 33, 0, "float32"), (1, 1, 96, 0, "float32")])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_backward_kernel_matches_plain(B, S, D, bd, dt, with_h0,
                                             cuda_device):
    x, a = (_t(t, dt, cuda_device) for t in _xa(B, S, D))
    h0 = torch.randn((B, D), device=cuda_device) if with_h0 else None
    dh = torch.randn((B, S, D), device=cuda_device).to(x.dtype)
    dh_last = torch.randn((B, D), device=cuda_device).to(x.dtype)
    before = rglru.launches_bwd
    got = _rglru_grads(x, a, h0, dh, dh_last)
    torch.cuda.synchronize()
    assert rglru.launches_bwd == before + 1
    want = rglru.rglru_bwd_plain(
        x.double(), a.double(), h0.double() if h0 is not None else None,
        dh.double(), dh_last.double())
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        err = _grad_err(g, w)
        assert err < BWD_TOL[dt], (B, S, D, dt, err)
    again = _rglru_grads(x, a, h0, dh, dh_last)
    for g, w in zip(got, again):
        assert g is None or torch.equal(g, w)


@pytest.mark.cuda
def test_rglru_backward_kernel_at_the_gate_edges(cuda_device):
    """S = 1, x = 1, h0 = 0, dh = 1: the gradients of the gate
    sqrt(clip(1 - a^2, 0, 1)) on every 64th float a in [0, 1], its ends
    (where the square root's gradient is infinite) and outside [-1, 1]
    (where clip passes none): equal to the plain version's autograd in
    float32, NaN and infinities included."""
    a = torch.arange(0, 0x3F800001, 64, dtype=torch.int32,
                     device=cuda_device).view(torch.float32)
    edges = torch.tensor([0.0, 1.0, -1.0, 0.9999999, -0.5, 1.5, 2.0,
                          -2.0, 1e-30], device=cuda_device)
    a = torch.cat([a, edges]).view(1, 1, -1)
    x = torch.ones_like(a)
    h0 = torch.zeros_like(a[:, 0])
    dh = torch.ones_like(a)
    dh_last = torch.zeros_like(h0)
    got = _rglru_grads(x, a, h0, dh, dh_last)
    want = rglru.rglru_bwd_plain(x, a, h0, dh, dh_last)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0,with_dl", [(True, True), (False, False),
                                             (True, False)])
@pytest.mark.parametrize("steps", ["one", "short", "chunk", "ragged",
                                   "chunks_and_3", "zero"])
def test_rglru_backward_kernel_on_every_chunk_edge(steps, with_h0, with_dl,
                                                   dt, cuda_device):
    """The time-parallel backward at S of one step, one short of a chunk,
    one chunk, one past it, two chunks and 3, and S = 0 (dh0 = dh_last):
    within BWD_TOL of the plain version's autograd in float64, two calls
    bit-identical, one backward call."""
    C = rglru.chunk_steps()
    S = {"one": 1, "short": C - 1, "chunk": C, "ragged": C + 1,
         "chunks_and_3": 2 * C + 3, "zero": 0}[steps]
    B, D = 2, 200
    x, a = (_t(t, dt, cuda_device) for t in _xa(B, S, D, seed=S))
    h0 = torch.randn((B, D), device=cuda_device) if with_h0 else None
    dh = torch.randn((B, S, D), device=cuda_device).to(x.dtype)
    dl = torch.randn((B, D), device=cuda_device).to(x.dtype)
    if not with_dl:
        dl = torch.zeros_like(dl)
    before = rglru.launches_bwd
    got = _rglru_grads(x, a, h0, dh, dl)
    torch.cuda.synchronize()
    assert rglru.launches_bwd == before + 1
    again = _rglru_grads(x, a, h0, dh, dl)
    for g, w in zip(got, again):
        assert g is None or torch.equal(g, w)
    if S == 0:
        assert got[0].shape == got[1].shape == (B, 0, D)
        if with_h0:
            assert torch.equal(got[2], dl.float())
        return
    want = rglru.rglru_bwd_plain(
        x.double(), a.double(), h0.double() if h0 is not None else None,
        dh.double(), dl.double())
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert _grad_err(g, w) < BWD_TOL[dt], (S, dt)


# ---------------------------------------------------------------------- #
# on the card: the RWKV6 backward kernel against the plain gradient
# ---------------------------------------------------------------------- #
RWKV_BWD_CARD_CASES = [c + ("float32",) for c in RWKV_CASES] + [
    (1, 33, 2, 8, 20, "float32"),       # Dk short of the kernel's 64 rows
    (1, 33, 2, 40, 24, "float32"),      # Dv short of a column group
    (1, 70, 3, 64, 64, "float32"),      # a ragged last interval
    (2, 40, 2, 64, 40, "float32"),
    (1, 512, 8, 64, 64, "float32"),
    (1, 512, 8, 64, 64, "bfloat16"),
    (1, 37, 2, 40, 24, "bfloat16"),
]


def _rwkv_bwd_on_card(shape, dt, device, w_case="uniform", seed=0):
    """r, k, v, w, u, s0, dout, dS_last on the card: _rwkv_bwd_inputs'
    draws, w replaced by 0, 1 or exp(-uniform(0, 69)) on request."""
    B, S, H, Dk, Dv = shape
    arrays = list(_rwkv_bwd_inputs(B, S, H, Dk, Dv, seed=seed))
    rng = np.random.default_rng(seed + 7)
    arrays[3] = {"uniform": arrays[3], "zero": np.zeros_like(arrays[3]),
                 "one": np.ones_like(arrays[3]),
                 "tiny": np.exp(-rng.uniform(0, 69, arrays[3].shape))
                 .astype(np.float32)}[w_case]
    return [_t(a, dt if i in (0, 1, 2, 3, 6) else "float32", device)
            for i, a in enumerate(arrays)]


def _rwkv_grads(r, k, v, w, u, s0, dout, dsl):
    """The gradients of r, k, v, w, u (and s0) through `rwkv6_scan`."""
    ins = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)] + (
        [s0.clone().requires_grad_(True)] if s0 is not None else [])
    out, s_last = rwkv6.rwkv6_scan(*ins[:5], ins[5] if s0 is not None
                                   else None)
    outs, grads = [out], [dout]
    if dsl is not None:
        outs.append(s_last)
        grads.append(dsl)
    torch.autograd.backward(outs, grads)
    return [t.grad for t in ins] + ([None] if s0 is None else [])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Dk,Dv,dt", RWKV_BWD_CARD_CASES)
@pytest.mark.parametrize("with_s0,with_dsl", [(True, True), (False, False),
                                              (True, False)])
def test_rwkv6_backward_kernel_matches_plain(B, S, H, Dk, Dv, dt, with_s0,
                                             with_dsl, cuda_device):
    """The backward kernel against the plain version's autograd in
    float64 on the card: every gradient within 5e-5·max(1, max|g|) in
    float32 and 2e-2 in bfloat16 (BWD_TOL); one backward launch."""
    r, k, v, w, u, s0, dout, dsl = _rwkv_bwd_on_card((B, S, H, Dk, Dv), dt,
                                                     cuda_device)
    s0 = s0 if with_s0 else None
    dsl = dsl if with_dsl else None
    before = rwkv6.launches_bwd
    got = _rwkv_grads(r, k, v, w, u, s0, dout, dsl)
    torch.cuda.synchronize()
    assert rwkv6.launches_bwd == before + 1
    want = rwkv6.rwkv6_bwd_plain(*(t.double() if t is not None else None
                                   for t in (r, k, v, w, u, s0, dout, dsl)))
    for g, wt, x in zip(got, want, (r, k, v, w, u, s0)):
        assert (g is None) == (wt is None)
        if wt is not None:
            assert g.dtype == x.dtype and g.shape == x.shape
            err = _grad_err(g, wt)
            assert err < BWD_TOL[dt], ((B, S, H, Dk, Dv, dt), err)


@pytest.mark.cuda
@pytest.mark.parametrize("w_case", ["zero", "one", "tiny"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rwkv6_backward_kernel_at_the_decay_edges(w_case, dt, cuda_device):
    """w = 0, w = 1 and w down to e^-69: nothing divides by w, so the
    gradients meet the tolerance there too."""
    r, k, v, w, u, s0, dout, dsl = _rwkv_bwd_on_card((1, 100, 4, 64, 64),
                                                     dt, cuda_device, w_case)
    got = _rwkv_grads(r, k, v, w, u, s0, dout, dsl)
    want = rwkv6.rwkv6_bwd_plain(*(t.double() for t in
                                   (r, k, v, w, u, s0, dout, dsl)))
    for g, wt in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert _grad_err(g, wt) < BWD_TOL[dt], (w_case, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rwkv6_backward_is_deterministic_and_keeps_out(dt, cuda_device):
    """Two backward calls give the same bits (no atomics), and out and
    S_last are the same bits with and without the checkpoint write."""
    r, k, v, w, u, s0, dout, dsl = _rwkv_bwd_on_card((2, 300, 8, 64, 64),
                                                     dt, cuda_device)
    with torch.no_grad():
        want = rwkv6.rwkv6_scan(r, k, v, w, u, s0)
    out, s_last, ckpt = rwkv6._launch(r, k, v, w, u, s0, with_ckpt=True)
    assert torch.equal(out, want[0]) and torch.equal(s_last, want[1])
    # the checkpoints are the states before every ckpt_steps()-th step
    n = rwkv6.ckpt_steps()
    with torch.no_grad():
        _, s_mid = rwkv6.rwkv6_scan(*(x[:, :n].contiguous()
                                      for x in (r, k, v, w)), u, s0)
    assert torch.equal(ckpt[:, :, 0], s0) and torch.equal(ckpt[:, :, 1],
                                                          s_mid)
    first = _rwkv_grads(r, k, v, w, u, s0, dout, dsl)
    again = _rwkv_grads(r, k, v, w, u, s0, dout, dsl)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("Dv", [40, 144, 300])
def test_rwkv6_backward_kernel_on_wide_heads(Dv, cuda_device):
    """Dv of two column groups of 32 (a cluster of 2 ranks), of five (8
    ranks, three of them without columns) and of 10 (8 ranks, some
    walking two groups in turn, their G kept in the scratch): within
    BWD_TOL of the plain version's autograd in float64, two calls
    bit-identical."""
    r, k, v, w, u, s0, dout, dsl = _rwkv_bwd_on_card((1, 37, 2, 64, Dv),
                                                     "float32", cuda_device)
    got = _rwkv_grads(r, k, v, w, u, s0, dout, dsl)
    again = _rwkv_grads(r, k, v, w, u, s0, dout, dsl)
    torch.cuda.synchronize()
    want = rwkv6.rwkv6_bwd_plain(*(t.double() for t in
                                   (r, k, v, w, u, s0, dout, dsl)))
    for g, g2, wt in zip(got, again, want):
        assert torch.equal(g, g2)
        assert _grad_err(g, wt) < BWD_TOL["float32"], Dv
