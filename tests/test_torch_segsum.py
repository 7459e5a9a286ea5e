"""The port's segment sum against the JAX package's and the numpy oracles.

On CPU tensors `repro_torch`'s `segment_sum` runs its plain version; it
must be bit-identical to `repro.core.pallas.segment_sum` (run as that
package's own tests run it on the CPU, in interpret mode) and to the
sequential numpy oracles `np.add.at` / `np.bincount`, for float64 and
int64, and within rtol 1e-12 of the pairwise `np.add.reduceat` (an
eps-scaled atol covers segments that cancel to ~0).  The cases marked
`cuda` hold the CUDA kernel against the plain version on the card and
skip without one.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.cuda import _build, segsum  # noqa: E402
from repro_torch.core.cuda.segsum import keyed_sum, segment_sum  # noqa: E402


@pytest.fixture(scope="module")
def ref_pallas():
    """The JAX package's Pallas segment-sum module, in interpret mode.

    Its x64 scope calls `jax.experimental.enable_x64`, which JAX 0.9
    removed in favour of `jax.enable_x64`; while these tests run, the old
    name is pointed at the new context manager.  Nothing in the JAX
    package changes, and the probe's cached result is restored after.
    """
    jax = pytest.importorskip("jax")
    import jax.experimental
    from repro.core.pallas import segsum as ref
    with pytest.MonkeyPatch.context() as mp:
        try:
            jax.experimental.enable_x64
        except AttributeError:
            mp.setattr(jax.experimental, "enable_x64",
                       lambda: jax.enable_x64(True), raising=False)
        mp.setattr(ref, "_probe_result", None)
        if not ref.pallas_available():
            pytest.skip(f"pallas layer unusable here: {ref._probe_error!r}")
        yield ref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _oracle_sequential(data, sids, nseg):
    out = np.zeros(nseg, dtype=data.dtype)
    np.add.at(out, sids, data)
    return out


def _oracle_reduceat(data, sids, nseg):
    out = np.zeros(nseg, dtype=data.dtype)
    if len(data) == 0:
        return out
    present, starts = np.unique(sids, return_index=True)
    out[present] = np.add.reduceat(data, starts)
    return out


def _check(data, sids, nseg):
    got = segment_sum(_t(data), _t(sids), nseg).numpy()
    want = _oracle_sequential(data, sids, nseg)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if np.issubdtype(data.dtype, np.integer):
        np.testing.assert_array_equal(got, _oracle_reduceat(data, sids, nseg))
    else:
        atol = 1e-12 * max(1.0, float(np.abs(data).sum()))
        np.testing.assert_allclose(got, _oracle_reduceat(data, sids, nseg),
                                   rtol=1e-12, atol=atol)
    return got


LAYOUTS = [
    # (m, nseg, block, layout): the JAX package's block-boundary stress set
    (0, 5, 8, "empty-stream"),
    (7, 1, 4, "single-segment-tail"),
    (64, 1, 8, "one-giant-segment-8-blocks"),
    (33, 50, 8, "non-divisible-tail"),
    (24, 200, 8, "mostly-empty-segments"),
    (48, 3, 16, "segment-spanning-3-blocks"),
]


def _layout(m, nseg, layout, dtype):
    rng = np.random.default_rng(zlib.crc32(layout.encode()))
    if layout == "one-giant-segment-8-blocks":
        sids = np.zeros(m, np.int64)
    elif layout == "segment-spanning-3-blocks":
        sids = np.r_[np.zeros(4), np.ones(40), np.full(4, 2)].astype(np.int64)
    else:
        sids = np.sort(rng.integers(0, nseg, m))
    data = rng.integers(-50, 50, m).astype(dtype)
    if dtype is np.float64:
        data *= np.pi
    return data, sids


@pytest.mark.parametrize("m,nseg,block,layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [np.float64, np.int64])
def test_handcrafted_layouts_match_reference(m, nseg, block, layout, dtype,
                                             ref_pallas):
    data, sids = _layout(m, nseg, layout, dtype)
    got = _check(data, sids, nseg)
    ref = np.asarray(ref_pallas.segment_sum(data, sids, nseg,
                                            block_size=block))
    assert ref.dtype == got.dtype
    np.testing.assert_array_equal(got, ref)


def test_int_weights_bit_identical_large():
    rng = np.random.default_rng(3)
    m, nseg = 20_000, 511
    sids = np.sort(rng.integers(0, nseg, m))
    data = rng.integers(-10**9, 10**9, m)
    _check(data, sids, nseg)


def test_keyed_sum_matches_bincount_and_reference(ref_pallas):
    """Stable sort + in-order sum == np.bincount, bit for bit, and equal to
    the JAX package's keyed_sum on the same keys."""
    rng = np.random.default_rng(5)
    m, nkeys = 30_000, 777
    keys = rng.integers(0, nkeys, m)
    vals = rng.lognormal(size=m)
    got = keyed_sum(_t(keys), _t(vals), nkeys).numpy()
    np.testing.assert_array_equal(
        got, np.bincount(keys, weights=vals, minlength=nkeys))
    np.testing.assert_array_equal(
        got, np.asarray(ref_pallas.keyed_sum(keys, vals, nkeys)))


def test_keyed_sum_int64_counts():
    rng = np.random.default_rng(6)
    keys = rng.integers(0, 64, 5000).astype(np.int32)
    got = keyed_sum(_t(keys), torch.ones(5000, dtype=torch.int64), 64)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  np.bincount(keys, minlength=64))


def test_plain_version_is_stream_order_on_unsorted_ids():
    """The plain version is one serial pass in index order: equal to
    np.add.at even where the ids are not sorted."""
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 97, 50_000)
    data = rng.standard_normal(50_000) * np.pi
    got = segsum.segment_sum_plain(_t(data), _t(ids), 97).numpy()
    np.testing.assert_array_equal(got, _oracle_sequential(data, ids, 97))


def test_empty_inputs_return_zeros():
    for m, nseg in ((0, 4), (5, 0), (0, 0)):
        got = segment_sum(torch.ones(m, dtype=torch.float64),
                          torch.zeros(m, dtype=torch.int64), nseg)
        assert got.shape == (nseg,) and got.dtype == torch.float64
        assert not got.any()


def test_validate_flags_bad_contracts():
    data = torch.ones(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="sorted"):
        segment_sum(data, torch.tensor([0, 2, 1, 3]), 4, validate=True)
    with pytest.raises(ValueError, match="lie in"):
        segment_sum(data, torch.tensor([0, 1, 2, 9]), 4, validate=True)
    with pytest.raises(ValueError, match="parallel"):
        segment_sum(data, torch.tensor([0, 1]), 4)


@pytest.mark.parametrize("data,ids,nseg,err", [
    (torch.ones(3, dtype=torch.float32), torch.zeros(3, dtype=torch.int64),
     2, TypeError),
    (torch.ones(3, dtype=torch.float64), torch.zeros(3, dtype=torch.int32),
     2, TypeError),
    (torch.ones(6, dtype=torch.float64)[::2],
     torch.zeros(3, dtype=torch.int64), 2, ValueError),
    (torch.ones(3, dtype=torch.float64), torch.zeros(3, dtype=torch.int64),
     -1, ValueError),
    (torch.ones((3, 1), dtype=torch.float64),
     torch.zeros((3, 1), dtype=torch.int64), 2, ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(data, ids, nseg, err):
    with pytest.raises(err):
        segment_sum(data, ids, nseg)


def test_cpu_tensors_never_launch():
    before = segsum.launches
    segment_sum(torch.ones(10, dtype=torch.float64),
                torch.zeros(10, dtype=torch.int64), 1)
    assert segsum.launches == before


def test_build_flags_keep_ieee_adds():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--fmad=false" in flags and "fast_math" not in flags
    assert [s.rsplit("/", 1)[-1] for s in _build.sources()] == ["segsum.cu"]


# deeper randomized search when the [test] extra is installed ----------- #
try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    @st.composite
    def segment_layouts(draw):
        """Random sorted layouts: empty segments, giant runs, odd tails."""
        nseg = draw(st.integers(1, 64))
        runs = draw(st.lists(
            st.tuples(st.integers(0, nseg - 1), st.integers(1, 70)),
            min_size=0, max_size=12))
        sids = np.sort(np.concatenate(
            [np.full(ln, s, np.int64) for s, ln in runs]
            or [np.empty(0, np.int64)]))
        return sids, nseg

    @given(layout=segment_layouts(),
           dtype=st.sampled_from([np.float64, np.int64]),
           seed=st.integers(0, 2**31 - 1))
    @settings(max_examples=60, deadline=None)
    def test_property_matches_numpy_oracles(layout, dtype, seed):
        sids, nseg = layout
        rng = np.random.default_rng(seed)
        data = rng.integers(-100, 100, len(sids)).astype(dtype)
        if dtype is np.float64:
            data *= np.e
        _check(data, sids, nseg)


# on the card ---------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("m,nseg,block,layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [np.float64, np.int64])
def test_kernel_matches_plain_version(m, nseg, block, layout, dtype,
                                      cuda_device):
    data, sids = _layout(m, nseg, layout, dtype)
    d, i = _t(data).to(cuda_device), _t(sids).to(cuda_device)
    got = segment_sum(d, i, nseg)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), segsum.segment_sum_plain(d, i, nseg).cpu())
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _oracle_sequential(data, sids, nseg))


@pytest.mark.cuda
def test_kernel_counts_launches_and_keyed_sum(cuda_device):
    rng = np.random.default_rng(12)
    keys = rng.integers(0, 1025, 200_000)
    vals = rng.lognormal(size=200_000)
    before = segsum.launches
    got = keyed_sum(_t(keys).to(cuda_device), _t(vals).to(cuda_device), 1025)
    torch.cuda.synchronize()
    assert segsum.launches == before + 1
    np.testing.assert_array_equal(
        got.cpu().numpy(), np.bincount(keys, weights=vals, minlength=1025))
