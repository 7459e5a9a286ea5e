"""The port's cost analysis (`repro_torch.analysis`, `core.cuda.cost`)
against the JAX package's contracts and its HLO analyzer.

- The JAX analyzer's four contracts (`tests/test_launch_analysis.py`),
  on programs that run: a loop's FLOPs within 5 %, bytes that scale with
  the loop (more than 2.5× from 4 to 16 steps), a slice not charged as
  its whole array, and collectives inside a loop, on a fake (4,) 'model'
  mesh where each of 5 iterations adds one reduce-scatter.
- `analyze_program` of a reduced smollm-360m prefill is within 5 % of
  `analyze_hlo` of the JAX prefill's compiled HLO, same weights.
- A kernel's region is costed by its function's work, not by the plain
  operators it runs on the CPU; the bounds `chip_smoke.py` prints keep
  the values PERF.md records, to the last digit.
- The partitioner's stage costs bucket and sum as the JAX helpers do.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import ProgramCost, analyze_program  # noqa: E402
from repro_torch.analysis import hlo_cost  # noqa: E402
from repro_torch.core.cuda import cost  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _loop(n: int):
    def f(w, x):
        h = x
        for _ in range(n):
            h = torch.tanh(h @ w)
        return h
    return f


def test_loop_flops_within_five_percent():
    w, x = torch.randn(256, 256), torch.randn(32, 256)
    c = analyze_program(_loop(8), w, x)
    expect = 8 * 2 * 32 * 256 * 256
    assert abs(c.flops - expect) / expect < 0.05
    assert c.by_class["mm"]["flops"] == expect
    assert c.by_class["mm"]["count"] == 8


def test_bytes_scale_with_the_loop():
    w, x = torch.randn(256, 256), torch.randn(32, 256)
    b4 = analyze_program(_loop(4), w, x).hbm_bytes
    b16 = analyze_program(_loop(16), w, x).hbm_bytes
    assert b16 > 2.5 * b4           # ~4x expected


def test_slice_not_charged_as_the_full_array():
    """A loop that reads a 32-row slice of a big array per step is not
    charged the whole array per step (a view reads its own size)."""
    big = torch.randn(32 * 1024, 32)

    def f(big, x):
        h = x
        for t in range(64):
            h = h + big.narrow(0, t * 0, 32).sum()
        return h

    c = analyze_program(f, big, torch.zeros(()))
    full_per_iter = 64 * big.numel() * 4
    assert c.hbm_bytes < full_per_iter / 4


def _collectives_in_a_loop(n: int) -> ProgramCost:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.launch.mesh import fake_world, mesh_context
    from repro_torch.parallel import maybe_shard

    with fake_world(4):
        mesh = DeviceMesh("cpu", np.arange(4), mesh_dim_names=("model",))
        with FakeTensorMode():
            w = distribute_tensor(torch.randn(64, 64), mesh, [Shard(0)])
            x = distribute_tensor(torch.randn(8, 64), mesh, [Shard(1)])

            def g(w, x):
                h = x
                for _ in range(n):
                    # the contraction dim is sharded: a partial sum,
                    # scattered back over 'model' (one reduce-scatter)
                    h = maybe_shard(h @ w, None, "model")
                return h

            with mesh_context(mesh):
                return analyze_program(g, w, x)


def test_collectives_inside_a_loop_are_counted_per_iteration():
    one, five = _collectives_in_a_loop(1), _collectives_in_a_loop(5)
    assert one.collective_counts == {"reduce-scatter": 1}
    assert five.collective_counts == {"reduce-scatter": 5}
    # each reduce-scatter's output is a [8, 16] float32 shard
    assert five.collective_bytes["reduce-scatter"] == 5 * 8 * 16 * 4
    assert five.total_collective_bytes == 5 * one.total_collective_bytes
    assert five.total_collective_bytes_bf16eq == \
        five.total_collective_bytes / 2
    # per rank: each iteration's product is [8, 16] by [16, 64]
    assert five.by_class["mm"]["flops"] == 5 * 2 * 8 * 64 * 16


def test_flops_match_the_jax_analyzer_on_a_prefill():
    """Reduced smollm-360m, the JAX package's weights, the same tokens:
    the port's prefill counted by `analyze_program` within 5 % of the
    JAX prefill's HLO counted by `analyze_hlo`."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import models as jmodels
    from repro.analysis import analyze_hlo
    from repro.configs import ARCHS, reduced_config as jreduced
    from repro.launch.steps import make_prefill_step as jprefill

    from repro_torch import models
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.steps import make_prefill_step

    jcfg = jreduced(ARCHS["smollm-360m"])
    cfg = reduced_config(get_config("smollm-360m"))
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)
    text = jax.jit(jprefill(jcfg)).lower(
        params, {"tokens": jnp.asarray(tokens)}).compile().as_text()
    want = analyze_hlo(text).flops
    model = models.from_jax_params(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    got = analyze_program(make_prefill_step(cfg), model,
                          {"tokens": torch.as_tensor(tokens)})
    assert abs(got.flops - want) / want < 0.05, (got.by_class, want)
    assert got.by_class["mm"]["flops"] > 0.9 * got.flops


def test_a_kernel_region_is_costed_by_its_work():
    """On the CPU the wrappers run their plain versions inside the
    region; the analysis charges each call the function's work."""
    from repro_torch.core.cuda import segsum
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru, rwkv6
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 4, 16, generator=g)
    k = torch.randn(2, 40, 2, 16, generator=g)
    v = torch.randn(2, 40, 2, 16, generator=g)
    c = analyze_program(lambda: fa.flash_attention(q, k, v, causal=True,
                                                   window=8))
    assert (c.flops, c.hbm_bytes) == tuple(map(float, hlo_cost.attention_work(
        2, 40, 40, 4, 2, 16, 16, True, 8, 4)))
    assert c.by_class == {"kernel": {"count": 1, "flops": c.flops,
                                     "bytes": c.hbm_bytes}}
    # the pairs a window and a causal mask leave: 8 a row, fewer at the top
    assert hlo_cost._pairs(40, 40, True, 8) == sum(min(i + 1, 8)
                                                   for i in range(40))
    x, a = torch.randn(2, 24, 8), torch.rand(2, 24, 8)
    c = analyze_program(lambda: rglru.rglru_scan(x, a))
    assert c.flops == 8 * x.numel()
    r = torch.randn(1, 12, 2, 8)
    u = torch.randn(2, 8)
    c = analyze_program(lambda: rwkv6.rwkv6_scan(r, r, r, torch.rand_like(r),
                                                 u))
    assert c.flops == 7 * 8 * 8 * 12 * 2
    data = torch.arange(10, dtype=torch.float64)
    ids = torch.tensor([0, 0, 1, 1, 1, 2, 2, 3, 3, 3])
    c = analyze_program(lambda: segsum.segment_sum(data, ids, 4))
    assert (c.flops, c.hbm_bytes) == (10.0, 8.0 * 10 + 8 * 10 + 8 * 4)


def test_peak_bytes_follow_the_live_storages():
    """A loop whose every step frees the step before it peaks at three
    outputs (the product, its tanh, the step before), and nothing the
    run allocated is held at its end beyond what it returns."""
    x = torch.randn(256, 256)
    c = analyze_program(_loop(10), x, x)
    assert c.peak_bytes == 3 * x.numel() * 4


def test_chip_smoke_bounds_keep_their_recorded_values():
    """The bounds `chip_smoke.py` prints, computed from this module's
    work functions, equal the values PERF.md records for each row."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    f32 = cs.PEAK_F32_OPS_PER_S
    assert cs._segsum_bound(5_528_199, 1024, 8, 8) == (
        0.026405783880597014, "bytes")
    assert cs._segsum_bound(2_023_937, 1_048_576, 8, 8) == (
        0.012170626865671642, "bytes")
    assert cs._fa_bound(cs.FA_MAIN) == (0.833166714569697, "operations",
                                        2.051828476179104)
    assert cs._fa_bound(cs.FA_DBRX)[0] == 0.6250275560727273
    assert cs._fa_bound(cs.FA_MLA)[::2] == (2.083425186909091,
                                            5.1308232214925376)
    assert cs._fa_bound(cs.FA_SEAMLESS)[::2] == (0.2082408385939394,
                                                 0.5128319159402985)
    assert cs._fa_bwd_bound(cs.FA_BWD_A)[::2] == (0.48830277818181816,
                                                  1.2025366925373135)
    assert cs._fa_bwd_bound(cs.FA_BWD_B)[0] == 1.041458393212121
    # row 2c at path D's layer, and the backward at path E's cross
    # attention
    assert cs._fa_bwd_bound(cs.FA_MLA)[::2] == (5.416905485963636,
                                                13.340140375880598)
    assert cs._fa_bwd_bound(cs.FA_BWD_SEAMLESS_CROSS)[::2] == (
        0.2542002424242424, 0.6260155223880597)
    assert cs._bound(hlo_cost.rglru_work(*cs.RG_MAIN, 4), f32)[0] == \
        0.0901560167164179
    assert cs._bound(hlo_cost.rglru_bwd_work(*cs.RG_BWD, 4), f32)[0] == \
        0.09015112597014925
    assert cs._rwkv_bound(*cs.RWKV_MAIN, size=4)[0] == 0.22436396322388058
    assert cs._bound(hlo_cost.rwkv6_bwd_work(*cs.RWKV_BWD, 4), f32)[0] == \
        0.20833796585074627


@pytest.mark.parametrize("case,dtype,want", [
    ("FA_PATH_A", "float32", (0.19532111127272725, "operations")),
    ("FA_DECODE", "float32", (0.009791274029850746, "bytes")),
    ("FA_MAIN", "bfloat16", (0.13900152467542973, "operations")),
    ("FA_DBRX", "bfloat16", (0.10427658923356926, "operations")),
    ("FA_MLA", "bfloat16", (0.3475886307785642, "operations")),
    ("FA_SEAMLESS", "bfloat16", (0.03474189925985845, "operations")),
])
def test_chip_smoke_forward_bounds_at_the_kernels_line_shapes(case, dtype,
                                                             want):
    """The flash-attention forward's bounds that `chip_smoke.py` prints
    beside its bf16, path A and decode times equal the values PERF.md
    records (bf16 at the bf16 rate; the decode launch bound by its
    bytes)."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    assert cs._fa_bound(getattr(cs, case)[:9] + (dtype,))[:2] == want


def test_attention_work_at_unequal_head_dims():
    """MLA's (192, 128): the forward 2·(Dqk + Dv) and the backward
    6·Dqk + 4·Dv operations a pair; at equal dims 4·D and 10·D."""
    ops, _ = hlo_cost.attention_work(1, 4, 4, 1, 1, 192, 128, False, None, 4)
    assert ops == 2 * 320 * 16
    ops, nbytes = hlo_cost.attention_bwd_work(1, 4, 4, 1, 1, 64, 64, True,
                                              None, 4)
    assert ops == 10 * 64 * 10
    assert nbytes == 4 * (4 * 4 * 64 + 4 * 4 * 64) + 4 * 4


def test_stage_costs_bucket_and_sum_as_the_jax_helpers():
    jcost = pytest.importorskip("repro.core.pallas.cost")
    for x in (0, 1, 2, 3, 7, 8, 9, 1000, 1024, 1025, 5_528_199):
        assert cost._bucket(x) == jcost._bucket(x)
        assert cost._bucket(x, 1) == jcost._bucket(x, 1)
    assert cost.keyed_sum_cost(0, 5) == {"flops": 0.0, "hbm_bytes": 0.0}
    assert cost.replica_csr_cost(10, 4, 0) == {"flops": 0.0,
                                               "hbm_bytes": 0.0}
    # nearby sizes share a bucket, as the pipeline pads them
    assert cost.keyed_sum_cost(1000, 60) == cost.keyed_sum_cost(1024, 64)
    assert cost.keyed_sum_cost(1025, 64)["flops"] == 2048.0
    n, m, p = 5000, 20_000, 64
    fin = cost.partitioner_finalize_cost(n, m, p)
    parts = [cost.replica_csr_cost(n, p, m), cost.keyed_sum_cost(m, p),
             cost.keyed_sum_cost(m, p)]
    assert fin == {k: sum(c[k] for c in parts) for k in fin}
    inter = cost.interaction_cost(30_000, p)
    parts = [cost.keyed_sum_cost(30_000, p + 1),
             cost.keyed_sum_cost(30_000, p * p + 1)]
    assert inter == {k: sum(c[k] for c in parts) for k in inter}
    assert cost.segment_sum_work(5_528_199, 1024) == (
        5_528_199, 16 * 5_528_199 + 8 * 1024)


def test_no_analysis_or_capture_runs_inside_another():
    from repro_torch.core import op_graph
    with pytest.raises(RuntimeError):
        analyze_program(lambda: op_graph.capture(lambda: torch.ones(2)))
    assert op_graph._active is None
