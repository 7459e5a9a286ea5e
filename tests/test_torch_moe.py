"""The port's MoE layer and expert placement against the JAX package's.

`repro_torch.models.moe.MoE` is held to `repro.models.moe.MoE` on
reduced dbrx-132b (4 experts, top-2, capacity factor 1.25) with the JAX
package's weights carried across and numpy-seeded inputs: with tokens
dropped by capacity (S = 12 and 24), dropless (capacity factor = E) and
with a zero router (every expert ties: the lower index wins, as
`jax.lax.top_k` has it).  `expert_placement`, `naive_expert_placement`
and `mesh_device_order` are held bit for bit to the JAX package's on the
inputs of `tests/test_benchgraphs_planner.py` and
`benchmarks/expert_placement.py`, at `backend="fast"` and at
`backend="cuda", device="cpu"` (the segment sum's plain version).

Tolerances: `apply` 1e-5·max(1, max|y|), `aux_loss` 1e-6 relative; the
placements exactly.  The tests marked `cuda` run on the card.
"""
import importlib.util
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.cuda import segsum  # noqa: E402
from repro_torch.models.moe import MoE  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CFG = reduced_config(get_config("dbrx-132b"))
# (S, capacity factor, zero router): drops at the config's 1.25, none at E
APPLY_CASES = [(12, None, False), (24, None, False), (12, 4.0, False),
               (24, 4.0, False), (24, None, True), (12, 4.0, True)]
# benchmarks/expert_placement.py's two inputs: (E, k, devices)
ROUTING = [(256, 8, 16), (16, 4, 8)]
PLACEMENT_BACKENDS = [("fast", "cpu"), ("cuda", "cpu")]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's MoE layer and planner.  Imported here, not at
    the top, so the tests marked `cuda` also run where JAX is not
    installed."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from benchmarks.expert_placement import synth_routing
    from repro.configs import ARCHS, reduced_config as jreduced
    from repro.core import planner as jplanner
    from repro.models.moe import MoE as JMoE
    jcfg = jreduced(ARCHS["dbrx-132b"])
    params = JMoE.init(jax.random.PRNGKey(0), jcfg)
    return types.SimpleNamespace(jax=jax, jnp=jnp, MoE=JMoE, cfg=jcfg,
                                 params=params, planner=jplanner,
                                 synth_routing=synth_routing)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _params(jx, zero_router: bool):
    """(JAX params, the port's tree of CPU tensors), the router zeroed
    for the all-ties case."""
    params = dict(jx.params)
    if zero_router:
        params["router"] = {"w": jx.jnp.zeros_like(params["router"]["w"])}
    return params, jx.jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), params)


def _x(S: int, seed: int = 0) -> np.ndarray:
    """[2, S, d]: normal tokens plus a direction each sequence shares (as
    a text's hidden states do), which skews the routing enough that the
    config's capacity factor drops tokens."""
    rng = np.random.default_rng(seed + S)
    x = rng.standard_normal((2, S, CFG.d_model))
    return (x + rng.standard_normal((2, 1, CFG.d_model))).astype(np.float32)


def _dropped(jx, params, x, cf) -> int:
    """(token, slot) pairs past their expert's capacity, from the JAX
    package's router (the count `MoE.apply` drops)."""
    jnp = jx.jnp
    G, S, _ = x.shape
    E, k = CFG.n_experts, CFG.experts_per_token
    C = max(int(S * k * (cf or CFG.capacity_factor) / E), 4)
    probs = jx.jax.nn.softmax(jnp.asarray(x) @ params["router"]["w"], -1)
    _, top_e = jx.jax.lax.top_k(probs, k)
    onehot = np.eye(E, dtype=np.int64)[np.asarray(top_e)].reshape(
        G, S * k, E)
    pos = (np.cumsum(onehot, 1) * onehot).sum(-1) - 1
    return int((pos >= C).sum())


# ---------------------------------------------------------------------- #
# the layer
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("S,cf,zero_router", APPLY_CASES)
def test_apply_matches_jax(S, cf, zero_router, jx):
    params, tree = _params(jx, zero_router)
    x = _x(S)
    want = np.asarray(jx.MoE.apply(params, jx.cfg, jx.jnp.asarray(x),
                                   capacity_factor=cf))
    got = MoE.apply(tree, CFG, torch.from_numpy(x), capacity_factor=cf)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), err
    dropped = _dropped(jx, params, x, cf)
    assert (dropped > 0) == (cf is None), dropped


def test_apply_with_a_shared_expert_matches_jax(jx):
    """deepseek-v3's MoE layer, reduced (4 routed experts, top-2, one
    shared expert): the shared expert's MLP is added to every token."""
    jax, jnp = jx.jax, jx.jnp
    from repro.configs import ARCHS, reduced_config as jreduced
    jcfg = jreduced(ARCHS["deepseek-v3-671b"])
    cfg = reduced_config(get_config("deepseek-v3-671b"))
    assert cfg.n_shared_experts == 1
    params = jx.MoE.init(jax.random.PRNGKey(1), jcfg)
    tree = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    assert sorted(tree) == ["router", "shared", "w_gate", "w_in", "w_out"]
    x = _x(12)
    want = np.asarray(jx.MoE.apply(params, jcfg, jnp.asarray(x)))
    got = MoE.apply(tree, cfg, torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("S,zero_router", [(12, False), (24, False),
                                           (24, True)])
def test_aux_loss_matches_jax(S, zero_router, jx):
    params, tree = _params(jx, zero_router)
    x = _x(S)
    want = float(jx.MoE.aux_loss(params, jx.cfg, jx.jnp.asarray(x)))
    got = MoE.aux_loss(tree, CFG, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-6 * abs(want)


def test_router_ties_go_to_the_lower_expert(jx):
    """A zero router ties every expert: both packages pick 0..k-1, and
    with every token on the same k experts the capacity drops the
    tokens past C in token order."""
    from repro_torch.models.moe import _top_k
    probs = torch.full((2, 5, CFG.n_experts), 1.0 / CFG.n_experts)
    probs[1, 2, 3] = probs[1, 2, 1] = 0.5      # two ties above the rest
    top_p, top_e = _top_k(probs, CFG.experts_per_token)
    want_p, want_e = jx.jax.lax.top_k(jx.jnp.asarray(probs.numpy()),
                                      CFG.experts_per_token)
    assert np.array_equal(top_e.numpy(), np.asarray(want_e))
    assert np.array_equal(top_p.numpy(), np.asarray(want_p))
    assert top_e[0, 0].tolist() == [0, 1] and top_e[1, 2].tolist() == [1, 3]
    params, _ = _params(jx, zero_router=True)
    x = _x(24)
    C = max(int(24 * 2 * 1.25 / 4), 4)
    assert _dropped(jx, params, x, None) == 2 * 2 * (24 - C)


def test_apply_differentiates_like_jax(jx):
    """The gradients of sum(y * r) with respect to x and to every weight
    (the router's through top_p), with tokens dropped."""
    jax, jnp = jx.jax, jx.jnp
    params, tree = _params(jx, zero_router=False)
    x = _x(24, seed=3)
    r = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jx.MoE.apply(p, jx.cfg, xx) * r)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    leaves = {"router": tree["router"]["w"], "w_in": tree["w_in"],
              "w_gate": tree["w_gate"], "w_out": tree["w_out"]}
    for t in leaves.values():
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    (MoE.apply(tree, CFG, xt) * torch.from_numpy(r)).sum().backward()
    want = {"router": jg_p["router"]["w"], "w_in": jg_p["w_in"],
            "w_gate": jg_p["w_gate"], "w_out": jg_p["w_out"], "x": jg_x}
    got = dict(leaves, x=xt)
    for key, w in want.items():
        w = np.asarray(w)
        err = float(np.abs(got[key].grad.numpy() - w).max())
        assert err <= 1e-5 * max(1.0, float(np.abs(w).max())), (key, err)


# ---------------------------------------------------------------------- #
# expert placement
# ---------------------------------------------------------------------- #
def _same_placement(got, want) -> None:
    assert type(got).__name__ == type(want).__name__ == "ExpertPlacement"
    assert (got.n_experts, got.n_devices) == (want.n_experts, want.n_devices)
    assert got.device_experts == want.device_experts
    assert got.expert_devices == want.expert_devices
    assert got.device_load.dtype == want.device_load.dtype
    assert np.array_equal(got.device_load, want.device_load)
    assert got.replication_factor == want.replication_factor
    assert got.all_to_all_fraction == want.all_to_all_fraction
    assert got.summary() == want.summary()


def _zipf_load() -> np.ndarray:
    """tests/test_benchgraphs_planner.py's load (64 experts)."""
    rng = np.random.default_rng(0)
    return rng.zipf(1.5, size=64).astype(float).clip(max=1e5)


@pytest.mark.parametrize("backend,device", PLACEMENT_BACKENDS)
def test_expert_placement_equals_the_reference_rank1(backend, device, jx):
    """No co-activation given: the rank-1 surrogate, 64 experts on 8
    devices; and the contiguous layout."""
    load = _zipf_load()
    want = jx.planner.expert_placement(load, n_devices=8)
    before = segsum.launches
    got = planner.expert_placement(load, n_devices=8, backend=backend,
                                   device=device)
    assert segsum.launches == before        # the CPU: plain versions
    _same_placement(got, want)
    _same_placement(planner.naive_expert_placement(load, 8),
                    jx.planner.naive_expert_placement(load, 8))
    imb = got.device_load.max() / got.device_load.mean()
    naive = planner.naive_expert_placement(load, 8)
    assert imb < naive.device_load.max() / naive.device_load.mean()


@pytest.mark.parametrize("backend,device", PLACEMENT_BACKENDS)
@pytest.mark.parametrize("E,k,n_devices", ROUTING)
def test_expert_placement_equals_the_reference_on_routing(
        E, k, n_devices, backend, device, jx):
    """benchmarks/expert_placement.py's inputs (deepseek-v3: 256 experts,
    top-8, 16 devices; dbrx: 16, top-4, 8), with more knobs besides."""
    load, co = jx.synth_routing(E, k=k)
    for kw in ({}, {"lam": 1.1, "seed": 3, "max_replicas": 2}):
        want = jx.planner.expert_placement(load, co, n_devices=n_devices,
                                           **kw)
        got = planner.expert_placement(load, co, n_devices=n_devices,
                                       backend=backend, device=device, **kw)
        _same_placement(got, want)
    _same_placement(planner.naive_expert_placement(load, n_devices),
                    jx.planner.naive_expert_placement(load, n_devices))


@pytest.mark.parametrize("backend", ["fast", "cuda", "reference"])
def test_mesh_device_order_equals_the_reference(backend, jx):
    rng = np.random.default_rng(0)
    comm = rng.random((16, 16))
    comm = comm + comm.T
    for rows, cols in ((4, 4), (2, 4)):
        got = planner.mesh_device_order(comm, rows, cols, backend=backend)
        want = jx.planner.mesh_device_order(comm, rows, cols)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_chip_smokes_synth_routing_is_the_benchmarks(jx):
    """chip_smoke.py may not import `benchmarks`: its copy of
    `synth_routing` must give the same arrays."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for E, k, _ in ROUTING:
        for seed in (0, 1):
            got = smoke.synth_routing(E, k=k, seed=seed)
            want = jx.synth_routing(E, k=k, seed=seed)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------- #
# on the card
# ---------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("S,cf,zero_router", APPLY_CASES)
def test_apply_on_the_card_matches_the_cpu(S, cf, zero_router, cuda_device):
    """The layer on the card (cuBLAS products, the card's sort and
    scatter-add) against the host, and twice with the same bits."""
    gen = torch.Generator().manual_seed(S)
    tree = MoE.init(gen, CFG)
    if zero_router:
        tree["router"]["w"].zero_()
    x = torch.from_numpy(_x(S))
    want = MoE.apply(tree, CFG, x, capacity_factor=cf)
    gtree = {k: ({kk: vv.to(cuda_device) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(cuda_device))
             for k, v in tree.items()}
    got = MoE.apply(gtree, CFG, x.to(cuda_device), capacity_factor=cf)
    again = MoE.apply(gtree, CFG, x.to(cuda_device), capacity_factor=cf)
    assert torch.equal(got, again)
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-5 * max(1.0, float(want.abs().max())), err


@pytest.mark.cuda
@pytest.mark.parametrize("E,k,n_devices", ROUTING)
def test_expert_placement_on_the_card_equals_fast(E, k, n_devices,
                                                  cuda_device):
    """`backend="cuda"` on the card: the cut's finalize makes two
    segment sums (loads and edge counts), and the placement is `fast`'s
    bit for bit."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    load, co = smoke.synth_routing(E, k=k)
    want = planner.expert_placement(load, co, n_devices=n_devices,
                                    backend="fast")
    segsum.launches = 0
    got = planner.expert_placement(load, co, n_devices=n_devices)
    assert segsum.launches == 2
    _same_placement(got, want)
