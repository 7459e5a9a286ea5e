"""The fused AdamW (`optim/adamw_cuda.py`, `csrc/adamw.cu`) against the
tree path of `optim.adamw_update`.

On the CPU: the host's leaf tables cover every element of every leaf once
(odd sizes, views at odd offsets, more leaves than a launch takes);
CPU, DTensor and fake leaves, and leaves of a dtype the kernels do not
take, keep the tree path, the counter `optim.adamw.fused` and
`adamw_cuda.launches` left at 0; and the fused path's glue (the trees it
returns, its counters, its one `adamw` vertex in place of the tree path's
operators) runs with a host stand-in for the kernels.

The tests marked `cuda` run the kernels on the card against the tree path
(`adamw._tree_update`) on the same CUDA tensors: p, m and v bit for bit
when the clip is not engaged, to 1e-6 when it is (the kernel sums the
norm's squares in another order); they import no JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import op_graph  # noqa: E402
from repro_torch.optim import adamw, adamw_cuda  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: E402
                                     adamw_update, tree_leaves)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


# ---------------------------------------------------------------------- #
# the host's leaf tables
# ---------------------------------------------------------------------- #
def block_range(starts, numels, b, chunk):
    """(leaf within the launch, first element, end element) of block `b`,
    as `csrc/adamw.cu`'s `find_leaf` finds it: the last leaf whose first
    block is at most b."""
    lo, hi = 0, len(numels) - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if starts[mid] <= b:
            lo = mid
        else:
            hi = mid - 1
    first = (b - starts[lo]) * chunk
    return lo, first, min(numels[lo], first + chunk)


@pytest.mark.parametrize("sizes,max_leaves,chunk", [
    ([1, 3, 4097, 0, 960, 8, 7], 384, 8),
    ([1, 3, 4097, 0, 960, 8, 7], 3, 4),
    ([5] * 13 + [0, 0] + [33], 4, 16),
    ([0], 384, 16384),
    ([49_152 * 960 + 1, 2, 16_384, 16_385], 2, 16_384),
])
def test_plan_covers_every_element_once(sizes, max_leaves, chunk):
    """Every block of every launch maps (by the kernels' search) to one
    chunk of one leaf, and the chunks tile each leaf exactly."""
    groups = adamw_cuda.plan(sizes, max_leaves, chunk)
    assert [g[0] for g in groups] == list(range(0, len(sizes), max_leaves))
    assert groups[-1][1] == len(sizes)
    seen = {i: [] for i in range(len(sizes))}
    for first, end, starts in groups:
        assert end - first <= max_leaves
        assert len(starts) == end - first + 1
        numels = sizes[first:end]
        for b in range(starts[-1]):
            leaf, lo, hi = block_range(starts, numels, b, chunk)
            assert 0 <= lo < hi <= numels[leaf] and hi - lo <= chunk
            assert lo % chunk == 0
            seen[first + leaf].append((lo, hi))
    for i, n in enumerate(sizes):
        spans = sorted(seen[i])
        assert sum(hi - lo for lo, hi in spans) == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert not spans or (spans[0][0] == 0 and spans[-1][1] == n)


@pytest.mark.parametrize("same_lists", [True, False])
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("max_leaves", [2, 384])
def test_leaf_tables_cover_views_at_odd_offsets(offset, max_leaves,
                                                same_lists):
    """Leaves as views at odd offsets into one flat buffer: the rows hold
    each view's own address, size and dtype code, and the blocks' element
    ranges, taken from those addresses, cover the buffer's elements
    exactly once; the outputs' addresses are read from the output lists
    or, where those are the input lists, taken from the inputs'."""
    sizes = [1, 3, 4097, 960, 5, 0, 17]
    flat = torch.zeros(offset + sum(sizes), dtype=torch.float32)
    views, at = [], offset
    for n in sizes:
        views.append(flat[at:at + n])
        at += n
    grads = [torch.zeros(n, dtype=torch.bfloat16) for n in sizes]
    moms = [torch.zeros(n) for n in sizes]
    chunk = 8
    outs = (views, moms, moms) if same_lists else (
        list(views), list(moms), list(moms))
    tables = adamw_cuda.leaf_tables(views, grads, moms, moms, *outs,
                                    max_leaves, chunk)
    assert sum(n for _, n, _ in tables) == len(sizes)
    hits = np.zeros(flat.numel(), dtype=np.int64)
    base = flat.data_ptr()
    for rows, n, blocks in tables:
        assert rows.shape == (n, 10) and rows.dtype == np.int64
        assert (rows[:, 0] == rows[:, 4]).all()     # in place
        assert (rows[:, 8] == 2).all()              # bfloat16 gradients
        numels = rows[:, 7].tolist()
        starts = rows[:, 9].tolist() + [blocks]
        for b in range(blocks):
            leaf, lo, hi = block_range(starts, numels, b, chunk)
            first = (int(rows[leaf, 0]) - base) // 4
            hits[first + lo:first + hi] += 1
    assert (hits[:offset] == 0).all() and (hits[offset:] == 1).all()


# ---------------------------------------------------------------------- #
# the tree path keeps every input that is not a plain CUDA tensor
# ---------------------------------------------------------------------- #
def _tree(sizes, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    params = {f"w{i}": torch.as_tensor(rng.standard_normal(n).astype(
        np.float32), device=device) for i, n in enumerate(sizes)}
    grads = {k: torch.as_tensor(rng.standard_normal(v.numel()).astype(
        np.float32), device=device) for k, v in params.items()}
    return params, grads


def _counted(fn):
    """(fn's result, the counter `optim.adamw.fused`, the wrapper's
    launches) over one call."""
    before = adamw_cuda.launches
    with obs.scoped(merge=False) as col:
        out = fn()
    return (out, col.counters.get("optim.adamw.fused", 0),
            adamw_cuda.launches - before)


def test_cpu_leaves_take_the_tree_path():
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    params, grads = _tree([1, 3, 4097])
    state = adamw_init(params, cfg)
    want = adamw._tree_update(params, grads, state, cfg, False)
    got, fused, launched = _counted(
        lambda: adamw_update(params, grads, state, cfg))
    assert fused == 0 and launched == 0
    for a, b in zip(tree_leaves(got[:2]), tree_leaves(want[:2])):
        assert torch.equal(a, b)


def test_fake_leaves_take_the_tree_path():
    """Fake CUDA tensors (a dry run's) are a subclass: the tree path runs
    on them, no kernel is called."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    cfg = AdamWConfig()
    with FakeTensorMode():
        params = {"a": torch.empty(4097, device="cuda"),
                  "b": torch.empty(3, 5, device="cuda")}
        grads = {k: torch.empty_like(v) for k, v in params.items()}
        state = adamw_init(params, cfg)
        assert not adamw._on_card(adamw._zip_leaves(
            params, grads, state["m"], state["v"]), state["step"])
        (new_p, new_s, m), fused, launched = _counted(
            lambda: adamw_update(params, grads, state, cfg))
    assert fused == 0 and launched == 0
    assert isinstance(new_p["a"], FakeTensor) and new_p["b"].shape == (3, 5)
    assert new_s["m"]["a"].device.type == "cuda"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_leaves_of_other_dtypes_take_the_tree_path(dtype, monkeypatch):
    """The rule reads the dtypes and the card: with the type test widened
    to fake CUDA tensors, float32 leaves would take the kernels, and a
    float64 or float16 leaf (parameter or gradient), a float64 step, or
    a leaf on another card keeps the tree path."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    monkeypatch.setattr(adamw, "_PLAIN", adamw._PLAIN + (FakeTensor,))
    cfg = AdamWConfig()
    with FakeTensorMode():
        params = {"a": torch.empty(4097, device="cuda"),
                  "b": torch.empty(3, 5, device="cuda")}
        grads = {k: torch.empty_like(v) for k, v in params.items()}
        state = adamw_init(params, cfg)
        quads = lambda p, g: adamw._zip_leaves(  # noqa: E731
            p, g, state["m"], state["v"])
        assert adamw._on_card(quads(params, grads), state["step"])
        odd_p = dict(params, b=params["b"].to(dtype))
        odd_g = dict(grads, a=grads["a"].to(dtype))
        assert not adamw._on_card(quads(odd_p, grads), state["step"])
        assert not adamw._on_card(quads(params, odd_g), state["step"])
        assert not adamw._on_card(quads(params, grads),
                                  state["step"].to(torch.float64))
        other = dict(grads, b=torch.empty(3, 5, device="cuda:1"))
        assert not adamw._on_card(quads(params, other), state["step"])
        (new_p, _, _), fused, launched = _counted(
            lambda: adamw_update(odd_p, grads, state, cfg))
    assert fused == 0 and launched == 0
    assert new_p["b"].dtype == dtype


def _host_kernels(ps, gs, ms, vs, step, cfg, inplace):
    """`adamw_cuda.update`'s contract computed by the tree path on the
    host, for the fused path's glue on the CPU."""
    new_p, new_s, met = adamw._tree_update(
        ps, gs, {"m": ms, "v": vs, "step": step}, cfg, inplace)
    scal = torch.stack([met["grad_norm"], torch.ones(()), met["lr"],
                        torch.zeros(()), torch.zeros(())])
    adamw_cuda.launches += 1
    return new_p, new_s["m"], new_s["v"], new_s["step"], scal


@pytest.mark.parametrize("inplace", [True, False])
def test_fused_glue_on_the_host(inplace, monkeypatch):
    """`_fused` with the kernels' contract on the host: the trees it
    returns are shaped as the inputs with the tree path's values (the
    given objects in place), each call counts once, and a capture holds
    one `adamw` vertex where the tree path's operators were, and nothing
    else changes."""
    import collections
    monkeypatch.setattr(adamw, "_on_card", lambda quads, step: True)
    monkeypatch.setattr(adamw_cuda, "update", _host_kernels)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)

    def make():
        params, grads = _tree([1, 3, 4097, 8])
        params["nest"] = [params.pop("w2"), {"z": params.pop("w3")}]
        grads["nest"] = [grads.pop("w2"), {"z": grads.pop("w3")}]
        return params, grads, adamw_init(params, cfg)

    params, grads, state = make()
    want = adamw._tree_update(params, grads, state, cfg, False)
    params, grads, state = make()
    got, fused, launched = _counted(lambda: adamw_update(
        params, grads, state, cfg, inplace=inplace))
    assert (fused, launched) == (1, 1)
    new_p, new_s, metrics = got
    if inplace:
        assert new_p is params and new_s is state
    assert sorted(new_p) == sorted(want[0]) and isinstance(
        new_p["nest"], list) and sorted(new_p["nest"][1]) == ["z"]
    for a, b in zip(tree_leaves((new_p, new_s)), tree_leaves(want[:2])):
        assert torch.equal(a, b)
    for key in ("grad_norm", "lr"):
        assert torch.equal(metrics[key], want[2][key])

    def step(p, g, s):
        with torch.no_grad():
            return adamw_update(p, g, s, cfg, inplace=inplace)

    params, grads, state = make()
    fused_graph, _ = op_graph.capture(step, params, grads, state)
    monkeypatch.undo()
    params, grads, state = make()
    tree_graph, _ = op_graph.capture(step, params, grads, state)
    f = collections.Counter(fused_graph.node_labels)
    t = collections.Counter(tree_graph.node_labels)
    assert f - t == collections.Counter(adamw=1)
    assert f["input"] == t["input"] > 0 and sum((t - f).values()) > 100


def test_dtensor_leaves_take_the_tree_path():
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    from repro_torch.launch.mesh import fake_world
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    params, grads = _tree([3, 7])
    state = adamw_init(params, cfg)
    want = adamw._tree_update(params, grads, state, cfg, False)
    with fake_world(1):
        mesh = DeviceMesh("cpu", [0])
        put = lambda tr: {k: distribute_tensor(v, mesh, [Replicate()])  # noqa
                          for k, v in tr.items()}
        dp, dg = put(params), put(grads)
        dstate = adamw_init(dp, cfg)
        assert isinstance(dstate["m"]["w0"], DTensor)
        (new_p, _, _), fused, launched = _counted(
            lambda: adamw_update(dp, dg, dstate, cfg))
        got = {k: v.to_local() for k, v in new_p.items()}
    assert fused == 0 and launched == 0
    for k in params:
        torch.testing.assert_close(got[k], want[0][k], rtol=1e-6, atol=0)


# ---------------------------------------------------------------------- #
# on the card: the kernels against the tree path
# ---------------------------------------------------------------------- #
SIZES = [1, 3, 4097, 960, 16_385 * 3, 64]


def _leaves(device, sizes, layout, dtypes, seed=0, grad_scale=1e-3):
    """params, grads (trees) and the moments' dtype.  layout "flat": the
    parameters are views of one flat buffer from offset 1 (their operands'
    16-byte phases differ from the gradients' and moments'); "separate":
    each its own tensor, one of them and one gradient not contiguous."""
    p_dtype, g_dtype = dtypes
    rng = np.random.default_rng(seed)
    draw = lambda n, s: torch.as_tensor(  # noqa: E731
        (rng.standard_normal(n) * s).astype(np.float32), device=device)
    if layout == "flat":
        flat = draw(1 + sum(sizes), 1.0).to(p_dtype)
        at, ps = 1, []
        for n in sizes:
            ps.append(flat[at:at + n])
            at += n
    else:
        ps = [draw(n, 1.0).to(p_dtype) for n in sizes]
        ps[4] = draw(ps[4].numel(), 1.0).to(p_dtype).view(5, -1).t()
    gs = [draw(p.numel(), grad_scale).to(g_dtype).view(p.shape) for p in ps]
    if layout == "separate":
        gs[4] = draw(gs[4].numel(), grad_scale).to(g_dtype).view(
            ps[4].shape[1], -1).t()
    names = [f"w{i:02d}" for i in range(len(ps))]
    return dict(zip(names, ps)), dict(zip(names, gs))


def _clone_state(state):
    return {"m": {k: v.clone() for k, v in state["m"].items()},
            "v": {k: v.clone() for k, v in state["v"].items()},
            "step": state["step"].clone()}


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _run_pair(cfg, make, steps, inplace):
    """The fused and the tree path, each from its own copy of `make()`'s
    (params, grads), `steps` steps of the same gradients (each step's
    scaled by 1 + step): their (params, state, metrics) after each step."""
    trees = []
    for _ in range(2):
        params, grads = make()
        trees.append((params, adamw_init(params, cfg)))
    out = []
    for i in range(steps):
        g = {k: v * (1 + i) for k, v in grads.items()}
        pair = []
        for j, (p, st) in enumerate(trees):
            fn = adamw_update if j == 0 else (
                lambda *a, **k: adamw._tree_update(*a, k["inplace"]))
            new_p, new_s, m = fn(p, g, st, cfg, inplace=inplace)
            trees[j] = (new_p, new_s)
            pair.append((new_p, new_s, m))
        out.append(pair)
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("inplace", [True, False])
@pytest.mark.parametrize("layout", ["flat", "separate"])
@pytest.mark.parametrize("dtypes", [
    (torch.float32, torch.float32, torch.float32),
    (torch.float32, torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
], ids=["f32", "bf16_moments", "bf16"])
def test_fused_equals_the_tree_path_unclipped(inplace, layout, dtypes,
                                              cuda_device):
    """Clip far above the norm (scale exactly 1): three steps, p, m and v
    bit for bit, the step equal, lr and grad_norm to 1e-6."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                      clip_norm=1e9, moment_dtype=dtypes[2])
    make = lambda: _leaves(cuda_device, SIZES, layout, dtypes[:2])  # noqa
    for fused, tree in _run_pair(cfg, make, 3, inplace):
        (fp, fs, fm), (tp, ts, tm) = fused, tree
        for a, b in zip(tree_leaves((fp, fs["m"], fs["v"])),
                        tree_leaves((tp, ts["m"], ts["v"]))):
            assert _equal(a, b)
        assert int(fs["step"]) == int(ts["step"])
        for key in ("lr", "grad_norm"):
            assert fm[key].dtype == torch.float32 and fm[key].dim() == 0
            assert abs(float(fm[key]) - float(tm[key])) <= 1e-6 * abs(
                float(tm[key]))


@pytest.mark.cuda
@pytest.mark.parametrize("inplace", [True, False])
def test_fused_equals_the_tree_path_clipped(inplace, cuda_device):
    """Gradients far above the clip: the norms, rates and every leaf of p,
    m and v within 1e-6 of the leaf's largest value."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=1.0)
    make = lambda: _leaves(cuda_device, SIZES, "flat",  # noqa: E731
                           (torch.float32, torch.float32), grad_scale=1.0)
    for fused, tree in _run_pair(cfg, make, 3, inplace):
        (fp, fs, fm), (tp, ts, tm) = fused, tree
        assert float(tm["grad_norm"]) > 10 * cfg.clip_norm
        for key in ("lr", "grad_norm"):
            assert abs(float(fm[key]) - float(tm[key])) <= 1e-6 * abs(
                float(tm[key]))
        for a, b in zip(tree_leaves((fp, fs["m"], fs["v"])),
                        tree_leaves((tp, ts["m"], ts["v"]))):
            gap = float((a.double() - b.double()).abs().max())
            assert gap <= 1e-6 * float(b.double().abs().max()), gap


@pytest.mark.cuda
def test_fused_more_leaves_than_one_launch_takes(cuda_device):
    """More leaves than a table holds: several launches, the same bits as
    the tree path, one counted update."""
    lib = adamw_cuda._library()
    n = lib.adamw_max_leaves() + 17
    sizes = [1 + (i * 37) % 301 for i in range(n)]
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=1e9)
    make = lambda: _leaves(cuda_device, sizes, "flat",  # noqa: E731
                           (torch.float32, torch.float32))
    before = adamw_cuda.launches
    (fused, tree), = _run_pair(cfg, make, 1, True)
    assert adamw_cuda.launches - before == 1
    for a, b in zip(tree_leaves((fused[0], fused[1]["m"], fused[1]["v"])),
                    tree_leaves((tree[0], tree[1]["m"], tree[1]["v"]))):
        assert _equal(a, b)


@pytest.mark.cuda
def test_fused_two_calls_give_the_same_bits(cuda_device):
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=1.0)
    params, grads = _leaves(cuda_device, SIZES, "flat",
                            (torch.float32, torch.float32), grad_scale=1.0)
    state = adamw_init(params, cfg)
    runs = [adamw_update(params, grads, _clone_state(state), cfg)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(tree_leaves(runs[0]), tree_leaves(runs[1])):
        assert _equal(a, b)


@pytest.mark.cuda
def test_fused_counts_one_update_a_step(cuda_device):
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    params, grads = _leaves(cuda_device, SIZES, "flat",
                            (torch.float32, torch.float32))
    state = adamw_init(params, cfg)
    for i in range(3):
        _, fused, launched = _counted(lambda: adamw_update(
            params, grads, state, cfg, inplace=True))
        assert (fused, launched) == (1, 1)
        assert int(state["step"]) == i + 1


@pytest.mark.cuda
@pytest.mark.parametrize("warmup,total", [(100, 10_000), (2, 10_000),
                                          (1, 7)])
def test_fused_schedule_equals_the_tree_path(warmup, total, cuda_device):
    """The kernel's step, rate and bias corrections against the tree path's
    operators, bit for bit, over the warm-up, the decay and past its end
    (one-element leaves, the clip not engaged)."""
    cfg = AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total,
                      clip_norm=1e9)
    params, grads = _leaves(cuda_device, [1, 5], "flat",
                            (torch.float32, torch.float32))
    steps = sorted(set(range(0, total + 3, max(1, total // 700)))
                   | {warmup - 1, warmup, warmup + 1, total - 1, total})
    for s in steps:
        state = adamw_init(params, cfg)
        state["step"].fill_(s)
        fp, fs, fm = adamw_update(params, grads, _clone_state(state), cfg)
        tp, ts, tm = adamw._tree_update(params, grads, state, cfg, False)
        assert int(fs["step"]) == int(ts["step"]) == s + 1
        assert torch.equal(fm["lr"], tm["lr"]), (s, float(fm["lr"]),
                                                  float(tm["lr"]))
        for a, b in zip(tree_leaves(fp), tree_leaves(tp)):
            assert torch.equal(a, b), s


@pytest.mark.cuda
def test_fused_is_one_adamw_vertex_of_a_capture(cuda_device):
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    params, grads = _leaves(cuda_device, SIZES, "flat",
                            (torch.float32, torch.float32))
    state = adamw_init(params, cfg)
    graph, _ = op_graph.capture(
        lambda p, g, s: adamw_update(p, g, s, cfg, inplace=True),
        params, grads, state)
    torch.cuda.synchronize()
    labels = list(graph.node_labels)
    assert labels.count("adamw") == 1
    assert set(labels) <= {"input", "free", "adamw"}, set(labels)
