"""The traced window from synthetic Chrome trace events: the busy time as
a union, the idle gaps named by the host's operator, and the readers."""
import pytest

from portbench import harness, tracing, yardstick

FWD = "void (anonymous namespace)::fa_fwd_kernel<float, 64, 64>(float const*)"
DELTA = "void (anonymous namespace)::delta_kernel<float, 64>(float const*)"
BWD = "void (anonymous namespace)::bwd_kernel<float, 64, 64, true>(float*)"
GEMM = "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>()"
REDUCE = "void splitKreduce_kernel<32, 16, int, float, float>(float*)"
# the two products' FLOPs: [2, 8, 16] by [16, 32], and [16, 32] by [32, 16]
PRODUCT_FLOPS = 2 * 2 * 8 * 16 * 32 + 2 * 16 * 32 * 16


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _events():
    return [
        _x("user_annotation", tracing.UNIT, 100, 100),
        _x("user_annotation", tracing.UNIT, 200, 100),
        _x("cpu_op", "aten::matmul", 100, 30,
           **{"Input Dims": [[2, 8, 16], [16, 32]]}),
        _x("cpu_op", "aten::mm", 101, 28,                   # inside it
           **{"Input Dims": [[16, 16], [16, 32]]}),
        _x("cuda_runtime", "cudaLaunchKernel", 104, 2, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 108, 2, correlation=2),
        _x("cpu_op", "aten::copy_", 150, 60),
        _x("cuda_runtime", "cudaLaunchKernel", 155, 5, correlation=3),
        # the backward's product, on a thread of its own
        _x("cpu_op", "aten::mm", 202, 6, tid=2,
           **{"Input Dims": [[16, 32], [32, 16]]}),
        _x("cuda_runtime", "cudaLaunchKernel", 204, 2, tid=2,
           correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 240, 2, tid=2,
           correlation=5),
        _x("kernel", GEMM, 110, 40, tid=7, correlation=1),
        _x("kernel", REDUCE, 150, 5, tid=7, correlation=2),
        _x("kernel", FWD, 140, 20, tid=7, correlation=3),   # overlaps
        _x("kernel", GEMM, 210, 40, tid=8, correlation=4),
        _x("kernel", DELTA, 250, 5, tid=7, correlation=5),
        _x("kernel", BWD, 255, 25, tid=7),
        _x("kernel", BWD, 270, 10, tid=8),          # a second stream
        _x("gpu_memcpy", "Memcpy DtoH", 290, 5, tid=7),
        _x("kernel", GEMM, 20, 50, tid=7),          # before the window
    ]


def _window(counters, dense_flops=PRODUCT_FLOPS / 2):
    call = yardstick.AttnCall(1, 16, 16, 2, 1, 64, 64, causal=True)
    work = yardstick.UnitWork(1e9, (call,), (call,), dense_flops)
    return tracing.window_from_events(_events(), work, counters)


def test_busy_is_the_union_and_idle_gaps_are_named():
    w = _window({"fa_fwd": 1, "fa_bwd": 1})
    assert w.units == 2 and (w.lo, w.hi) == (100, 300)
    # busy: 110-160, 210-280, 290-295
    assert w.busy_s == pytest.approx(125e-6)
    assert w.window_s == pytest.approx(200e-6)
    b = w.breakdown()
    names = dict(b["idle_gaps"])
    # gaps 100-110 (aten::mm), 160-210 (aten::copy_ at 185), 280-290
    # and 295-300 (no operator)
    assert names["aten::mm"] == pytest.approx(10e-6)
    assert names["aten::copy_"] == pytest.approx(50e-6)
    assert names["no operator"] == pytest.approx(15e-6)
    assert b["device_ops"][0] == [GEMM, pytest.approx(80e-6)]


def test_products_are_the_kernels_launched_inside_product_operators():
    """The outermost product operators on each thread, their FLOPs from
    the recorded shapes, and every kernel launched inside one of them,
    the split-K reduction too, whatever its name."""
    flops, seconds, ops = _window({}).product_time()
    assert ops == 2 and flops == PRODUCT_FLOPS
    assert seconds == pytest.approx((40 + 5 + 40) * 1e-6)


@pytest.mark.parametrize("name,dims,flops", [
    ("aten::mm", [[3, 5], [5, 7]], 2 * 3 * 5 * 7),
    ("aten::addmm", [[7], [3, 5], [5, 7], [], []], 2 * 3 * 5 * 7),
    ("aten::bmm", [[4, 3, 5], [4, 5, 7]], 2 * 4 * 3 * 5 * 7),
    ("aten::matmul", [[2, 4, 3, 5], [5, 7]], 2 * 8 * 3 * 5 * 7),
    ("aten::matmul", [[2, 1, 3, 5], [4, 5, 7]], 2 * 8 * 3 * 5 * 7),
    ("aten::matmul", [[5], [5, 7]], 2 * 5 * 7),
    ("aten::linear", [[2, 3, 5], [7, 5], [7]], 2 * 6 * 5 * 7),
    ("aten::einsum", [[], [3, 5]], 0),
])
def test_product_flops_from_shapes(name, dims, flops):
    assert tracing.product_flops(name, dims) == flops


def test_product_flops_of_the_programs_step_cover_the_model():
    """On a real trace of the program's loss and gradients (on the CPU,
    at a small size), the product operators' FLOPs from their recorded
    shapes cover the dense products that the yardstick counts; on the
    CPU the plain attention's products come on top, at most three times
    the forward's full square of pairs."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.tests.conftest import small_cell
    from portbench.weights import Weights
    from repro_torch import models
    run = harness.Run(small_cell("smollm-360m.train"), 3, "cpu")
    spec = run.ref.param_spec(run.model)
    model = models.Model(run.model_cfg, device="cpu",
                         params=Weights(spec, 1, "cpu").tree())
    model.requires_grad_(True)
    params = list(model.parameters())
    tokens = torch.randint(0, run.model["vocab_size"], (2, 32))
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        with record_function(tracing.UNIT):
            loss = models.loss_fn(model, {"tokens": tokens})
            torch.autograd.grad(loss, params)
    work = yardstick.unit_work(run.ref.forward_work(run.model, 2, 32),
                               training=True)
    w = tracing.window_from_profile(prof, work, {})
    flops, _, ops = w.product_time()
    layers = run.model["n_layers"]
    assert ops >= 3 * (7 * layers + 1)
    square = sum(2 * c.B * c.Hq * c.Sq * c.Sk * (c.Dqk + c.Dv)
                 for c in work.fwd_calls)
    assert work.dense_flops <= flops <= work.dense_flops + 3 * square


def _read(metric, w):
    return harness._reader(metric).read(w)


def test_readers():
    w = _window({"fa_fwd": 2, "fa_bwd": 2})
    w.counters = {"fa_fwd": 1, "fa_bwd": 1}
    # two units each launch one forward and one backward call: the
    # trace holds one of each, so the counts do not meet
    with pytest.raises(RuntimeError):
        _read("fa_fwd_roofline.train", w)
    w = _window({"fa_fwd": 1, "fa_bwd": 1})
    w.units = 1
    assert _read("idle_share.train", w) == pytest.approx(100 * (1 - 125 / 200))
    assert _read("gemm_ms.train", w) == pytest.approx(85e-3)
    least = yardstick.least_seconds(yardstick.fa_fwd_work(w.work.fwd_calls[0]))
    assert _read("fa_fwd_roofline.train", w) == pytest.approx(
        100 * least / 20e-6)
    least = yardstick.least_seconds(yardstick.fa_bwd_work(w.work.bwd_calls[0]))
    assert _read("fa_bwd_roofline.train", w) == pytest.approx(
        100 * least / 40e-6)
    assert _read("mfu.prefill", w) == pytest.approx(
        100 * 1e9 / (200e-6 * yardstick.PEAK_FLOPS))


def test_a_launch_without_its_kernel_in_the_trace_fails():
    """Launches counted and no kernel of the name in the trace: the run
    fails, it does not read 0."""
    w = _window({"fa_fwd": 1, "fa_bwd": 1})
    w.units = 1
    w.device_ops = [op for op in w.device_ops if "fa_fwd" not in op[0]]
    with pytest.raises(RuntimeError):
        _read("fa_fwd_roofline.prefill", w)


def test_products_that_leave_the_product_operators_fail():
    """The model's dense FLOPs not all run inside product operators:
    the run fails, gemm_ms does not read a part of the products."""
    w = _window({}, dense_flops=PRODUCT_FLOPS)
    w.units = 2
    with pytest.raises(RuntimeError):
        _read("gemm_ms.train", w)
    w.units = 1
    assert _read("gemm_ms.prefill", w) == pytest.approx(85e-3)


def test_a_kernel_off_the_path_reads_nothing():
    w = _window({"fa_fwd": 0, "fa_bwd": 0})
    w.device_ops = [op for op in w.device_ops if "anonymous" not in op[0]]
    assert _read("fa_fwd_roofline.train", w) is None
    assert _read("fa_bwd_roofline.train", w) is None
