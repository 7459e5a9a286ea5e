"""The flash-attention backward's share of its roofline, %: the least
time of the backward calls in the traced units (`yardstick.fa_bwd_work`:
4·Dqk + 4·Dv a kept pair, no recompute, at 165 TFLOP/s, or the inputs
and gradients once at 3.35 TB/s) over the device time of all its
launches, found by name (`delta_kernel<`, `bwd_kernel<`,
`mla_bwd_kernel<`); each backward call is one `delta_kernel` launch,
counted against the wrapper's `launches_bwd`."""
from portbench import yardstick

COUNTERS = {"fa_bwd": ("repro_torch.kernels.flash_attention",
                       "launches_bwd")}
NAMES = ("delta_kernel<", "bwd_kernel<")


def read(w):
    launched = w.counters["fa_bwd"]
    calls = w.work.bwd_calls
    found = w.kernels(*NAMES)
    if launched == 0 and not found:
        return None         # the kernels are off the path
    deltas = [n for n, _ in found if "delta_kernel<" in n]
    if len(deltas) != launched or launched != w.units * len(calls):
        raise RuntimeError(
            f"flash-attention backward: {launched} calls counted, "
            f"{len(deltas)} delta_kernel launches in the trace, "
            f"{w.units * len(calls)} calls in the model's work")
    least = w.units * sum(yardstick.least_seconds(yardstick.fa_bwd_work(c))
                          for c in calls)
    return 100.0 * least / sum(s for _, s in found)
