"""The flash-attention forward kernel's share of its roofline, %: the
least time of its calls in the traced units (`yardstick.fa_fwd_work`:
2·Dqk + 2·Dv a kept pair at 165 TFLOP/s, or q, k, v and the output once
at 3.35 TB/s, whichever is longer) over the device time of its launches,
found by name (`fa_fwd_kernel<`) and counted against the wrapper's
`launches`."""
from portbench import yardstick

COUNTERS = {"fa_fwd": ("repro_torch.kernels.flash_attention", "launches")}
NAMES = ("fa_fwd_kernel<",)


def read(w):
    launched = w.counters["fa_fwd"]
    calls = w.work.fwd_calls
    found = w.kernels(*NAMES)
    if launched == 0 and not found:
        return None         # the kernel is off the path
    if len(found) != launched or launched != w.units * len(calls):
        raise RuntimeError(
            f"flash-attention forward: {launched} launches counted, "
            f"{len(found)} kernels of {NAMES} in the trace, "
            f"{w.units * len(calls)} calls in the model's work")
    least = w.units * sum(yardstick.least_seconds(yardstick.fa_fwd_work(c))
                          for c in calls)
    return 100.0 * least / sum(s for _, s in found)
