"""AdamW's device milliseconds a step: the union of the device intervals
of every kernel, copy or memset launched inside the program span
`optim.adamw` (`repro_torch.optim.adamw_update`: the clip, the schedule
and every leaf's update), whatever the kernels are named
(`portbench.spans`)."""
from portbench import spans

SPAN = "optim.adamw"


def read(w):
    found = spans.intervals(w, SPAN)
    if found is None:
        return None
    return spans.union_ms(w, spans.launched_in(w, found, SPAN))
