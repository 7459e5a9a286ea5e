"""AdamW's device operations a step: the kernels, copies and memsets
launched inside the program span `optim.adamw` (`portbench.spans`),
counted in the trace."""
from portbench import spans

SPAN = "optim.adamw"


def read(w):
    found = spans.intervals(w, SPAN)
    if found is None:
        return None
    return len(spans.launched_in(w, found, SPAN)) / w.units
