"""The unembedding's device milliseconds a request: the union of the
device intervals of every kernel, copy or memset launched inside the
program span `models.unembed` (the final norm and the product with the
tied table, at every position the forward runs), whatever the kernels
are named (`portbench.spans`)."""
from portbench import spans

SPAN = "models.unembed"


def read(w):
    found = spans.intervals(w, SPAN)
    if found is None:
        return None
    return spans.union_ms(w, spans.launched_in(w, found, SPAN))
