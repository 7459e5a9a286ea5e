"""The device's idle milliseconds a step while the host runs AdamW: the
length of the program span `optim.adamw` less the union of every device
interval inside it, whoever launched it (`portbench.spans`).  The span
must launch device work, or the run fails."""
from portbench import spans

SPAN = "optim.adamw"


def read(w):
    found = spans.intervals(w, SPAN)
    if found is None:
        return None
    spans.launched_in(w, found, SPAN)
    return spans.idle_ms(w, found)
