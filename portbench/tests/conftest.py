"""The benchmark's tests run on the CPU from the root of the checkout:
`python -m pytest portbench/tests -q`.  Tests marked `cuda` need a card
and skip inside the test without one."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# full widths are for the card; the CPU tests shrink a cell to these
TINY = {"n_layers": 2, "d_model": 64, "n_heads": 4, "head_dim": 16,
        "d_ff": 128, "vocab_size": 256}
SHRINK = {
    "smollm-360m.train": ({"n_kv_heads": 2},
                          {"batch": 4, "seq_len": 32, "pool": 6}),
    "smollm-360m.prefill": ({"n_kv_heads": 2},
                            {"batch": 2, "seq_len": 32, "pool": 6,
                             "check_requests": 3}),
}


def small_cell(name: str):
    from portbench import harness
    model, traffic = SHRINK[name]
    return harness.load_cell(name, overrides={"model": {**TINY, **model},
                                              "traffic": traffic})


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
