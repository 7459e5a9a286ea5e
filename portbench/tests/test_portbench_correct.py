"""What decides `correct`: a whole run of each cell, shrunk to the CPU
(the harness's look for a card skipped, the kernels' plain versions in
the program), comes out correct; with each fault of `faults.py` planted
under the timed path it comes out not correct; and the control, the
reference one precision below the configuration's (TF32), fails the
cell's limits.  On the card the control also runs at full width over
fewer layers (`cuda` marker)."""
import time

import pytest
import torch

from portbench import control, faults, harness
from portbench.tests.conftest import SHRINK, small_cell

CELLS = sorted(SHRINK)
FAULT_CASES = [(c, f) for c in CELLS
               for f in faults.FAULTS[small_cell(c).traffic["loop"]]]


def _run(cell, wrap=None, seed=2**31 + 11):
    return harness.execute(cell, seed, 0.3, False, "cpu",
                           time.perf_counter(), wrap_step=wrap)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _run(small_cell(name))
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name,fault", FAULT_CASES)
def test_planted_fault_is_not_correct(name, fault):
    cell = small_cell(name)
    r = _run(cell, wrap=faults.FAULTS[cell.traffic["loop"]][fault])
    assert not r["correct"], (fault, r["checks"])


def _control_numbers(cell, device, seed=7):
    run = harness.Run(cell, seed, device)
    loop = run.loop()
    driver = loop.Driver(run)
    if run.traffic["loop"] == "prefill":
        for _ in range(run.traffic["check_requests"]):
            driver.unit()
    obs = driver.observe()
    driver.release()
    ref = loop.reference(run, obs)
    with control.lowered(device):
        low = loop.reference(run, obs)
    return loop.compare(obs, ref), loop.compare(low, ref)


def _fails(cell, numbers):
    return any(v > cell.limits[k]["limit"] for k, v in numbers.items())


@pytest.mark.parametrize("name", CELLS)
def test_control_stands_apart_from_the_program(name):
    """At the CPU's size, where the cell's limits (set at full size on
    the card) do not apply, the control's products round their inputs to
    TF32, and one of its numbers reads ten times the program's or more;
    the program passes the cell's limits."""
    cell = small_cell(name)
    prog, low = _control_numbers(cell, "cpu")
    assert not _fails(cell, prog), prog
    assert any(low[k] >= 10 * prog[k] for k in prog), (prog, low)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -12)])
    assert control.tf32_round(x).tolist() == [1.0 + 2 ** -10, 1.0,
                                              1.0 + 2 ** -9, -1.0]


# full width, fewer layers: what a card's test run can hold
CARD_DEPTH = {"smollm-360m.train": {"n_layers": 4},
              "smollm-360m.prefill": {"n_layers": 4}}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name, card):
    cell = harness.load_cell(name, overrides={"model": CARD_DEPTH[name]})
    prog, low = _control_numbers(cell, card)
    assert not _fails(cell, prog), prog
    assert _fails(cell, low), low
