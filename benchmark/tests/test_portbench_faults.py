"""The correctness check sees a broken timed path, and its control.

Each cell runs here at a small size on the CPU (the ``small_root``
fixture), the look for a card skipped: a sound run comes out correct,
and a run with a fault planted under the timed path
(``benchmark/faults.py``) comes out not correct, once for each fault the
cell can have. The control (the reference computed in TF32 in the
program's place) fails the limits too. The ``card`` tests make the same
readings at the cells' own sizes and limits on the card.
"""

import time

import pytest
import torch

from benchmark import faults, harness

CELLS = {"photos-tiled-c4": faults.SERVING, "patches-c8": faults.SERVING, "fed8-round-256": faults.TRAINING}
SEED = 2**31 + 4242


def run(root, cell, device, control=False):
    return harness.run_cell(root, cell, SEED, 0.5, False, device, time.perf_counter(), control=control)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct_and_the_control_is_not(small_root, cell):
    result, checks, controls = run(small_root, cell, torch.device("cpu"), control=True)
    assert result["correct"], checks
    assert not all(c.ok for c in controls), controls
    assert list(result)[-1] == "checks" and set(result["checks"]) == {c.name for c in checks}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in sorted(CELLS.items()) for f in sorted(fs)])
def test_a_planted_fault_is_not_correct(small_root, cell, fault):
    with CELLS[cell][fault]():
        result, checks, _ = run(small_root, cell, torch.device("cpu"))
    assert not result["correct"], checks


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_on_the_card_at_the_cells_size(full_root, cuda, cell):
    result, checks, controls = harness.run_cell(full_root, cell, SEED, 6.0, False, cuda, time.perf_counter(),
                                                control=True)
    assert result["correct"], checks
    assert not all(c.ok for c in controls), controls
    for fault in sorted(CELLS[cell]):
        if (cell, fault) == ("patches-c8", "half_batch"):
            continue  # no patch rides past lane 8 of 32: the fault cannot occur at this size
        with CELLS[cell][fault]():
            result, checks, _ = harness.run_cell(full_root, cell, SEED, 6.0, False, cuda, time.perf_counter())
        assert not result["correct"], (fault, checks)
