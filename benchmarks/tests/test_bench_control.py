"""The comparison that decides ``correct`` has to fail: for the control
(the reference in the precision below the configuration's, in the program's
place) and for each fault that the cells can have, planted in the program
underneath the harness (``benchmarks/faults.py``)."""

import tempfile
from pathlib import Path

import pytest
import torch

from benchmarks import control, faults, run
from conftest import SEED

WORKLOADS = ["atlas-1d-sweep-exact", "pbmc-2d-queries-exact"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(tiny, workload):
    cell = tiny(workload, n_cells=6000)
    out = control.run_seed(cell, SEED, 8, torch.device("cpu"))
    assert out["compared"] >= 1
    assert out["correct"] is False, out


@pytest.mark.card
def test_control_is_not_correct_on_the_card(card):
    """At the cell's own size on the card (``-m card``)."""
    cell = run.find_cell(run.ROOT, "pbmc-2d-queries-exact")
    out = control.run_seed(cell, SEED, 64, card)
    assert out["correct"] is False, out


def _run(cell):
    return run.run_cell(cell, SEED, 1.0, False, "cpu",
                        Path(tempfile.gettempdir()))


@pytest.mark.parametrize("workload,fault", [(w, f) for w in WORKLOADS
                                            for f in sorted(faults.FAULTS)])
def test_fault_is_not_correct(tiny, workload, fault):
    cell = tiny(workload)
    assert _run(cell)["correct"] is True
    undo = faults.plant(fault, cell.kind().Runner.kind)
    try:
        out = _run(cell)
    finally:
        undo()
    assert out["correct"] is False, out["compared"]
    assert _run(cell)["correct"] is True  # and the fault is out again
