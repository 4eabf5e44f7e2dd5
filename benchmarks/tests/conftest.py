"""Shared fixtures of the benchmark's CPU tests.

Run with ``python -m pytest benchmarks/tests -q`` from the repository's
root.  Tests marked ``card`` need a CUDA device; they decide inside a
fixture whether to skip, and run on the card with ``python -m pytest
benchmarks/tests -q -m card``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a seed past 32 signed bits, as the driver's are
SEED = 2**31 + 4242


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


# limits of the bootstrap's numbers at the tests' size: with B = 200 and a
# few dozen items a request, two exact bootstraps differ by more than at a
# cell's size (the coefficients' limits hold as they are); read at this
# size, one seed, sound against the faults of ``benchmarks/faults.py``
TINY_LIMITS = {"se_shift": 0.15, "se_shift_top": 0.3, "pval_shift": 0.15}


def shrink(cell, n_cells=6000, n_genes=600, n_donors=2):
    """A cell at a size the CPU runs in seconds: fewer cells, genes and
    donors, ``B = 200``, short queries, and the bootstrap's limits for
    that size (``TINY_LIMITS``).

    Not much smaller: with 30 cells a group and 600 genes, cells share size
    factors, and a gene whose few counts of 1 fall on cells of one factor
    has a group variance of exactly zero in exact arithmetic, whose sign
    (and so the gene filter) each side's rounding decides."""
    cell.config = dict(cell.config, n_cells=n_cells, n_genes=n_genes,
                       n_donors=n_donors)
    cell.traffic = dict(cell.traffic, num_boot=200, candidate_genes=40,
                        targets_min=10, targets_max=30, cycle=8)
    cell.checks = {"limits": {
        k: TINY_LIMITS.get(k.split(".")[0], v)
        for k, v in cell.checks["limits"].items()}}
    return cell


@pytest.fixture
def tiny():
    """``tiny(workload)``: the workload's cell, shrunk."""
    from benchmarks import run

    return lambda workload, **kw: shrink(run.find_cell(run.ROOT, workload),
                                         **kw)
