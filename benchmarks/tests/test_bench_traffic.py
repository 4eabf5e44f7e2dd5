"""The traffic mixes: request order and sizes fixed, genes drawn from the
seed."""

import numpy as np
import torch

from benchmarks import data
from conftest import SEED


def test_sweep_smallest_first_cycling(tiny):
    cell = tiny("atlas-1d-sweep-exact", n_cells=1200, n_genes=80)
    ds = data.draw(cell.config, SEED, "cpu")
    runner = cell.kind().Runner(None, ds, cell.config, cell.traffic, SEED,
                                torch.device("cpu"))
    gen = runner.requests()
    reqs = [next(gen) for _ in range(2 * len(ds.types))]
    sizes = [ds.types[r["type"]].n_cells for r in reqs]
    n = len(ds.types)
    assert sizes[:n] == sorted(sizes[:n])
    assert sizes[:n] == sizes[n:]
    assert len({r["seed"] for r in reqs}) == len(reqs)


def _queries(cell, seed):
    ds = data.draw(cell.config, seed, "cpu")
    runner = cell.kind().Runner(None, ds, cell.config, cell.traffic, seed,
                                torch.device("cpu"))
    return runner.queries


def test_queries_same_sizes_any_seed(tiny):
    cell = tiny("pbmc-2d-queries-exact", n_cells=2000, n_genes=200)
    a = _queries(cell, SEED)
    b = _queries(cell, SEED + 1)
    sa = sorted(q["targets"].size for q in a)
    sb = sorted(q["targets"].size for q in b)
    assert sa == sb
    assert min(sa) >= cell.traffic["targets_min"]
    assert max(sa) <= cell.traffic["targets_max"]


def test_queries_deterministic_by_seed(tiny):
    cell = tiny("pbmc-2d-queries-exact", n_cells=2000, n_genes=200)
    a = _queries(cell, SEED)
    b = _queries(cell, SEED)
    for qa, qb in zip(a, b):
        assert qa["tf"] == qb["tf"]
        np.testing.assert_array_equal(qa["targets"], qb["targets"])
        assert qa["tf"] not in set(qa["targets"])


def test_cycle_sizes_log_spaced(tiny):
    cell = tiny("pbmc-2d-queries-exact")
    kind = cell.kind()
    tr = dict(cell.traffic, cycle=64, targets_min=50, targets_max=1000)
    sizes = kind.cycle_sizes(tr)
    assert sizes.size == 64 and sizes.min() >= 50 and sizes.max() <= 1000
    # the mean of a log-uniform law on [50, 1000]
    assert abs(sizes.mean() - 950 / np.log(20)) < 10
