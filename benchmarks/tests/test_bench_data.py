"""The frozen generator and the traffic: deterministic by seed, sizes fixed
by the configuration."""

import numpy as np
import pytest

from benchmarks import data, run
from conftest import SEED, shrink


def _cfg(**kw):
    cell = shrink(run.find_cell(run.ROOT, "atlas-1d-sweep-exact"), n_cells=1200,
                  n_genes=80)
    return dict(cell.config, **kw)


def test_same_seed_same_counts():
    a = data.draw(_cfg(), SEED, "cpu")
    b = data.draw(_cfg(), SEED, "cpu")
    for ta, tb in zip(a.types, b.types):
        assert (ta.X != tb.X).nnz == 0
        np.testing.assert_array_equal(ta.condition, tb.condition)
        np.testing.assert_array_equal(ta.donor, tb.donor)
    np.testing.assert_array_equal(a.planted, b.planted)


def test_other_seed_other_counts_same_sizes():
    a = data.draw(_cfg(), SEED, "cpu")
    b = data.draw(_cfg(), SEED + 1, "cpu")
    assert [t.n_cells for t in a.types] == [t.n_cells for t in b.types]
    assert any((ta.X != tb.X).nnz for ta, tb in zip(a.types, b.types))
    assert a.planted.sum() == b.planted.sum()


@pytest.mark.parametrize("seed", [0, -5, 2**31 + 7, 2**70])
def test_any_whole_number_is_a_seed(seed):
    assert 0 <= data.derive(seed, 1, 2) < 2**63


def test_type_sizes_sum_and_follow_shares():
    shares = [0.38, 0.19, 0.10, 0.09, 0.08, 0.08, 0.05, 0.03]
    sizes = data.type_sizes(200_000, shares)
    assert sum(sizes) == 200_000
    assert sizes == sorted(sizes, reverse=True)
    assert sizes[0] == 76_000


def test_groups_balanced_within_type():
    ds = data.draw(_cfg(), SEED, "cpu")
    for t in ds.types:
        _, counts = np.unique(t.condition * 100 + t.donor, return_counts=True)
        assert counts.max() - counts.min() <= 1
        assert counts.size == 2 * _cfg()["n_donors"]


def test_planted_effect_raises_stimulated_mean():
    cfg = _cfg(n_cells=8000, n_genes=200, effect=3.0, effect_share=0.25)
    ds = data.draw(cfg, SEED, "cpu")
    t = ds.types[0]
    X = t.X.toarray()
    ratio = X[t.condition == 1].mean(0) / np.maximum(
        X[t.condition == 0].mean(0), 1e-9)
    assert np.median(ratio[ds.planted]) > 2.0
    assert 0.8 < np.median(ratio[~ds.planted]) < 1.25
