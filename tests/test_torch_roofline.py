"""The port's cost model of the cascade kernel (``utils/roofline.py``).

The counts are frozen below as they stood when the bounds of the kernel
table were first recorded: the model must reproduce them exactly, so that
every bound in the records keeps its meaning.  ``useful_draws`` is the JAX
package's definition (``memento_tpu/utils/roofline.py``), and the roofline
follows from the peaks it is given.
"""

import numpy as np
import pytest

from memento_tpu.utils import roofline as j_roof

from memento_tpu_torch.utils import roofline as t_roof

# ---- frozen copy of the cost model (do not edit) ---------------------------
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
OPS_PHILOX = 10 * 10 + 8
OPS_GAUSS = 30
OPS_TABLE_FIXED = 20
OPS_TABLE_STEP = 5
OPS_PER_WEIGHT = 2
OPS_PHILOX_CALL = 10 * 4
OPS_NORMALS = 38
OPS_TABLE_DRAW = 19
OPS_GAUSS_DRAW = 11


def cascade_work(counts, w_dim, num_boot):
    t_dim, u_dim = counts.shape
    nbytes = 4 * (counts.size * (1 + w_dim) + t_dim + t_dim * w_dim * num_boot)
    ctail = np.cumsum(counts[:, ::-1], axis=1)[:, ::-1]
    occupied = counts > 0
    absorbing = occupied & (counts >= ctail)
    drawn = occupied & ~absorbing
    gauss = drawn & (counts >= 8.0)
    table = drawn & (counts < 8.0)
    lam = np.where(table, counts, 0.0)
    n_iter = np.minimum(32, np.ceil(lam + 5.0 * np.sqrt(lam) + 4.0)) * table
    per_boot = (drawn.sum() * OPS_PHILOX + gauss.sum() * OPS_GAUSS
                + table.sum() * OPS_TABLE_FIXED + n_iter.sum() * OPS_TABLE_STEP
                + occupied.sum() * (OPS_PER_WEIGHT * w_dim + 1))
    return nbytes, float(per_boot) * num_boot


def cascade_work_redesign(counts, w_dim, num_boot):
    t_dim, u_dim = counts.shape
    nbytes, _ = cascade_work(counts, w_dim, num_boot)
    c = np.pad(counts, ((0, 0), (0, (-u_dim) % 4)))
    ctail = np.cumsum(c[:, ::-1], axis=1)[:, ::-1]
    occupied = c > 0
    drawn = occupied & ~(c >= ctail)
    gauss = (drawn & (c >= 8.0)).reshape(t_dim, -1, 4)
    table = (drawn & (c < 8.0)).reshape(t_dim, -1, 4)
    per_boot = (table.any(2).sum() * OPS_PHILOX_CALL
                + gauss.any(2).sum() * (OPS_PHILOX_CALL + OPS_NORMALS)
                + table.sum() * OPS_TABLE_DRAW + gauss.sum() * OPS_GAUSS_DRAW
                + occupied.sum() * (OPS_PER_WEIGHT * w_dim + 1))
    return nbytes, float(per_boot) * num_boot


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")
# ---------------------------------------------------------------------------


def tile_counts(seed, rows, bins):
    """Float32 bin counts laid out as the kernel receives them: each row's
    occupied bins first, zero padding after; small and large counts mixed,
    some empty rows, one row that fills every bin."""
    rng = np.random.default_rng(seed)
    counts = np.zeros((rows, bins), np.float32)
    occupied = rng.integers(0, bins + 1, rows)
    occupied[::17] = 0
    occupied[1] = bins
    for r, n in enumerate(occupied):
        large = rng.random(n) < 0.4
        counts[r, :n] = np.where(large, rng.integers(8, 2000, n),
                                 rng.integers(1, 8, n))
    return counts


# the 1D tile [3,840 x 576] and the 2D tile [2,048 x 2,880], scaled down; a
# bin count that is not a multiple of 4
SHAPES = [("1d", 384, 576, 2), ("1d_mean_only", 384, 576, 1),
          ("2d", 256, 360, 5), ("ragged", 96, 83, 2)]


@pytest.mark.parametrize("num_boot", [1000, 10_000])
@pytest.mark.parametrize("name, rows, bins, w_dim", SHAPES)
def test_cost_equals_the_frozen_counts(name, rows, bins, w_dim, num_boot):
    counts = tile_counts(rows + bins, rows, bins)
    cost = t_roof.cascade_tile_cost(counts, num_boot, w_dim)
    nbytes, ops_first = cascade_work(counts, w_dim, num_boot)
    _, ops = cascade_work_redesign(counts, w_dim, num_boot)
    assert cost["hbm_bytes"] == nbytes
    assert cost["ops"] == ops
    assert cost["ops_first_design"] == ops_first
    want = j_roof.cascade_tile_cost(counts, num_boot, w_dim=w_dim)
    assert cost["useful_draws"] == want["useful_draws"]
    # bins: every occupied bin but each row's last is drawn
    occupied = (counts > 0).sum()
    rows_occupied = (counts > 0).any(1).sum()
    assert cost["drawn_bins"] == occupied - rows_occupied
    assert cost["gauss_bins"] + cost["table_bins"] == cost["drawn_bins"]
    assert 0 < cost["philox_calls_per_replicate"] <= cost["drawn_bins"]


@pytest.mark.parametrize("name, rows, bins, w_dim", SHAPES)
def test_roofline_bound_equals_the_frozen_bound(name, rows, bins, w_dim):
    counts = tile_counts(7, rows, bins)
    roof = t_roof.roofline(counts, 1000, 2e-3, w_dim)
    ms, by = bound(*cascade_work_redesign(counts, w_dim, 1000))
    first_ms, _ = bound(*cascade_work(counts, w_dim, 1000))
    assert 1e3 * roof["bound_s"] == ms
    assert {"fp32": "operations", "hbm": "bytes"}[
        roof["limiting_resource"]] == by
    assert 1e3 * max(roof["t_memory_bound_s"],
                     roof["t_compute_bound_first_design_s"]) == first_ms


def test_roofline_follows_from_the_peaks():
    counts = tile_counts(3, 384, 576)
    cost = t_roof.cascade_tile_cost(counts, 1000, 2)
    measured = 1.8e-3
    roof = t_roof.roofline(counts, 1000, measured, 2)
    t_ops = cost["ops"] / t_roof.PEAK_FP32_S
    t_bytes = cost["hbm_bytes"] / t_roof.PEAK_BYTES_S
    assert t_ops > t_bytes and roof["limiting_resource"] == "fp32"
    assert roof["t_compute_bound_s"] == t_ops
    assert roof["t_memory_bound_s"] == t_bytes
    assert roof["bound_s"] == t_ops
    assert roof["fp32_utilization"] == t_ops / measured
    assert roof["hbm_utilization"] == t_bytes / measured
    assert roof["speed_of_light_gap"] == measured / t_ops
    assert roof["useful_draws_per_s"] == cost["useful_draws"] / measured
    assert roof["measured_s"] == measured
    assert {k: roof[k] for k in cost} == cost

    # a card with a slow memory: the same work is bound by its bytes
    slow = t_roof.roofline(counts, 1000, measured, 2,
                           hbm_bytes_per_s=cost["hbm_bytes"] / (2 * t_ops))
    assert slow["limiting_resource"] == "hbm"
    assert slow["bound_s"] == slow["t_memory_bound_s"] == pytest.approx(
        2 * t_ops, rel=1e-12)
    # and one with a slow FP32 rate stays bound by operations
    fast_mem = t_roof.roofline(counts, 1000, measured, 2,
                               fp32_ops_per_s=1e12)
    assert fast_mem["limiting_resource"] == "fp32"
    assert fast_mem["bound_s"] == cost["ops"] / 1e12
    assert fast_mem["t_compute_bound_first_design_s"] == \
        cost["ops_first_design"] / 1e12


def test_the_first_design_count_is_above_the_redesign():
    """The first design calls Philox per draw and rebuilds the CDF per
    thread: on any tile its count is the larger."""
    for name, rows, bins, w_dim in SHAPES:
        cost = t_roof.cascade_tile_cost(tile_counts(1, rows, bins), 1000,
                                        w_dim)
        assert cost["ops_first_design"] > cost["ops"] > 0


# ---- the multinomial kernel's cost (csrc/multinomial_bootstrap.cu) --------

@pytest.mark.parametrize("row, kinds", [
    ([3.0, 27.0], "inversion"),  # 3 expected successes: 4 waiting times
    ([300.0, 700.0], "btrs"),
    ([36.0, 4.0], "inversion"),  # p > 0.5: min(p, 1 - p) picks inversion
    ([0.0, 5.0, 0.0, 0.0], "none"),  # one occupied bin takes every trial
])
@pytest.mark.parametrize("w_dim", [1, 5])
def test_multinomial_cost_of_one_row(row, kinds, w_dim):
    counts = np.asarray([row], np.float32)
    cost = t_roof.multinomial_tile_cost(counts, 100, w_dim)
    c = np.asarray(row, np.float64)
    ctail = np.cumsum(c[::-1])[::-1]
    live = np.where(c > 0, 1.0 - np.exp(-ctail), 0.0)
    first = min(c[0], ctail[0] - c[0])
    if kinds == "none":
        draw_ops, calls = 0.0, 0.0
    elif kinds == "inversion":
        calls = max(1.0, (first + 1.0) / 4.0)
        draw_ops = calls * 40 + (first + 1.0) * 12
    else:
        calls = 1.0
        draw_ops = 40 + 30 + 22
    want = live[0] * draw_ops + live.sum() * (2 * w_dim + 1)
    assert cost["ops"] == pytest.approx(100 * want, rel=1e-12)
    assert cost["philox_calls_per_replicate"] == pytest.approx(
        live[0] * calls, rel=1e-12)
    assert cost["inversion_bins"] == (kinds == "inversion")
    assert cost["btrs_bins"] == (kinds == "btrs")
    assert cost["hbm_bytes"] == 4 * (len(row) * (1 + w_dim) + 1
                                     + w_dim * 100)


def test_multinomial_cost_counts_no_more_philox_calls_than_the_draws_take(
        monkeypatch):
    """On group rows of 1D and 2D shape, the kernel's plain version (the
    same stream) makes at least the Philox calls the model counts, and not
    twice as many: the model is a floor, and not a loose one."""
    import torch

    from memento_tpu_torch.drivers._data import multinomial_counts
    from memento_tpu_torch.ops import philox, sampling

    calls = []
    group_words = philox.group_words

    def counted(*ids):
        calls.append(ids[0].numel())
        return group_words(*ids)

    monkeypatch.setattr(philox, "group_words", counted)
    rng = np.random.default_rng(4)
    for counts in (multinomial_counts(rng, 6, 2000, pair=False),
                   multinomial_counts(rng, 6, 300, pair=True)):
        calls.clear()
        c = torch.as_tensor(counts)
        sampling.fused_multinomial_sums_philox(c, torch.ones(*c.shape, 1),
                                               c.sum(1), 400, 9)
        made = sum(calls) / 400
        model = t_roof.multinomial_tile_cost(counts, 400, 1)
        assert model["philox_calls_per_replicate"] <= made \
            < 2 * model["philox_calls_per_replicate"]
        assert model["inversion_bins"] > 0


def test_multinomial_roofline_follows_from_the_peaks():
    counts = tile_counts(5, 96, 83)
    cost = t_roof.multinomial_tile_cost(counts, 1000, 5)
    measured = 2.8e-3
    roof = t_roof.multinomial_roofline(counts, 1000, measured, 5)
    t_ops = cost["ops"] / t_roof.PEAK_FP32_S
    t_bytes = cost["hbm_bytes"] / t_roof.PEAK_BYTES_S
    assert t_ops > t_bytes and roof["limiting_resource"] == "fp32"
    assert roof["bound_s"] == t_ops
    assert roof["fp32_utilization"] == t_ops / measured
    assert roof["draws_per_s"] == cost["draws"] / measured
    assert {k: roof[k] for k in cost} == cost
    # the kernel's draws cost more than the cascade's table and Gaussian
    # draws of the same tile
    assert cost["ops"] > t_roof.cascade_tile_cost(counts, 1000, 5)["ops"]
