"""Speed-of-light accounting for the bootstrap kernels on the H100.

Counterpart of ``memento_tpu/utils/roofline.py``.  For one tile of kernel
inputs it counts the bytes the work must move (each input read once, the
output written once) and the arithmetic the kernel
(``csrc/cascade_bootstrap.cu``) does on these inputs, bin by bin as the
data occupies them, and sets both against the card's peak rates.  The
least time for the work is the larger of the two quotients.

Two operation counts are kept: the redesigned kernel's own (``ops``), and
the first design's (``ops_first_design``), which every record since the
first port uses as the common yardstick.

``multinomial_tile_cost`` / ``multinomial_roofline`` do the same for the
exact sampler's kernel (``csrc/multinomial_bootstrap.cu``): the operations
that its draws take at least, in expectation over the resample.
``gev_refine_cost`` / ``gev_refine_roofline`` are the GEV refit kernel's
(``csrc/gev_refine.cu``) floor: its likelihood evaluations at the card's
float64 rate, and one read of the tails.
"""

from __future__ import annotations

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, FP32 operations/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12

# Operations per draw of the cascade kernel (each arithmetic instruction one
# operation), counted from the first design of csrc/cascade_bootstrap.cu: one
# Philox call per draw and the CDF rebuilt by every thread.  The kernel has
# since been redesigned and does less than this (its time has read below
# this count's bound), but these counts stay unchanged as the common
# yardstick of every record: ``ops_first_design``.  ``ops`` is the
# redesigned kernel's own count, below.  Note that PEAK_FP32_S counts a
# fused multiply-add as two operations and both counts as one: half of such
# a bound is about the whole FP32 issue rate.
OPS_PHILOX = 10 * 10 + 8  # 10 rounds of 2 mul.hi, 2 mul.lo, 4 xor, 2 adds
OPS_GAUSS = 30  # 2 uniforms, log, sqrt, cos, CF term, round, clamp
OPS_TABLE_FIXED = 20  # uniform, exp, sqrt, trip count, shift, clamp
OPS_TABLE_STEP = 5  # compare-add, multiply, divide, add
OPS_PER_WEIGHT = 2  # multiply-add into each of the W sums
# The redesigned kernel's own counts, from its SASS (loads, branches and
# address arithmetic not counted): a Philox call serves a group of four bins
# (one call for its table bins, one for its Gaussian bins), the table draw
# is a 5-step search of a shared-memory table.
OPS_PHILOX_CALL = 10 * 4  # 10 rounds of 2 wide multiplies, 2 3-input xors
OPS_NORMALS = 38  # four uniforms, two Box-Muller pairs (log, sqrt, sin, cos)
OPS_TABLE_DRAW = 19  # 5 x (compare, add), shift, rescale, shift, clamp
OPS_GAUSS_DRAW = 11  # sigma, CF term, round, clamp


# The multinomial kernel's operations, per instruction as above, on the fast
# path of each (loads, branches and address arithmetic not counted; a
# correctly rounded division or square root, logf and log1pf each counted as
# a few instructions, though their full sequences are longer): so its bound
# lies below any time the kernel can reach.  Each binomial draw starts its
# own Philox call (OPS_PHILOX_CALL); an inversion draw then takes a uniform
# per waiting time, X + 1 of them for a draw X, four to a call; a BTRS draw
# sets up once and takes at least one try of two uniforms.
BTRS_MIN = 10.0  # BTRS where trials x min(p, 1 - p) reach this
ABSORB = 1.0 - 1e-6  # a bin with this share of the tail takes every trial
OPS_UNIFORM = 4  # shift, convert, scale, clamp
OPS_INVERSION_STEP = OPS_UNIFORM + 8  # log, divide, ceil, add, test, count
OPS_BTRS_SETUP = 30  # square root, two divisions, a dozen products and sums
OPS_BTRS_TRY = 2 * OPS_UNIFORM + 14  # u - 1/2, |u|, a division, floor, tests


def _first_design(counts: np.ndarray, w_dim: int, num_boot: int):
    """Operations of the first design on these inputs and its bin classes:
    absorbing bins (a row's last occupied bin) draw no random numbers, the
    others a Gaussian at 8 or more, a table draw below."""
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
    bins = {"drawn_bins": int(drawn.sum()), "gauss_bins": int(gauss.sum()),
            "table_bins": int(table.sum())}
    return float(per_boot) * num_boot, bins


def _redesign(counts: np.ndarray, w_dim: int, num_boot: int):
    """Operations of the redesigned kernel on these inputs, with one Philox
    call per group of four bins and branch, and its Philox calls per
    replicate."""
    t_dim, u_dim = counts.shape
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
    philox_calls = int(table.any(2).sum() + gauss.any(2).sum())
    return float(per_boot) * num_boot, philox_calls


def cascade_tile_cost(counts: np.ndarray, num_boot: int, w_dim: int) -> dict:
    """The work of one launch of the cascade kernel on a tile.

    Args:
      counts: ``[T, U]`` bin multiplicities as the kernel receives them
        (zeros = ragged-U padding), in their own dtype: the kernel's
        inputs are float32, and the counts are taken in it.
      num_boot: replicates B.
      w_dim: weight columns W.

    Returns:
      dict with ``hbm_bytes``, ``ops`` (the redesign's count),
      ``ops_first_design``, ``useful_draws`` (occupied bins x B, as the
      JAX package counts them), ``drawn_bins``, ``gauss_bins``,
      ``table_bins`` and ``philox_calls_per_replicate``.
    """
    counts = np.asarray(counts)
    t_dim, u_dim = counts.shape
    hbm_bytes = 4 * (counts.size * (1 + w_dim) + t_dim
                     + t_dim * w_dim * num_boot)
    ops_first, bins = _first_design(counts, w_dim, num_boot)
    ops, philox_calls = _redesign(counts, w_dim, num_boot)
    return {
        "hbm_bytes": float(hbm_bytes),
        "ops": ops,
        "ops_first_design": ops_first,
        "useful_draws": float((counts > 0).sum()) * num_boot,
        **bins,
        "philox_calls_per_replicate": philox_calls,
    }


def multinomial_tile_cost(counts: np.ndarray, num_boot: int,
                          w_dim: int) -> dict:
    """The least work of one launch of the multinomial kernel on a tile.

    Bin u of a row draws from the trials left after the bins before it,
    ``ctail[u]`` of them in expectation (the row's counts sum to its
    trials), with ``p = counts[u] / ctail[u]``; so ``trials x q`` is
    ``min(counts[u], ctail[u] - counts[u])`` in expectation, which picks the
    algorithm and the waiting times of an inversion draw.  A bin is reached
    with trials left with probability at least ``1 - exp(-ctail[u])``; the
    row's last occupied bin takes what is left without a draw.

    Args: as ``cascade_tile_cost``.

    Returns:
      dict with ``hbm_bytes`` (as the cascade's: each input read once, the
      sums written once), ``ops``, ``draws`` (binomial draws),
      ``inversion_bins``, ``btrs_bins`` and ``philox_calls_per_replicate``
      (all in expectation).
    """
    counts = np.asarray(counts, np.float64)
    t_dim, _ = counts.shape
    ctail = np.cumsum(counts[:, ::-1], axis=1)[:, ::-1]
    occupied = counts > 0
    live = np.where(occupied, -np.expm1(-ctail), 0.0)
    drawn = occupied & (counts < ABSORB * ctail)
    nq = np.minimum(counts, ctail - counts)
    inversion = drawn & (nq < BTRS_MIN)
    btrs = drawn & ~inversion
    steps = nq + 1.0  # uniforms of an inversion draw
    calls = np.where(inversion, np.maximum(1.0, steps / 4.0), 1.0) * drawn
    per_draw = (calls * OPS_PHILOX_CALL
                + np.where(inversion, steps * OPS_INVERSION_STEP,
                           OPS_BTRS_SETUP + OPS_BTRS_TRY) * drawn)
    per_boot = ((live * per_draw).sum()
                + live.sum() * (OPS_PER_WEIGHT * w_dim + 1))
    hbm_bytes = 4 * (counts.size * (1 + w_dim) + t_dim
                     + t_dim * w_dim * num_boot)
    return {
        "hbm_bytes": float(hbm_bytes),
        "ops": float(per_boot) * num_boot,
        "draws": float((live * drawn).sum()) * num_boot,
        "inversion_bins": int(inversion.sum()),
        "btrs_bins": int(btrs.sum()),
        "philox_calls_per_replicate": float((live * calls).sum()),
    }


# The GEV refit kernel's float64 work, per value a likelihood goes over (the
# Nelder-Mead evaluations of every fit; its starts and KS passes are not
# counted): a log and an exp, counted as the fused multiply-adds of their
# polynomials and reductions, two correctly rounded divisions as their
# Newton steps, and the product, difference and sum of the term.  Each
# float64 instruction counts as two operations, as the peak counts a fused
# multiply-add, so the bound is that of the card's full float64 issue rate.
PEAK_FP64_S = 34e12  # H100 SXM, float64 outside the tensor cores
FMA_LOG = 15
FMA_EXP = 13
FMA_DIV = 5
FMA_TERM = 3
OPS_GEV_VALUE = 2 * (FMA_LOG + FMA_EXP + 2 * FMA_DIV + FMA_TERM)
# bytes a row: its two tails (float64), |stat| (float64) and finite flag
# (one byte) read, its five float64 outputs written
GEV_ROW_BYTES_FIXED = 8 + 1 + 5 * 8


def gev_refine_cost(values_fitted: float, n_rows: int,
                    tail_len: int) -> dict:
    """The floor of one launch of the GEV kernel: ``values_fitted`` is the
    sum of the kernel's last output column (the values its likelihoods
    went over), ``n_rows`` the rows and ``tail_len`` the tails' length."""
    return {
        "ops": OPS_GEV_VALUE * float(values_fitted),
        "hbm_bytes": n_rows * (2 * tail_len * 8 + GEV_ROW_BYTES_FIXED),
        "values_fitted": float(values_fitted),
    }


def gev_refine_roofline(values_fitted: float, n_rows: int, tail_len: int,
                        measured_s: float,
                        fp64_ops_per_s: float = PEAK_FP64_S,
                        hbm_bytes_per_s: float = PEAK_BYTES_S) -> dict:
    """``roofline`` for one measured launch of the GEV kernel
    (``gev_refine_cost``); its compute resource is ``"fp64"``."""
    cost = gev_refine_cost(values_fitted, n_rows, tail_len)
    out = _verdict(cost, measured_s, fp64_ops_per_s, hbm_bytes_per_s)
    out["fp64_utilization"] = out.pop("fp32_utilization")
    if out["limiting_resource"] == "fp32":
        out["limiting_resource"] = "fp64"
    return out


def _verdict(cost: dict, measured_s: float, fp32_ops_per_s: float,
             hbm_bytes_per_s: float) -> dict:
    t_compute = cost["ops"] / fp32_ops_per_s
    t_memory = cost["hbm_bytes"] / hbm_bytes_per_s
    bound = max(t_compute, t_memory)
    return {
        **cost,
        "measured_s": float(measured_s),
        "t_compute_bound_s": t_compute,
        "t_memory_bound_s": t_memory,
        "bound_s": bound,
        "fp32_utilization": t_compute / measured_s,
        "hbm_utilization": t_memory / measured_s,
        "limiting_resource": "fp32" if t_compute >= t_memory else "hbm",
        "speed_of_light_gap": measured_s / max(bound, 1e-12),
    }


def roofline(counts: np.ndarray, num_boot: int, measured_s: float,
             w_dim: int, fp32_ops_per_s: float = PEAK_FP32_S,
             hbm_bytes_per_s: float = PEAK_BYTES_S) -> dict:
    """Roofline verdict for one measured launch on ``counts``: the work,
    its compute and memory bounds, the utilisation of each peak and the
    limiting resource (``"fp32"`` on a tie)."""
    cost = cascade_tile_cost(counts, num_boot, w_dim)
    return {
        **_verdict(cost, measured_s, fp32_ops_per_s, hbm_bytes_per_s),
        "useful_draws_per_s": cost["useful_draws"] / measured_s,
        "t_compute_bound_first_design_s":
            cost["ops_first_design"] / fp32_ops_per_s,
    }


def multinomial_roofline(counts: np.ndarray, num_boot: int,
                         measured_s: float, w_dim: int,
                         fp32_ops_per_s: float = PEAK_FP32_S,
                         hbm_bytes_per_s: float = PEAK_BYTES_S) -> dict:
    """``roofline`` for one measured launch of the multinomial kernel
    (``multinomial_tile_cost``), with ``draws_per_s``."""
    cost = multinomial_tile_cost(counts, num_boot, w_dim)
    return {
        **_verdict(cost, measured_s, fp32_ops_per_s, hbm_bytes_per_s),
        "draws_per_s": cost["draws"] / measured_s,
    }


__all__ = ["cascade_tile_cost", "roofline", "multinomial_tile_cost",
           "multinomial_roofline", "gev_refine_cost", "gev_refine_roofline",
           "PEAK_BYTES_S", "PEAK_FP32_S", "PEAK_FP64_S"]
