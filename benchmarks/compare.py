"""The numbers that decide ``correct``.

Each compares what the program's timed path returned for one request with
what the plain reference (``benchmarks/reference.py``) works out from the
same inputs, item by item (genes or gene pairs), for each statistic
(``de`` and ``dv`` of the 1D test, ``dc`` of the 2D test):

- ``items_differ``: items tested by one side only, plus items whose
  coefficient is finite on one side only (exact: limit 0);
- ``coef_gap.<stat>``: the widest gap between the two observed
  coefficients, in units of the reference's standard error.  The observed
  coefficient is deterministic: the host moments and the meta-regression;
- ``se_shift.<stat>``: ``|median log(se_program / se_reference)|`` over the
  items, the bootstrap's spread in distribution (the two bootstraps draw
  independently, so each item's ratio scatters by a few percent, and the
  median of thousands does not);
- ``se_shift_top.<stat>``: the same over the tenth of the items with the
  smallest reference SE (at least 20), where rounding weighs most;
- ``pval_shift.<stat>``: ``|median (z_program - z_reference)|`` with ``z =
  isf(p / 2)`` of the normal law, the p-values in distribution, GEV-refined
  ones included.

A number with nothing to compare is left out of the request's numbers.  A
number is compared only where the cell's checks file gives it a limit, and
one that no compared request gave fails; the others are printed for the
record.
"""

from __future__ import annotations

import numpy as np


def _z(p):
    from scipy.stats import norm

    return norm.isf(np.clip(p, 1e-300, 1.0) / 2.0)


def numbers(prog: dict, ref: dict, stats) -> dict:
    """Compare one request.

    Args:
      prog, ref: ``{"items": names, "<stat>_coef": .., "<stat>_se": ..,
        "<stat>_pval": ..}`` numpy arrays, items in any order.
      stats: the statistics' names.

    Returns:
      ``{number name: value}``.
    """
    p_items = np.asarray(prog["items"])
    r_items = np.asarray(ref["items"])
    common, pi, ri = np.intersect1d(p_items, r_items, return_indices=True)
    out = {"items_differ": float(p_items.size + r_items.size
                                 - 2 * common.size)}
    for s in stats:
        pc, rc = prog[f"{s}_coef"][pi], ref[f"{s}_coef"][ri]
        ps, rs = prog[f"{s}_se"][pi], ref[f"{s}_se"][ri]
        pp, rp = prog[f"{s}_pval"][pi], ref[f"{s}_pval"][ri]
        out["items_differ"] += float((np.isfinite(pc) != np.isfinite(rc))
                                     .sum())
        ok = np.isfinite(pc) & np.isfinite(rc) & np.isfinite(ps) \
            & np.isfinite(rs) & (rs > 0) & (ps > 0)
        okp = ok & np.isfinite(pp) & np.isfinite(rp)
        if ok.any():
            out[f"coef_gap.{s}"] = float(np.max(np.abs(pc[ok] - rc[ok])
                                                / rs[ok]))
            lr = np.log(ps[ok] / rs[ok])
            out[f"se_shift.{s}"] = float(abs(np.median(lr)))
            # the tenth of the items with the smallest reference SE (the
            # most expressed), where rounding weighs most against the spread
            k = max(20, lr.size // 10)
            if lr.size >= k:
                top = np.argsort(rs[ok], kind="stable")[:k]
                out[f"se_shift_top.{s}"] = float(abs(np.median(lr[top])))
        if okp.any():
            out[f"pval_shift.{s}"] = float(abs(np.median(_z(pp[okp])
                                                         - _z(rp[okp]))))
    return out


def worst(per_request: list) -> dict:
    """The worst of each number over the compared requests; a NaN is the
    worst of all."""
    out = {}
    for nums in per_request:
        for k, v in nums.items():
            if k not in out or np.isnan(v) or v > out[k]:
                out[k] = out[k] if k in out and np.isnan(out[k]) else v
    return out


def within(value: float, limit: float) -> bool:
    return bool(np.isfinite(value) and value <= limit)


def judge(per_request: list, limits: dict) -> dict:
    """``numbers``: each limited number's worst value beside its limit;
    ``within``: all inside; ``failed_requests``: compared requests with a
    number past its limit; ``others``: the unlimited numbers."""
    w = worst(per_request)
    failed = sum(any(k in nums and not within(nums[k], lim)
                     for k, lim in limits.items()) for nums in per_request)
    return {"numbers": {k: (w.get(k, float("nan")), lim)
                        for k, lim in limits.items()},
            "within": all(within(w.get(k, float("nan")), lim)
                          for k, lim in limits.items()),
            "failed_requests": int(failed),
            "others": {k: v for k, v in w.items() if k not in limits}}


__all__ = ["numbers", "worst", "judge", "within"]
