"""Achieved significance levels.

Counterpart of ``memento_tpu/inference/asl.py``, in two stages:

1. ``asl_counting`` on the device: the normal-approximation p-value or the
   two-sided extreme-count p-value of every test, plus a flag for tests
   whose extreme count is small enough (<= 10) for a GEV tail refit;
2. ``gev_refine`` (serial scipy oracle) and ``inference.gev`` (batched) on
   the host, for the flagged tests only.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

GEV_COUNT_THRESHOLD = 10


def asl_counting(coef, resampling: str, approx: bool):
    """First-stage ASL.

    Args:
      coef: ``[..., B+1]`` coefficients; column 0 observed.
      resampling: 'bootstrap' (null = coef[1:] - coef[0]) or 'permutation'
        (null = coef[1:]).
      approx: two-sided normal fit instead of counting.

    Returns:
      (pval ``[...]``, NaN where degenerate; needs_gev ``[...]`` bool, always
      False when ``approx``).
    """
    if resampling not in ("bootstrap", "permutation"):
        raise ValueError("resampling must be 'bootstrap' or 'permutation'")

    stat = coef[..., 0]
    null = coef[..., 1:]
    if resampling == "bootstrap":
        null = null - stat[..., None]

    finite = torch.isfinite(null)
    n_finite = finite.sum(-1)

    # degenerate: every value (observed included) equals the PLAIN mean; a
    # NaN poisons the mean, so a row with NaNs is never degenerate
    mean_all = coef.mean(-1)
    degenerate = (coef == mean_all[..., None]).all(-1)
    nan = torch.full_like(stat, float("nan"))

    if approx:
        null_f = torch.where(finite, null, torch.full_like(null, float("nan")))
        mu = torch.nanmean(null_f, dim=-1)
        sd = torch.sqrt(torch.nanmean((null_f - mu[..., None]) ** 2, dim=-1))
        abs_stat = torch.abs(stat)
        # the reference floors sd at 1e-300, which is 0 in float32
        sd = torch.clamp_min(sd, 0.0)
        p = torch.special.ndtr((mu - abs_stat) / sd) \
            + torch.special.ndtr((-abs_stat - mu) / sd)
        return torch.where(degenerate, nan, p), torch.zeros_like(degenerate)

    abs_stat = torch.abs(stat)[..., None]
    extreme = ((null > abs_stat) | (null < -abs_stat)) & finite
    ec = extreme.sum(-1)
    p = (ec + 1.0) / (n_finite + 1.0)
    p = torch.where(degenerate, nan, p.to(stat.dtype))
    needs = (ec <= GEV_COUNT_THRESHOLD) & ~degenerate & (n_finite > 0)
    return p, needs


def gev_refine(stat: float, null: np.ndarray, fallback: float) -> float:
    """Serial GEV tail refinement for one test (scipy): fit
    ``genextreme`` to shrinking sorted tails (300 -> 60 by 30), accept a fit
    whose KS p-value exceeds 0.05, and sum the scaled tail CDF/SF; return
    ``fallback`` when fitting fails."""
    import scipy.stats as sstats

    null = null[np.isfinite(null)]
    if null.size == 0:
        return fallback
    perm_dist = np.sort(null)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            left_asl = None
            n_exec = 300
            while n_exec > 50:
                tail = perm_dist[:n_exec]
                params = sstats.genextreme.fit(tail)
                _, ks_p = sstats.kstest(tail, "genextreme", args=params)
                if ks_p > 0.05:
                    val = sstats.genextreme.cdf(-abs(stat), *params)
                    left_asl = (n_exec / perm_dist.shape[0]) * val
                    break
                n_exec -= 30
            if left_asl is None:
                return fallback
            n_exec = 300
            while n_exec > 50:
                tail = perm_dist[-n_exec:]
                params = sstats.genextreme.fit(tail)
                _, ks_p = sstats.kstest(tail, "genextreme", args=params)
                if ks_p > 0.05:
                    val = sstats.genextreme.sf(abs(stat), *params)
                    return (n_exec / perm_dist.shape[0]) * val + left_asl
                n_exec -= 30
            return fallback
        except Exception:  # scipy's fit raises assorted errors on bad tails
            return fallback


__all__ = ["asl_counting", "gev_refine", "GEV_COUNT_THRESHOLD"]
