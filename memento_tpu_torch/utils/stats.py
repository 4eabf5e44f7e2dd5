"""Statistical utilities of the analyses: FDR correction, genomic control,
concordance and robust helpers.

Counterpart of ``memento_tpu/utils/stats.py``, equal to it function for
function: Benjamini-Hochberg is computed directly (no statsmodels), the
robust helpers use scipy, and the plotting helpers import matplotlib only
when called.
"""

from __future__ import annotations

import numpy as np
import scipy.stats as stats


def fdrcorrection(pvals, alpha: float = 0.05):
    """Benjamini-Hochberg step-up FDR correction.

    Returns:
      (rejected, qvals) matching ``statsmodels.stats.multitest.fdrcorrection``.
    """
    pvals = np.asarray(pvals, dtype=np.float64)
    n = pvals.size
    order = np.argsort(pvals)
    ranked = pvals[order] * n / (np.arange(n) + 1)
    qvals_sorted = np.minimum.accumulate(ranked[::-1])[::-1]
    qvals = np.empty(n)
    qvals[order] = np.minimum(qvals_sorted, 1.0)
    return qvals <= alpha, qvals


def fdrcorrect(pvals):
    """BH FDR with NaN passthrough: NaN p-values get FDR 1 and are excluded
    from the correction."""
    pvals = np.asarray(pvals, dtype=np.float64)
    fdr = np.ones(pvals.shape[0])
    valid = ~np.isnan(pvals)
    if valid.any():
        _, fdr[valid] = fdrcorrection(pvals[valid])
    return fdr


def robust_correlation(a, b):
    """Spearman correlation over mutually finite entries."""
    cond = np.isfinite(a) & np.isfinite(b)
    return stats.spearmanr(a[cond], b[cond])


def robust_linregress(a, b):
    """Linear regression over mutually finite entries."""
    cond = np.isfinite(a) & np.isfinite(b)
    return stats.linregress(a[cond], b[cond])


def robust_hist(x, **kwargs):
    """Histogram of finite entries."""
    import matplotlib.pyplot as plt

    cond = np.isfinite(x)
    plt.hist(np.asarray(x)[cond], **kwargs)


def density_scatterplot(a, b, s=1, cmap="Reds", kde=None):
    """KDE-colored scatterplot."""
    import matplotlib.pyplot as plt

    condition = np.isfinite(a) & np.isfinite(b)
    x, y = np.asarray(a)[condition], np.asarray(b)[condition]
    xy = np.vstack([x, y])
    z = stats.gaussian_kde(xy, bw_method=kde)(xy)
    plt.scatter(x, y, c=z, s=s, cmap=cmap)


def lambda_gc(pvals):
    """Genomic-control inflation factor of a p-value set: the ratio of the
    median chi^2(1) statistic to its theoretical median (the calibration
    check of a null p-value set)."""
    pvals = np.asarray(pvals, dtype=np.float64)
    pvals = pvals[np.isfinite(pvals)]
    chi2 = stats.chi2.isf(np.clip(pvals, 1e-300, 1.0), df=1)
    return np.median(chi2) / stats.chi2.isf(0.5, df=1)


def concordance(x, y):
    """Lin's concordance correlation coefficient over finite entries (the
    estimator-accuracy metric of the validations)."""
    cond = np.isfinite(x) & np.isfinite(y)
    x, y = np.asarray(x)[cond], np.asarray(y)[cond]
    if x.size < 2:
        return np.nan
    mx, my = x.mean(), y.mean()
    vx, vy = x.var(), y.var()
    cxy = ((x - mx) * (y - my)).mean()
    return 2 * cxy / (vx + vy + (mx - my) ** 2)


__all__ = [
    "fdrcorrection",
    "fdrcorrect",
    "robust_correlation",
    "robust_linregress",
    "robust_hist",
    "density_scatterplot",
    "lambda_gc",
    "concordance",
]
