"""Size-factor estimation and binning (host, float64).

Counterpart of ``memento_tpu/ops/size_factor.py``:

- ``estimate_size_factor``: total-count or masked+shrunk size factors;
- ``bin_size_factor``: quantize size factors into ``num_bins`` equal-width
  bins, replacing each cell's factor by its bin mean (the maximal cells keep
  their exact value) — what makes the unique-value compression effective;
- ``factorize_approx_sf``: quantized factors -> dense bin ids.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sparse

from .estimators import EstimatorType, is_absolute


def estimate_size_factor(
    X,
    estimator_type: EstimatorType = "hyper_relative",
    shrinkage: float = 0.5,
    mask=None,
    total: bool = False,
):
    """Per-cell size factors ``[N]``.

    Absolute models return all-ones.  With ``mask`` (least-variable genes)
    the masked totals are shrunk by their ``shrinkage`` quantile and
    normalized by their mean; with ``total=True`` the plain row totals are
    returned.
    """
    n_obs = X.shape[0]
    if is_absolute(estimator_type):
        return np.ones(n_obs)
    if not total and mask is None:
        raise ValueError("one of total=True or mask=... is required")

    if sparse.issparse(X):
        row_tot = np.asarray(X.sum(axis=1)).reshape(-1)
    else:
        row_tot = np.asarray(X).sum(axis=1)

    if mask is not None:
        mask = np.asarray(mask)
        if sparse.issparse(X):
            nrc = np.asarray(
                X.multiply(mask.reshape(1, -1)).sum(axis=1)).reshape(-1)
        else:
            nrc = (np.asarray(X) * mask.reshape(1, -1)).sum(axis=1)
        nrc = nrc + np.quantile(nrc, shrinkage)  # additive shrinkage
        return nrc / nrc.mean()

    return row_tot.astype(np.float64)


def bin_size_factor(size_factor, num_bins: int = 30):
    """Quantize size factors to equal-width bin means ``[N]``."""
    size_factor = np.asarray(size_factor, dtype=np.float64)
    lo, hi = size_factor.min(), size_factor.max()
    if hi == lo:
        return size_factor.copy()
    edges = np.linspace(lo, hi, num_bins + 1)
    idx = np.clip(np.searchsorted(edges, size_factor, side="right") - 1,
                  0, num_bins - 1)
    sums = np.bincount(idx, weights=size_factor, minlength=num_bins)
    cnts = np.bincount(idx, minlength=num_bins)
    with np.errstate(invalid="ignore"):
        means = sums / cnts  # empty bins are NaN but never gathered
    approx = means[idx]
    approx[size_factor == hi] = hi
    return approx


def factorize_approx_sf(approx_sf):
    """``(bin_values, bin_ids)`` with ``bin_values[bin_ids] == approx_sf``;
    ``bin_values`` ascending."""
    bin_values, bin_ids = np.unique(np.asarray(approx_sf), return_inverse=True)
    return bin_values, bin_ids.astype(np.int32)


__all__ = ["estimate_size_factor", "bin_size_factor", "factorize_approx_sf"]
