"""Mean-variance regression and residual variance.

Counterpart of ``memento_tpu/ops/mv_regression.py``: a degree-2 polynomial
of log-variance against log-mean, fitted once on the host over valid genes;
residual variance ``rv = exp(log v - poly(log m))`` applied per bootstrap
replicate on the device.
"""

from __future__ import annotations

import numpy as np
import torch


def fit_mv_regressor(mean, var):
    """Degree-2 polyfit of log var vs log mean over valid genes; returns
    ``[c2, c1, c0]`` (``np.polyfit`` order)."""
    mean = np.asarray(mean, dtype=np.float64)
    var = np.asarray(var, dtype=np.float64)
    cond = (mean > 0) & (var > 0) & np.isfinite(mean) & np.isfinite(var)
    m, v = np.log(mean[cond]), np.log(var[cond])
    if m.size < 3:
        return np.array([0.0, 0.0, 0.0])
    return np.polyfit(m, v, 2)


def polyval2(coeffs, x):
    """``c2*x^2 + c1*x + c0``; ``coeffs [..., 3]`` broadcast over ``x [..., K]``."""
    c2, c1, c0 = coeffs[..., 0:1], coeffs[..., 1:2], coeffs[..., 2:3]
    return c2 * x * x + c1 * x + c0


def residual_variance(mean, var, coeffs):
    """``exp(log var - poly(log mean))``, NaN where mean<=0 or var<=0.

    Args:
      mean, var: ``[..., K]`` tensors.
      coeffs: ``[..., 3]`` polynomial per batch element (broadcast over K).
    """
    valid = (mean > 0) & (var > 0)
    safe_m = torch.where(valid, mean, torch.ones_like(mean))
    safe_v = torch.where(valid, var, torch.ones_like(var))
    rv = torch.exp(torch.log(safe_v) - polyval2(coeffs, torch.log(safe_m)))
    return torch.where(valid, rv, torch.full_like(rv, float("nan")))


__all__ = ["fit_mv_regressor", "polyval2", "residual_variance"]
