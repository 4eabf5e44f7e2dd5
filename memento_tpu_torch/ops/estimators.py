"""Method-of-moments estimators under capture-noise models (host path).

Counterpart of ``memento_tpu/ops/estimators.py``.  Every estimator works
through three sufficient statistics per gene::

    s1   = sum_c x_c / sf_c
    s2   = sum_c x_c^2 / sf_c^2
    s1sq = sum_c x_c / sf_c^2

    M1  = s1 / N
    M2  = s2 / N - c * s1sq / N      (c = 1-q hypergeometric, 1 Poisson)
    var = M2 - M1^2

Observed moments are computed once per group on the host in float64 with
scipy; the bootstrap replicates contract the same per-bin weights on the
device (``ops/bootstrap.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Union

import numpy as np
import scipy.sparse as sparse


@dataclass(frozen=True)
class NoiseModel:
    """A capture-noise generative model.

    Attributes:
      name: registry key.
      relative: whether expression is scaled by per-cell size factors.
      poisson: if True the variance correction ``c`` is 1, else ``1-q``.
      mean_only: if True variance is replaced by the sentinel 10 and the mean
        is shifted by +1.
    """

    name: str
    relative: bool = True
    poisson: bool = False
    mean_only: bool = False

    def var_correction(self, q):
        """The coefficient ``c`` of the ``sum x/sf^2`` term in M2 (works on
        floats, numpy arrays and torch tensors alike)."""
        if self.poisson:
            return q * 0 + 1.0
        return 1.0 - q


HYPER_RELATIVE = NoiseModel("hyper_relative")
HYPER_ABSOLUTE = NoiseModel("hyper_absolute", relative=False)
POI_RELATIVE = NoiseModel("poi_relative", poisson=True)
POI_ABSOLUTE = NoiseModel("poi_absolute", relative=False, poisson=True)
MEAN_ONLY = NoiseModel("mean_only", mean_only=True)

_REGISTRY = {
    m.name: m
    for m in [HYPER_RELATIVE, HYPER_ABSOLUTE, POI_RELATIVE, POI_ABSOLUTE, MEAN_ONLY]
}

# a registry name, a NoiseModel, or a custom (fn_1d, fn_cov) tuple
EstimatorType = Union[str, NoiseModel, Tuple[Callable, Callable]]


def get_noise_model(estimator_type: EstimatorType) -> Optional[NoiseModel]:
    """Resolve the noise model; returns None for custom callable tuples."""
    if isinstance(estimator_type, NoiseModel):
        return estimator_type
    if isinstance(estimator_type, str):
        if estimator_type not in _REGISTRY:
            raise ValueError(
                f"unknown estimator_type {estimator_type!r}; "
                f"available: {sorted(_REGISTRY)}"
            )
        return _REGISTRY[estimator_type]
    return None


def is_absolute(estimator_type: EstimatorType) -> bool:
    m = get_noise_model(estimator_type)
    return m is not None and not m.relative


def mean_var_from_suffstats(s1, s2, s1sq, n_obs, q, model: NoiseModel):
    """Mean and variance from the three weighted sums (or ``(M1+1, 10)`` for
    ``mean_only``)."""
    m1 = s1 / n_obs
    if model.mean_only:
        return m1 + 1.0, m1 * 0 + 10.0
    c = model.var_correction(q)
    m2 = s2 / n_obs - c * s1sq / n_obs
    return m1, m2 - m1 * m1


def suffstats_sparse(X, size_factor):
    """Exact float64 sufficient statistics ``(s1, s2, s1sq)`` per gene."""
    X = X.tocsc() if sparse.issparse(X) else sparse.csc_matrix(X)
    inv_sf = (1.0 / np.asarray(size_factor)).reshape(1, -1)
    inv_sf_sq = inv_sf**2
    s1 = np.asarray(inv_sf @ X).ravel()
    s2 = np.asarray(inv_sf_sq @ X.power(2)).ravel()
    s1sq = np.asarray(inv_sf_sq @ X).ravel()
    return s1, s2, s1sq


def mean_var_sparse(X, size_factor, q,
                    estimator_type: EstimatorType = "hyper_relative"):
    """Observed per-gene mean/variance from sparse data (host, float64)."""
    model = get_noise_model(estimator_type)
    n_obs = X.shape[0]
    if model is not None and not model.relative:
        size_factor = np.ones(n_obs)
    s1, s2, s1sq = suffstats_sparse(X, size_factor)
    m, v = mean_var_from_suffstats(s1, s2, s1sq, n_obs, q, model)
    return np.asarray(m), np.asarray(v)


__all__ = [
    "NoiseModel",
    "HYPER_RELATIVE",
    "HYPER_ABSOLUTE",
    "POI_RELATIVE",
    "POI_ABSOLUTE",
    "MEAN_ONLY",
    "get_noise_model",
    "is_absolute",
    "mean_var_from_suffstats",
    "suffstats_sparse",
    "mean_var_sparse",
]
