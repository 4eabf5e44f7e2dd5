"""Method-of-moments estimators under capture-noise models (host path).

Counterpart of ``memento_tpu/ops/estimators.py``.  Every estimator works
through three sufficient statistics per gene::

    s1   = sum_c x_c / sf_c
    s2   = sum_c x_c^2 / sf_c^2
    s1sq = sum_c x_c / sf_c^2

    M1  = s1 / N
    M2  = s2 / N - c * s1sq / N      (c = 1-q hypergeometric, 1 Poisson)
    var = M2 - M1^2

Observed moments are computed once per group on the host in float64, in one
native pass (``native/suffstats.cpp``) or with scipy; the bootstrap
replicates contract the same per-bin weights on the device
(``ops/bootstrap.py``: fused with the resampling, or over materialized draws
with ``mean_var_compressed`` / ``cov_compressed``), where ``corr_from_cov``
turns replicate covariances into correlations.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Union

import numpy as np
import scipy.sparse as sparse
import torch

from .. import native


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


def cov_from_suffstats(sxy, s1x, s1y, s_diag, n_obs, q, same_gene,
                       model: NoiseModel):
    """Covariance of two genes from weighted cross sums::

        cov = sxy/N - [same_gene] c s_diag/N - (s1x/N)(s1y/N)

    with ``sxy = sum x y / sf^2``, ``s1x``/``s1y = sum x / sf`` and
    ``s_diag = sum x / sf^2``: the noise correction applies only to a gene
    paired with itself.  Works on floats, numpy arrays and tensors alike
    (``same_gene`` a bool or 0/1 of the same kind)."""
    c = model.var_correction(q)
    prod = sxy / n_obs - same_gene * 1.0 * (c * s_diag / n_obs)
    return prod - (s1x / n_obs) * (s1y / n_obs)


def suffstats_dense(X, inv_sf, inv_sf_sq):
    """Per-gene sufficient statistics ``(s1, s2, s1sq)`` ``[G]`` of a dense
    ``[N, G]`` cell block, as tensors on the block's device.

    ``X`` may arrive in a compact integer transport dtype; it is cast to the
    weights' dtype (float64 or float32; the cast of a count is exact).
    ``inv_sf`` / ``inv_sf_sq`` are ``[N]`` reciprocal size factors, zero on
    padding rows.  The sums are exact partials: summed over cell slabs they
    give the whole matrix's statistics.  Float32 products run in full
    precision whatever the caller's TF32 setting.
    """
    X = X.to(inv_sf.dtype)
    with full_float32_matmul():
        s1 = inv_sf @ X
        s2 = inv_sf_sq @ (X * X)
        s1sq = inv_sf_sq @ X
    return s1, s2, s1sq


@contextlib.contextmanager
def full_float32_matmul():
    """Float32 matrix products in full precision inside the block, whatever
    the caller's TF32 setting; the setting is restored on exit."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def suffstats_sparse(X, size_factor):
    """Exact float64 sufficient statistics ``(s1, s2, s1sq)`` per gene.

    A CSR or CSC matrix takes one fused native pass (OpenMP, float64
    accumulation); other input, or one the native pass refuses, takes
    ``suffstats_scipy``."""
    out = None
    if sparse.issparse(X) and X.format == "csr":
        out = native.suffstats_csr_native(X, size_factor)
    elif sparse.issparse(X) and X.format == "csc":
        out = native.suffstats_csc_native(X, size_factor)
    return suffstats_scipy(X, size_factor) if out is None else out


def suffstats_scipy(X, size_factor):
    """``suffstats_sparse`` in scipy: a CSC conversion and row-weight
    products (the plain version of the native passes)."""
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


def bootstrap_weights_1d(values, inv_sf, inv_sf_sq, q, model: NoiseModel):
    """Per-bin weights of the replicate moment contraction (tensors):
    ``a_u = x_u inv_sf_u`` for M1 and ``d_u = (x_u^2 - c x_u) inv_sf_sq_u``
    for M2, with ``q`` a number or broadcastable to the batch ``[...]``.

    Returns:
      (a, d): ``[..., U]``.
    """
    q = torch.as_tensor(q, dtype=values.dtype, device=values.device)
    c = model.var_correction(q)
    if c.dim():
        c = c[..., None]
    a = values * inv_sf
    d = (values * values - c * values) * inv_sf_sq
    return a, d


def _per_row(n_obs, like):
    """``n_obs`` (a number or ``[...]``) as a tensor that divides
    ``[..., B]``."""
    n = torch.as_tensor(n_obs, dtype=like.dtype, device=like.device)
    return n[..., None]


def mean_var_compressed(values, counts, inv_sf, inv_sf_sq, n_obs, q,
                        model: NoiseModel):
    """Replicate moments from compressed (value, count) tuples.

    Args:
      values, inv_sf, inv_sf_sq: ``[..., U]``.
      counts: ``[..., U, B]`` multiplicities per bootstrap replicate.
      n_obs, q: cells and capture efficiency, numbers or ``[...]``.

    Returns:
      (mean, var): ``[..., B]``.
    """
    n = _per_row(n_obs, counts)
    a, d = bootstrap_weights_1d(values, inv_sf, inv_sf_sq, q, model)
    m1 = torch.einsum("...u,...ub->...b", a, counts) / n
    if model.mean_only:
        return m1 + 1.0, torch.full_like(m1, 10.0)
    m2 = torch.einsum("...u,...ub->...b", d, counts) / n
    return m1, m2 - m1 * m1


def cov_compressed(v1, v2, counts, inv_sf, inv_sf_sq, n_obs):
    """Replicate covariance from jointly compressed pair tuples (no
    diagonal correction: the two genes of a tested pair are distinct).

    Args:
      v1, v2, inv_sf, inv_sf_sq: ``[..., U]``.
      counts: ``[..., U, B]``.

    Returns:
      cov ``[..., B]``.
    """
    n = _per_row(n_obs, counts)
    m1 = torch.einsum("...u,...ub->...b", v1 * inv_sf, counts) / n
    m2 = torch.einsum("...u,...ub->...b", v2 * inv_sf, counts) / n
    mx = torch.einsum("...u,...ub->...b", v1 * v2 * inv_sf_sq, counts) / n
    return mx - m1 * m2


def corr_from_cov(cov, var_1, var_2):
    """Covariance -> correlation on tensors, with the sentinel semantics of
    ``memento_tpu/ops/estimators.py::corr_from_cov``: an entry whose variance
    is not positive (or NaN) comes out as **1.0**, not NaN; a NaN covariance
    stays NaN; everything else is clipped to [-1, 1].  Downstream an observed
    |corr| == 1 drops its group, while bootstrap replicates with an invalid
    variance enter the null distribution as 1.0.
    """
    invalid = ~(var_1 > 0) | ~(var_2 > 0)  # includes NaN variances
    one = torch.ones((), dtype=cov.dtype, device=cov.device)
    corr = cov / torch.sqrt(torch.where(invalid, one, var_1)
                            * torch.where(invalid, one, var_2))
    return torch.where(invalid, one, torch.clamp(corr, -1.0, 1.0))


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
    "cov_from_suffstats",
    "suffstats_dense",
    "full_float32_matmul",
    "suffstats_sparse",
    "suffstats_scipy",
    "mean_var_sparse",
    "bootstrap_weights_1d",
    "mean_var_compressed",
    "cov_compressed",
    "corr_from_cov",
]
