"""Pairwise covariance and all-by-all correlation matrices.

Counterpart of ``memento_tpu/ops/corr.py``.  Two paths:

- ``cov_sparse_pairs``: exact host float64 covariances for explicit gene-pair
  lists; the pair product sums in one native pass over the CSC columns
  (``native/suffstats.cpp``), else scipy column products.
- ``corr_matrix_device``: the G x G correlation matrix as a blocked weighted
  Gram matrix on the device.  Cells stream through in dense blocks and
  accumulate ``(WX)^T (WX)`` in float32 with a compensated (Kahan) sum across
  blocks; the cancelling ``S/n - outer(m, m)`` finish runs on the host in
  float64.  The Gram product is a plain large matrix product
  (``torch.matmul``, as the JAX package leaves it to ``jnp.dot``), always in
  full float32: TF32 would keep three decimal digits of sums that are about
  to be subtracted from each other.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sparse
import torch

from .. import native
from ..device import resolve_device
from .estimators import NoiseModel
from .estimators import full_float32_matmul as _full_float32_matmul
from .transport import compact_transport_dtype


def cov_sparse_pairs(X, size_factor, q, idx1, idx2, model: NoiseModel):
    """Exact covariance for pair lists from sparse data (host, float64).

    cov_p = (1/N) sum_c x1 x2 / sf^2
            - [idx1==idx2] * c * (1/N) sum_c x1 / sf^2
            - ((1/N) sum x1/sf) ((1/N) sum x2/sf)
    """
    X = X.tocsc() if sparse.issparse(X) else sparse.csc_matrix(X)
    n = X.shape[0]
    sf = np.asarray(size_factor, dtype=np.float64)
    w = (1.0 / sf).reshape(1, -1)
    w2 = w**2
    idx1 = np.asarray(idx1)
    idx2 = np.asarray(idx2)

    s1 = np.asarray(w @ X).ravel() / n  # per-gene mean of x/sf
    s1sq = np.asarray(w2 @ X).ravel() / n  # per-gene mean of x/sf^2

    prod = pair_prods(X, (1.0 / sf) ** 2, idx1, idx2) / n

    c = float(np.asarray(model.var_correction(q)))
    prod = prod - np.where(idx1 == idx2, c * s1sq[idx1], 0.0)
    return prod - s1[idx1] * s1[idx2]


def pair_prods(X_csc, inv_sf_sq, idx1, idx2):
    """Per-pair ``sum_c x1 x2 / sf^2`` of a CSC matrix: one native pass
    (sorted-index intersection of the two columns), or ``pair_prods_scipy``
    where the native pass refuses the input."""
    prod = native.pair_prods_csc_native(X_csc, inv_sf_sq, idx1, idx2)
    return pair_prods_scipy(X_csc, inv_sf_sq, idx1, idx2) if prod is None \
        else prod


def pair_prods_scipy(X_csc, inv_sf_sq, idx1, idx2):
    """``pair_prods`` from scipy column gathers (the plain version)."""
    inv2 = sparse.diags(np.asarray(inv_sf_sq, dtype=np.float64))
    return np.asarray((X_csc[:, idx1].multiply(inv2 @ X_csc[:, idx2])
                       ).sum(axis=0)).ravel()


def _kahan_add(acc, comp, update):
    """One compensated-summation step, ``(acc, comp) += update``, as three
    explicit tensor ops (eager PyTorch does not reassociate them).  It keeps
    the across-block error O(eps) instead of O(n_blocks * eps): the float32
    Gram sums feed a cancelling subtraction downstream."""
    y = update - comp
    t = acc + y
    comp = (t - acc) - y
    return t, comp


def _gram_update(xb, inv_sf_b, inv_sf_sq_b, S, s1, sdiag, cS, cs1, csdiag,
                 cols=slice(None)):
    """Accumulate one dense cell block into the compensated Gram statistics.
    ``xb`` may arrive in a compact integer dtype; it is cast on the device.
    ``cols`` selects the output columns this accumulator holds: ``S`` is
    ``[G, |cols|]`` and the per-gene sums ``[|cols|]`` (default all)."""
    xb = xb.to(torch.float32)
    wx = xb * inv_sf_b[:, None]
    wc = wx[:, cols]
    S, cS = _kahan_add(S, cS, wx.T @ wc)
    s1, cs1 = _kahan_add(s1, cs1, wc.sum(0))
    sdiag, csdiag = _kahan_add(sdiag, csdiag,
                               (inv_sf_sq_b[:, None] * xb[:, cols]).sum(0))
    return S, s1, sdiag, cS, cs1, csdiag


def corr_matrix_device(X, size_factor, q, var, model: NoiseModel,
                       block: int = 2048, row_block: Optional[int] = None,
                       out_dtype=None, device=None):
    """All-by-all correlation matrix via blocked device matrix products.

    Args:
      X: ``[N, G]`` sparse/dense counts for one group.
      size_factor: ``[N]`` exact size factors.
      q: group capture efficiency.
      var: ``[G]`` per-gene variances (1D moments) for the denominator.
      block: cells per streamed dense block.
      row_block: when set, the Gram matrix is finished on the host in
        ``[row_block, G]`` slices (one slice of float64 temporaries instead
        of several full G x G arrays).
      out_dtype: output dtype (default float64).
      device: default ``cuda``; ``'cpu'`` runs the same tensor code there.

    Returns:
      ``[G, G]`` numpy array: invalid variances or out-of-range values ->
      NaN, values within +-1.05 clipped to [-1, 1].
    """
    dev = resolve_device(device)
    n, g = X.shape
    sf = np.asarray(size_factor, dtype=np.float64)
    S, cS = (torch.zeros((g, g), dtype=torch.float32, device=dev)
             for _ in range(2))
    s1, sdiag, cs1, csdiag = (torch.zeros(g, dtype=torch.float32, device=dev)
                              for _ in range(4))
    issp = sparse.issparse(X)
    Xc = X.tocsr() if issp else np.asarray(X)
    tdtype = compact_transport_dtype(Xc) or np.float32

    def to_dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=dev)

    with _full_float32_matmul():
        for start in range(0, n, block):
            stop = min(start + block, n)
            xb = Xc[start:stop]
            xb = xb.toarray() if issp else xb
            S, s1, sdiag, cS, cs1, csdiag = _gram_update(
                to_dev(xb, tdtype),
                to_dev(1.0 / sf[start:stop], np.float32),
                to_dev(1.0 / sf[start:stop] ** 2, np.float32),
                S, s1, sdiag, cS, cs1, csdiag)
    c = float(np.asarray(model.var_correction(q)))
    s1_h, sdiag_h = s1.cpu().numpy(), sdiag.cpu().numpy()
    if row_block is None:
        out = finish_corr_host(S.cpu().numpy(), s1_h, sdiag_h, var, n, c)
        return out.astype(out_dtype) if out_dtype is not None else out
    out = np.empty((g, g), dtype=out_dtype or np.float64)
    for r0 in range(0, g, row_block):
        r1 = min(r0 + row_block, g)
        out[r0:r1] = finish_corr_rows(S[r0:r1].cpu().numpy(), r0, s1_h,
                                      sdiag_h, var, n, c)
    return out


def finish_corr_rows(S_rows, row_start, s1, sdiag, var, n, c):
    """Finish a ``[Rb, G]`` row slice of the Gram matrix in host float64.

    ``row_start`` locates the slice, so that the diagonal noise correction
    lands on the right entries.
    """
    S_rows = np.asarray(S_rows, dtype=np.float64)
    s1 = np.asarray(s1, dtype=np.float64)
    sdiag = np.asarray(sdiag, dtype=np.float64)
    rb, g = S_rows.shape

    prod = S_rows / n
    ri = np.arange(rb)
    ci = ri + row_start
    on_diag = ci < g
    prod[ri[on_diag], ci[on_diag]] -= c * sdiag[ci[on_diag]] / n
    cov = prod - np.outer(s1[row_start:row_start + rb] / n, s1 / n)

    var = np.asarray(var, dtype=np.float64).copy()
    var[var <= 0] = np.nan
    denom = np.sqrt(np.outer(var[row_start:row_start + rb], var))
    with np.errstate(invalid="ignore", divide="ignore"):
        corr = cov / denom
    corr = np.where(np.abs(corr) <= 1.05, np.clip(corr, -1.0, 1.0), np.nan)
    corr[~np.isfinite(denom)] = np.nan
    return corr


def finish_corr_host(S, s1, sdiag, var, n, c):
    """Gram statistics -> correlation matrix, in host float64 (the
    ``S/n - outer(m, m)`` subtraction cancels catastrophically in float32 at
    large n); the full-range case of ``finish_corr_rows``."""
    return finish_corr_rows(S, 0, s1, sdiag, var, n, c)


__all__ = ["cov_sparse_pairs", "pair_prods", "pair_prods_scipy",
           "corr_matrix_device", "finish_corr_host", "finish_corr_rows"]
