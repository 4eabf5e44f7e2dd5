"""Bootstrap replicate moments from compressed tiles (1D and 2D).

Counterpart of ``memento_tpu/ops/bootstrap.py::bootstrap_1d`` and
``bootstrap_2d`` (their cascade branch).  With unique values ``x_u``, size
factors ``sf_u`` and resampled multiplicities ``n_ub``::

    M1_b  = sum_u (x_u / sf_u)                 * n_ub / N
    M2_b  = sum_u (x_u^2 - c x_u) / sf_u^2     * n_ub / N
    Mxy_b = sum_u (x_u y_u) / sf_u^2           * n_ub / N     (gene pairs)

so each replicate's moments are weighted sums of one resample: two per gene
(W = 2; one for ``mean_only``), five per gene pair (W = 5: both means, the
cross moment and both second moments from a single joint resample).  The
fused cascade computes them without materializing ``n_ub``.
"""

from __future__ import annotations

import torch

from .cuda_kernels import fused_bootstrap_sums_cuda
from .estimators import NoiseModel
from .sampling import fused_bootstrap_sums

SAMPLERS = ("cascade", "cascade_cuda")


def _row_params(counts, n_obs, q):
    """``n_obs`` and ``q`` broadcast to the batch shape of ``counts``."""
    batch = counts.shape[:-1]
    return tuple(
        torch.broadcast_to(
            torch.as_tensor(x, dtype=torch.float32, device=counts.device),
            batch)
        for x in (n_obs, q))


def _moment_sums(counts, weights, n_rows, num_boot: int, seed: int,
                 sampler: str):
    """Per-cell weighted sums of the resample, ``[..., W, B]``: the batch
    flattens to rows (each with its own trial count) for the fused cascade,
    the kernel or its plain version."""
    if sampler not in SAMPLERS:
        raise NotImplementedError(
            f"sampler {sampler!r} is not ported yet (1D and 2D alike); "
            f"options: {SAMPLERS}")
    batch = counts.shape[:-1]
    u_dim = counts.shape[-1]
    w_dim = weights.shape[-1]
    fused = fused_bootstrap_sums_cuda if sampler == "cascade_cuda" \
        else fused_bootstrap_sums
    sums = fused(counts.reshape(-1, u_dim).contiguous(),
                 weights.reshape(-1, u_dim, w_dim).contiguous(),
                 n_rows.reshape(-1).contiguous(), num_boot, seed)
    return sums.reshape(*batch, w_dim, num_boot) / n_rows[..., None, None]


def bootstrap_1d(values, counts, inv_sf, inv_sf_sq, n_obs, q,
                 model: NoiseModel, num_boot: int, seed: int,
                 sampler: str = "cascade"):
    """Bootstrap replicate means/variances for rows of compressed tiles.

    Args:
      values, counts, inv_sf, inv_sf_sq: ``[..., U]`` float32 tiles.
      n_obs, q: cells and capture efficiency per row, broadcastable to the
        batch shape ``[...]`` (rows of different groups differ).
      sampler: ``'cascade'`` (the plain version) or ``'cascade_cuda'`` (the
        kernel for CUDA tensors; the plain version for CPU tensors).

    Returns:
      (mean, var): ``[..., B]`` float32.  Rows that collapsed to <= 1 unique
      combo are masked by the caller.
    """
    n_rows, q_rows = _row_params(counts, n_obs, q)
    a = values * inv_sf
    if model.mean_only:
        w = a[..., None]
    else:
        c = model.var_correction(q_rows)[..., None]
        w = torch.stack([a, (values * values - c * values) * inv_sf_sq], -1)
    m = _moment_sums(counts, w, n_rows, num_boot, seed, sampler)
    m1 = m[..., 0, :]
    if model.mean_only:
        return m1 + 1.0, torch.full_like(m1, 10.0)
    return m1, m[..., 1, :] - m1 * m1


def pair_weights(values_1, values_2, inv_sf, inv_sf_sq, c):
    """The five contraction weights of a gene pair, ``[..., U, 5]``: the two
    means, the cross moment and the two second moments (``c`` is the noise
    model's variance correction, broadcastable to ``[..., U]``)."""
    return torch.stack([
        values_1 * inv_sf,
        values_2 * inv_sf,
        values_1 * values_2 * inv_sf_sq,
        (values_1 * values_1 - c * values_1) * inv_sf_sq,
        (values_2 * values_2 - c * values_2) * inv_sf_sq,
    ], -1)


def bootstrap_2d(values_1, values_2, counts, inv_sf, inv_sf_sq, n_obs, q,
                 model: NoiseModel, num_boot: int, seed: int,
                 sampler: str = "cascade"):
    """Bootstrap replicate covariance and marginal variances for rows of
    joint compressed tiles: one joint resample drives all three.

    Args:
      values_1, values_2, counts, inv_sf, inv_sf_sq: ``[..., U]`` float32
        tiles (``CompressedPairGroup`` arrays).
      n_obs, q, sampler: as in ``bootstrap_1d``.

    Returns:
      (cov, var_1, var_2): ``[..., B]`` float32.
    """
    n_rows, q_rows = _row_params(counts, n_obs, q)
    c = model.var_correction(q_rows)[..., None]
    w = pair_weights(values_1, values_2, inv_sf, inv_sf_sq, c)
    m = _moment_sums(counts, w, n_rows, num_boot, seed, sampler)
    m1, m2 = m[..., 0, :], m[..., 1, :]
    return (m[..., 2, :] - m1 * m2,
            m[..., 3, :] - m1 * m1,
            m[..., 4, :] - m2 * m2)


__all__ = ["bootstrap_1d", "bootstrap_2d", "pair_weights", "SAMPLERS"]
