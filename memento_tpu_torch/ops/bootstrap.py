"""Bootstrap replicate moments from compressed tiles.

Counterpart of ``memento_tpu/ops/bootstrap.py::bootstrap_1d``.  With unique
values ``x_u``, size factors ``sf_u`` and resampled multiplicities
``n_ub``::

    M1_b = sum_u (x_u / sf_u)                 * n_ub / N
    M2_b = sum_u (x_u^2 - c x_u) / sf_u^2     * n_ub / N

so each replicate's moments are two weighted sums of the resample, which the
fused cascade computes without materializing ``n_ub``.
"""

from __future__ import annotations

import torch

from .cuda_kernels import fused_bootstrap_sums_cuda
from .estimators import NoiseModel
from .sampling import fused_bootstrap_sums

SAMPLERS = ("cascade", "cascade_cuda")


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
    if sampler not in SAMPLERS:
        raise NotImplementedError(
            f"sampler {sampler!r} is not ported yet; options: {SAMPLERS}")
    batch = counts.shape[:-1]
    u_dim = counts.shape[-1]
    dev = counts.device
    n_rows = torch.broadcast_to(
        torch.as_tensor(n_obs, dtype=torch.float32, device=dev), batch)
    q_rows = torch.broadcast_to(
        torch.as_tensor(q, dtype=torch.float32, device=dev), batch)
    a = values * inv_sf
    if model.mean_only:
        w = a[..., None]
    else:
        c = model.var_correction(q_rows)[..., None]
        w = torch.stack([a, (values * values - c * values) * inv_sf_sq], -1)
    fused = fused_bootstrap_sums_cuda if sampler == "cascade_cuda" \
        else fused_bootstrap_sums
    sums = fused(counts.reshape(-1, u_dim).contiguous(),
                 w.reshape(-1, u_dim, w.shape[-1]).contiguous(),
                 n_rows.reshape(-1).contiguous(), num_boot, seed)
    sums = sums.reshape(*batch, w.shape[-1], num_boot)
    m1 = sums[..., 0, :] / n_rows[..., None]
    if model.mean_only:
        return m1 + 1.0, torch.full_like(m1, 10.0)
    return m1, sums[..., 1, :] / n_rows[..., None] - m1 * m1


__all__ = ["bootstrap_1d", "SAMPLERS"]
