"""Weighted meta-regression across replicate groups.

Counterpart of ``memento_tpu/inference/regression.py``, written with leading
batch dimensions (genes) instead of ``vmap``.  The statistic matrices and the
treatment are residualized on the covariates by closed-form weighted least
squares (with intercept), then the treatment effect is the weighted cross
coefficient.  A dropped group is a zero weight, which is numerically the
same as removing its row; callers put finite dummies (0) in such rows.
"""

from __future__ import annotations

import torch

_EPS = 1e-12

# ssA below this fraction of the raw treatment's second moment is "no
# residual contrast" (an exact least-squares fit's 0/0 -> NaN): the ridge
# residual of an in-span treatment is O(1e-6) relative, so its ssA is
# O(1e-12), while a real contrast gives ssA of order the treatment variance.
DEGENERATE_RTOL = 1e-9


def wls_residualize(covariate, y, weights):
    """Residualize ``y`` on ``covariate`` plus intercept under WLS.

    Args:
      covariate: ``[R, K]`` (or ``[..., R, K]``).
      y: ``[..., R, M]`` response columns.
      weights: ``[..., R]`` nonnegative; zero rows are excluded from the fit.

    Returns:
      ``[..., R, M]`` residuals (zero-weight rows hold finite garbage).
    """
    ones = torch.ones(*covariate.shape[:-1], 1, dtype=covariate.dtype,
                      device=covariate.device)
    C = torch.cat([ones, covariate], dim=-1)  # [.., R, K+1]
    Cw = C * weights[..., :, None]
    A = C.transpose(-1, -2) @ Cw  # [..., K+1, K+1]
    # trace-scaled ridge: a covariate that already holds an intercept column
    # makes A singular; the ridge gives the projection residuals to O(1e-6)
    k1 = A.shape[-1]
    lam = 1e-6 * torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / k1 + 1e-30
    A = A + lam[..., None, None] * torch.eye(k1, dtype=A.dtype,
                                             device=A.device)
    # solve_ex raises nothing, so the call never waits for the device
    beta = torch.linalg.solve_ex(A, Cw.transpose(-1, -2) @ y)[0]
    return y - C @ beta


def cross_coef(A, B, weights, scale=None):
    """Weighted slope of each column of B on each column of A.

    Args:
      A: ``[..., R, Kt]`` treatments; B: ``[..., R, M]`` statistics;
      weights: ``[..., R]``.
      scale: optional ``[..., Kt]`` raw treatment second moment for the
        degeneracy check (default: A's own).

    Returns:
      ``[..., Kt, M]``; NaN for a treatment with no residual contrast.
    """
    w = weights[..., :, None]
    wsum = weights.sum(-1)[..., None, None]
    A_c = A - (w * A).sum(-2, keepdim=True) / wsum
    B_c = B - (w * B).sum(-2, keepdim=True) / wsum
    ssA = (w * A_c * A_c).sum(-2) / wsum[..., 0]  # [..., Kt]
    if scale is None:
        scale = (w * A * A).sum(-2) / wsum[..., 0]
    dead = ssA <= DEGENERATE_RTOL * scale
    num = (A_c * w).transpose(-1, -2) @ B_c / wsum  # [..., Kt, M]
    coef = num / (ssA[..., None] + _EPS)
    return torch.where(dead[..., None], torch.full_like(coef, float("nan")),
                       coef)


def cross_coef_resampled(A, B, weights, scale=None):
    """Hierarchical-bootstrap cross coefficient over resampled replicate sets.

    Args:
      A: ``[..., R, M, Kt]`` resampled treatments; B: ``[..., R, M]``
      resampled statistics; weights: ``[..., R, M]`` resampled weights.
      scale: optional ``[..., Kt]`` raw treatment second moment.

    Returns:
      ``[..., Kt, M]``.
    """
    w = weights[..., None]
    wsum = weights.sum(-2)  # [..., M]
    B_c = B - (weights * B).sum(-2, keepdim=True) / wsum[..., None, :]
    A_c = A - (A * w).sum(-3, keepdim=True) / wsum[..., None, :, None]
    ssA = (A_c * A_c * w).sum(-3) / wsum[..., None]  # [..., M, Kt]
    if scale is None:
        scale = (A * A * w).sum(-3) / wsum[..., None]
    else:
        scale = scale[..., None, :]
    dead = ssA <= DEGENERATE_RTOL * scale
    num = torch.einsum("...rmk,...rm->...mk", A_c * w, B_c)
    coef = num / wsum[..., None] / (ssA + _EPS)
    coef = torch.where(dead, torch.full_like(coef, float("nan")), coef)
    return coef.transpose(-1, -2)


def resampled_indices(gen, num_rep: int, num_boot: int, good=None,
                      batch=(), device=None):
    """Random hierarchical-bootstrap assignments; column 0 keeps the
    observed configuration.

    With ``good`` (``[..., R]`` bool) live rows draw uniformly from live rows
    and dead rows keep their own index (their zero weight excludes them).

    Returns:
      (rep, it): both ``[..., R, B]`` int64, column 0 = (arange(R), 0).
    """
    if good is not None:
        batch = good.shape[:-1]
        device = good.device
    shape = (*batch, num_rep, num_boot)
    arange = torch.arange(num_rep, device=device)
    if good is None:
        rep = torch.randint(0, num_rep, shape, generator=gen, device=device)
    else:
        n_good = torch.clamp_min(good.sum(-1), 1)[..., None, None]
        order = torch.argsort((~good).to(torch.int8), dim=-1, stable=True)
        u = torch.rand(shape, generator=gen, device=device)
        pick = torch.minimum((u * n_good).long(), n_good - 1)
        drawn = torch.gather(order, -1, pick.reshape(*batch, -1)).reshape(shape)
        rep = torch.where(good[..., None], drawn, arange[:, None])
    rep[..., 0] = arange
    it = torch.randint(0, num_boot, shape, generator=gen, device=device) + 1
    it[..., 0] = 0
    return rep, it


def meta_regress(covariate, treatment, stats, weights, one_sample: bool,
                 resample_rep: bool = False, gen=None, one_sample_g=None):
    """Meta-regression coefficients for every treatment column against every
    bootstrap column.

    Args:
      covariate: ``[R, K]``.
      treatment: ``[..., R, Kt]``.
      stats: ``[..., R, B+1]``; column 0 is the observed value.
      weights: ``[..., R]`` cell counts (0 = dropped group).
      one_sample: static flag: the statistic is the weighted average.
      resample_rep: hierarchical bootstrap over replicate groups (needs
        ``gen``).
      one_sample_g: optional ``[...]`` bool per-gene one-sample flag.

    Returns:
      ``[..., Kt, B+1]`` (``[..., 1, B+1]`` on the static one-sample path).
      Under ``resample_rep`` the last column of regression genes is NaN
      padding.
    """
    # float32 products in full precision, never TF32 (PyTorch's default on
    # CUDA; set so that a caller's TF32 setting cannot reach the solves)
    torch.backends.cuda.matmul.allow_tf32 = False

    def weighted_avg():
        wsum = weights.sum(-1) + _EPS
        return (weights[..., None] * stats).sum(-2) / wsum[..., None]

    if one_sample and one_sample_g is None:
        return weighted_avg()[..., None, :]

    stats_t = wls_residualize(covariate, stats, weights)
    treat_t = wls_residualize(covariate, treatment, weights)
    # degeneracy reference: the RAW treatment's weighted second moment
    wsum_w = weights.sum(-1) + _EPS
    raw_scale = (weights[..., None] * treatment * treatment).sum(-2) \
        / wsum_w[..., None]

    if resample_rep:
        num_rep = stats.shape[-2]
        num_boot = stats.shape[-1] - 1
        rep, it = resampled_indices(gen, num_rep, num_boot, good=weights > 0)
        batch = rep.shape[:-2]
        flat = rep.reshape(*batch, -1)
        stats_rs = torch.gather(stats_t.reshape(*batch, -1), -1,
                                (rep * (num_boot + 1) + it).reshape(*batch, -1)
                                ).reshape(rep.shape)
        kt = treat_t.shape[-1]
        treat_rs = torch.gather(
            treat_t, -2, flat[..., None].expand(*flat.shape, kt)
        ).reshape(*rep.shape, kt)
        w_rs = torch.gather(weights, -1, flat).reshape(rep.shape)
        coef = cross_coef_resampled(treat_rs, stats_rs, w_rs, scale=raw_scale)
        coef = torch.cat([coef, torch.full_like(coef[..., :1], float("nan"))],
                         dim=-1)
    else:
        coef = cross_coef(treat_t, stats_t, weights, scale=raw_scale)

    if one_sample_g is not None:
        avg = weighted_avg()[..., None, :].expand_as(coef)
        coef = torch.where(torch.as_tensor(one_sample_g)[..., None, None],
                           avg, coef)
    return coef


__all__ = [
    "wls_residualize",
    "cross_coef",
    "cross_coef_resampled",
    "resampled_indices",
    "meta_regress",
    "DEGENERATE_RTOL",
]
