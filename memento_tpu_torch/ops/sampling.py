"""Bootstrap resampling of unique-value multiplicities: the plain version.

Counterpart of ``memento_tpu/ops/sampling.py`` (its ``'cascade'`` sampler).
Each row's B multinomial resamples of its bin multiplicities are drawn as a
chain of conditional binomials over the bins and contracted on the fly into
weighted sums::

    sums[..., w, b] = sum_u weights[..., u, w] * n[..., u, b]

so the ``[..., U, B]`` count tensor never exists.  Each conditional binomial
is drawn without rejection loops: a rounded Gaussian with a Cornish-Fisher
skew term for bins whose expected count is at least ``CASCADE_TAU``, a
truncated-Poisson inverse CDF with a conditional-mean shift and variance
rescale below it, and the absorbing last bin takes every remaining trial, so
every replicate conserves its total exactly.

This is the plain PyTorch version of the CUDA kernel in
``csrc/cascade_bootstrap.cu``: the CPU path, and what the kernel is held
against on the card.  Padded bins (count 0) draw 0.
"""

from __future__ import annotations

import torch

from ..device import generator

CASCADE_TAU = 8.0
CASCADE_K = 32  # table support: P[Poisson(8) > 32] < 4e-12


def poisson_cdf_table(lam, k_max: int = CASCADE_K):
    """CDF of Poisson(lam) on {0..k_max-1}: ``[..., k_max]``."""
    lam = torch.as_tensor(lam, dtype=torch.float32)
    p = torch.exp(-lam)
    pmf = [p]
    for k in range(k_max - 1):
        p = p * lam / (k + 1.0)
        pmf.append(p)
    return torch.cumsum(torch.stack(pmf, dim=-1), dim=-1)


def conditional_ratios(counts):
    """Tail sums and conditional split ratios ``c_u / sum_{v>=u} c_v``.

    The ratio is exactly 1 where a bin absorbs the whole tail (the
    conditioning that keeps each replicate's total at N) and 0 on padding.
    """
    ctail = torch.flip(torch.cumsum(torch.flip(counts, [-1]), -1), [-1])
    ratio = torch.where(ctail > 0, counts / torch.clamp_min(ctail, 1.0),
                        torch.zeros_like(counts))
    ratio = torch.clamp(ratio, 0.0, 1.0)
    ratio = torch.where((ctail > 0) & (counts >= ctail),
                        torch.ones_like(ratio), ratio)
    return ctail, ratio


def _approx_binomial_step(gen, remaining, expected_remaining, ratio, lam0,
                          cdf, tau=CASCADE_TAU):
    """One conditional-binomial draw of the cascade for every replicate.

    Args:
      remaining: ``[..., B]`` trials left.
      expected_remaining: ``[...]`` tail count sum (E[remaining] here).
      ratio: ``[...]`` conditional success probability of this bin.
      lam0: ``[...]`` the bin's observed multiplicity; picks the branch.
      cdf: ``[..., K]`` truncated-Poisson CDF at rate lam0.

    Returns:
      draws ``[..., B]`` (fractional in the table branch: the use is a
      linear moment contraction, not a count).
    """
    r = ratio[..., None]
    # Gaussian branch: exact conditional mean/variance, Cornish-Fisher skew
    # gamma*(z^2-1)/6, base sigma shrunk by the CF term's own variance and
    # the rounding variance (1/12), rounded and clamped.
    m = remaining * r
    gam = 1.0 - 2.0 * r
    s = torch.sqrt(torch.clamp_min(
        m * (1.0 - r) - gam * gam / 18.0 - 1.0 / 12.0, 0.0))
    z = torch.randn(remaining.shape, generator=gen, device=remaining.device)
    g = torch.clamp(torch.round(m + s * z + gam * (z * z - 1.0) / 6.0),
                    min=torch.zeros_like(remaining), max=remaining)
    # Poisson-table branch: invert the CDF with one uniform (the count of
    # table entries below it), rescale the centred draw to the conditional
    # binomial's variance and add the conditional-mean shift.
    u01 = torch.rand(remaining.shape, generator=gen, device=remaining.device)
    t = torch.searchsorted(cdf.contiguous(), u01.contiguous()).to(
        remaining.dtype)
    lam = lam0[..., None]
    p_cond = lam / torch.clamp_min(expected_remaining[..., None], 1.0)
    t = lam + (t - lam) * torch.sqrt(torch.clamp_min(1.0 - p_cond, 0.0))
    t = t + r * (remaining - expected_remaining[..., None])
    t = torch.clamp(t, min=torch.zeros_like(remaining), max=remaining)
    draws = torch.where((lam0 < tau)[..., None], t, g)
    draws = torch.where(r >= 1.0 - 1e-6, remaining, draws)
    return torch.where(r <= 0.0, torch.zeros_like(draws), draws)


def fused_bootstrap_sums(counts, weights, n_obs, num_boot: int, seed: int):
    """Bootstrap-resample and contract, bin by bin.

    Args:
      counts: ``[..., U]`` observed multiplicities (pads are 0).
      weights: ``[..., U, W]`` contraction weights.
      n_obs: total trials per row, broadcastable to ``counts.shape[:-1]``.
      num_boot: replicates B.
      seed: derived 64-bit seed (``device.fold_seed``).

    Returns:
      sums ``[..., W, B]`` float32 on ``counts.device``.
    """
    counts = torch.as_tensor(counts, dtype=torch.float32)
    dev = counts.device
    weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    batch = counts.shape[:-1]
    n_rows = torch.broadcast_to(
        torch.as_tensor(n_obs, dtype=torch.float32, device=dev), batch)

    ctail, ratio = conditional_ratios(counts)
    cdf = poisson_cdf_table(counts)  # [..., U, K]
    gen = generator(seed, dev)

    remaining = n_rows[..., None].expand(*batch, num_boot).clone()
    sums = torch.zeros(*batch, weights.shape[-1], num_boot,
                       dtype=torch.float32, device=dev)
    # bins past the last occupied one draw exactly 0 in every row
    occupied = (counts > 0).reshape(-1, counts.shape[-1]).any(0)
    n_bins = int(occupied.nonzero().max()) + 1 if bool(occupied.any()) else 0
    for u in range(n_bins):
        n_u = _approx_binomial_step(gen, remaining, ctail[..., u],
                                    ratio[..., u], counts[..., u],
                                    cdf[..., u, :])
        sums += weights[..., u, :, None] * n_u[..., None, :]
        remaining = remaining - n_u
    return sums


__all__ = [
    "CASCADE_TAU",
    "CASCADE_K",
    "poisson_cdf_table",
    "conditional_ratios",
    "fused_bootstrap_sums",
]
