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
``fused_bootstrap_sums`` takes its random numbers from a ``torch.Generator``;
``fused_bootstrap_sums_philox`` is the same cascade on the kernel's own
Philox stream (``ops/philox.py``), for comparing the two draw by draw.

The JAX package's other samplers run on PyTorch's own random operations, as
they run on ``jax.random`` outside any kernel there:

- ``'multinomial'``: the exact chain of conditional binomials
  (``torch.binomial``), fused with the contraction
  (``fused_bootstrap_sums(..., sampler="multinomial")``) or materialized
  (``bootstrap_counts``); every replicate conserves its total exactly;
- ``'poisson'``: independent Poisson counts with the observed means;
- ``'gaussian'``: the multinomial's marginal mean and variance, clamped at 0.

The last two are materialized only (``bootstrap_counts``).
"""

from __future__ import annotations

import torch

from ..device import generator
from ..utils import profiling
from . import philox

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


def _approx_binomial_step(z, u01, remaining, expected_remaining, ratio,
                          lam0, cdf, tau=CASCADE_TAU):
    """One conditional-binomial draw of the cascade for every replicate.

    Args:
      z, u01: ``[..., B]`` standard normals (Gaussian branch) and uniforms
        (table branch).
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
    g = torch.clamp(torch.round(m + s * z + gam * (z * z - 1.0) / 6.0),
                    min=torch.zeros_like(remaining), max=remaining)
    # Poisson-table branch: invert the CDF with one uniform (the count of
    # table entries below it), rescale the centred draw to the conditional
    # binomial's variance and add the conditional-mean shift.
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


def _cascade_sums(counts, weights, n_obs, num_boot: int, randoms):
    """The cascade over the bins; ``randoms(u, lam0)`` gives bin ``u``'s
    normals and uniforms ``[..., B]`` (``lam0``: the bin's counts)."""
    counts = torch.as_tensor(counts, dtype=torch.float32)
    dev = counts.device
    weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    batch = counts.shape[:-1]
    n_rows = torch.broadcast_to(
        torch.as_tensor(n_obs, dtype=torch.float32, device=dev), batch)

    ctail, ratio = conditional_ratios(counts)
    cdf = poisson_cdf_table(counts)  # [..., U, K]

    remaining = n_rows[..., None].expand(*batch, num_boot).clone()
    sums = torch.zeros(*batch, weights.shape[-1], num_boot,
                       dtype=torch.float32, device=dev)
    # bins past the last occupied one draw exactly 0 in every row
    for u in range(_occupied_bins(counts)):
        z, u01 = randoms(u, counts[..., u])
        n_u = _approx_binomial_step(z, u01, remaining, ctail[..., u],
                                    ratio[..., u], counts[..., u],
                                    cdf[..., u, :])
        sums += weights[..., u, :, None] * n_u[..., None, :]
        remaining = remaining - n_u
    return sums


def _occupied_bins(counts) -> int:
    """One past the last bin occupied in any row (later bins draw 0): the
    steps of the chain, added to the open span's ``steps``.  Reading it
    waits for the device (a ``profiling.wait`` span)."""
    occupied = (counts > 0).reshape(-1, counts.shape[-1]).any(0)
    with profiling.wait():
        n = int(occupied.nonzero().max()) + 1 if bool(occupied.any()) else 0
    profiling.tally("steps", n)
    return n


def _binomial_chain(counts, n_obs, num_boot: int, gen):
    """The exact multinomial resample as a chain of conditional binomials:
    yields ``(u, n_u)`` with bin ``u``'s draws ``[..., B]`` for every bin up
    to the last occupied one.  ``p`` is the bin's share of the tail
    (``conditional_ratios``), clipped to ``[1e-7, 1 - 1e-7]`` for the draw;
    a bin with ``p >= 1 - 1e-6`` takes every remaining trial, and ``p <= 0``
    or no trial left draws 0, as in the JAX package."""
    batch = counts.shape[:-1]
    n_rows = torch.broadcast_to(
        torch.as_tensor(n_obs, dtype=torch.float32, device=counts.device),
        batch)
    _, ratio = conditional_ratios(counts)
    p_draw = torch.clamp(ratio, 1e-7, 1.0 - 1e-7)
    absorb = ratio >= 1.0 - 1e-6
    empty = ratio <= 0.0
    remaining = n_rows[..., None].expand(*batch, num_boot).clone()
    for u in range(_occupied_bins(counts)):
        draw = torch.binomial(remaining,
                              p_draw[..., u, None].expand_as(remaining),
                              generator=gen)
        n_u = torch.where(absorb[..., u, None], remaining, draw)
        n_u = torch.where(empty[..., u, None] | (remaining <= 0), 0.0, n_u)
        yield u, n_u
        remaining = remaining - n_u


def bootstrap_counts(counts, n_obs, num_boot: int, sampler: str, gen):
    """Materialized bootstrap multiplicities of padded unique-value tiles.

    Args:
      counts: ``[..., U]`` observed multiplicities (pads are 0).
      n_obs: total trials per row, broadcastable to ``counts.shape[:-1]``.
      num_boot: replicates B.
      sampler: ``'multinomial'``, ``'poisson'`` or ``'gaussian'``.
      gen: ``torch.Generator`` on ``counts.device``.

    Returns:
      ``[..., U, B]`` float32 draws; padded bins draw 0 under every sampler.
    """
    counts = torch.as_tensor(counts, dtype=torch.float32)
    shape = (*counts.shape, num_boot)
    if sampler == "multinomial":
        draws = torch.zeros(shape, dtype=torch.float32, device=counts.device)
        for u, n_u in _binomial_chain(counts, n_obs, num_boot, gen):
            draws[..., u, :] = n_u
        return draws
    mean = counts[..., None].expand(shape)
    if sampler == "poisson":
        return torch.poisson(mean, generator=gen)
    if sampler == "gaussian":
        # the multinomial's marginal moments: mean N p, variance N p (1 - p)
        n_rows = torch.as_tensor(n_obs, dtype=torch.float32,
                                 device=counts.device)
        p = counts / torch.broadcast_to(n_rows, counts.shape[:-1])[..., None]
        sd = torch.sqrt(torch.clamp_min(counts * (1.0 - p), 0.0))
        eps = torch.randn(shape, generator=gen, device=counts.device)
        return torch.clamp_min(mean + eps * sd[..., None], 0.0)
    raise ValueError(f"unknown sampler {sampler!r}; options: "
                     "('multinomial', 'poisson', 'gaussian')")


def _multinomial_sums(counts, weights, n_obs, num_boot: int, gen):
    """The exact fused sums: the binomial chain contracted bin by bin."""
    weights = torch.as_tensor(weights, dtype=torch.float32,
                              device=counts.device)
    sums = torch.zeros(*counts.shape[:-1], weights.shape[-1], num_boot,
                       dtype=torch.float32, device=counts.device)
    for u, n_u in _binomial_chain(counts, n_obs, num_boot, gen):
        sums.addcmul_(weights[..., u, :, None], n_u[..., None, :])
    return sums


def fused_bootstrap_sums(counts, weights, n_obs, num_boot: int, seed: int,
                         sampler: str = "cascade"):
    """Bootstrap-resample and contract, bin by bin.

    Args:
      counts: ``[..., U]`` observed multiplicities (pads are 0).
      weights: ``[..., U, W]`` contraction weights.
      n_obs: total trials per row, broadcastable to ``counts.shape[:-1]``.
      num_boot: replicates B.
      seed: derived 64-bit seed (``device.fold_seed``).
      sampler: ``'cascade'`` (the approximate conditional binomials, the
        kernel's plain version) or ``'multinomial'`` (exact binomials).

    Returns:
      sums ``[..., W, B]`` float32 on ``counts.device``.
    """
    counts = torch.as_tensor(counts, dtype=torch.float32)
    gen = generator(seed, counts.device)
    if sampler == "multinomial":
        return _multinomial_sums(counts, weights, n_obs, num_boot, gen)
    if sampler != "cascade":
        raise ValueError(f"fused sampler must be 'cascade' or 'multinomial', "
                         f"got {sampler!r}")
    shape = (*counts.shape[:-1], num_boot)

    def randoms(u, lam0):
        return (torch.randn(shape, generator=gen, device=counts.device),
                torch.rand(shape, generator=gen, device=counts.device))

    return _cascade_sums(counts, weights, n_obs, num_boot, randoms)


def fused_bootstrap_sums_philox(counts, weights, n_obs, num_boot: int,
                                seed: int):
    """``fused_bootstrap_sums`` for ``counts [T, U]`` with the random numbers
    of ``csrc/cascade_bootstrap.cu``: draw (row, bin, replicate) takes the
    Philox words that ``ops/philox.py`` allocates to it, keyed by ``seed``.
    The first B replicates are the same whatever ``num_boot`` is."""
    counts = torch.as_tensor(counts, dtype=torch.float32)
    if counts.dim() != 2:
        raise ValueError(f"expected counts [T, U]; got {tuple(counts.shape)}")
    dev = counts.device
    rows = torch.arange(counts.shape[0], device=dev)[:, None]
    reps = torch.arange(num_boot, device=dev)[None, :]
    group = {}

    def randoms(u, lam0):
        g, j = divmod(u, philox.GROUP)
        if group.get("index") != g:
            group.update(index=g, normals=None, uniforms=None)
        # a call is made only where some row of the group's bin needs it
        if bool((lam0 >= CASCADE_TAU).any()):
            if group["normals"] is None:
                group["normals"] = philox.group_normals(rows, g, reps, seed)
            z = group["normals"][..., j]
        else:
            z = torch.zeros(counts.shape[0], num_boot, device=dev)
        if bool(((lam0 > 0) & (lam0 < CASCADE_TAU)).any()):
            if group["uniforms"] is None:
                group["uniforms"] = philox.group_uniforms(rows, g, reps, seed)
            u01 = group["uniforms"][..., j]
        else:
            u01 = torch.full((counts.shape[0], num_boot), 0.5, device=dev)
        return z, u01

    return _cascade_sums(counts, weights, n_obs, num_boot, randoms)


__all__ = [
    "CASCADE_TAU",
    "CASCADE_K",
    "poisson_cdf_table",
    "conditional_ratios",
    "bootstrap_counts",
    "fused_bootstrap_sums",
    "fused_bootstrap_sums_philox",
]
