"""The exact multinomial, Poisson and Gaussian samplers of the port against
their laws and against the JAX package's.

``bootstrap_counts`` materializes draws ``[..., U, B]``; the exact fused sums
(``fused_bootstrap_sums(..., sampler="multinomial")``) contract the same
chain of conditional binomials without materializing it.  Draws come from
different random streams in the two packages, so they agree in law: per-bin
means within 4 standard errors, variances within 4 standard errors of the
variance estimate.  Contractions of the same draws (``mean_var_compressed``,
``cov_compressed``) agree to float32 rounding (rtol 1e-5, atol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memento_tpu.ops import bootstrap as j_boot
from memento_tpu.ops import estimators as j_est
from memento_tpu.ops import sampling as j_sampling

from memento_tpu_torch.device import generator
from memento_tpu_torch.ops import bootstrap as t_boot
from memento_tpu_torch.ops import estimators as t_est
from memento_tpu_torch.ops import sampling as t_sampling

# the suite runs under several pytest workers at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

B = 4000
N_PAD = 3  # padded bins at the end of the first rows


def _tiles(rng, t=6, u=12):
    """Counts with small and large bins, the last ``N_PAD`` bins of half of
    the rows padding; values, size factors and weights to go with them."""
    counts = rng.integers(1, 40, size=(t, u)).astype(np.float32)
    counts[:, 0] = rng.integers(200, 400, size=t)
    counts[: t // 2, -N_PAD:] = 0.0
    values = rng.integers(0, 6, size=(t, u)).astype(np.float32)
    inv_sf = (rng.random((t, u)) + 0.5).astype(np.float32)
    return counts, values, inv_sf


def _stats(draws):
    """Per-bin mean, variance and the standard errors of both over the last
    axis (replicates)."""
    d = np.asarray(draws, np.float64)
    mean = d.mean(-1)
    var = d.var(-1, ddof=1)
    m4 = ((d - mean[..., None]) ** 4).mean(-1)
    n = d.shape[-1]
    return mean, var, np.sqrt(var / n), np.sqrt(np.maximum(m4 - var**2, 0) / n)


def _port_draws(counts, sampler, seed=1, num_boot=B):
    counts_t = torch.as_tensor(counts)
    return t_sampling.bootstrap_counts(
        counts_t, counts_t.sum(-1), num_boot, sampler,
        generator(seed, "cpu")).numpy()


def _jax_draws(counts, sampler, num_boot=B):
    # the JAX sampler takes one scalar trial count: draw row by row
    return np.stack([np.asarray(j_sampling.bootstrap_counts(
        jax.random.key(i), jnp.asarray(row), float(row.sum()), num_boot,
        sampler)) for i, row in enumerate(counts)])


def test_multinomial_counts_conserve_and_follow_the_law(rng):
    counts, _, _ = _tiles(rng)
    n = counts.sum(-1)
    draws = _port_draws(counts, "multinomial")
    assert draws.shape == (*counts.shape, B)
    # every replicate sums to N exactly; padded bins draw 0
    np.testing.assert_array_equal(draws.sum(1), np.repeat(n[:, None], B, 1))
    assert (draws[: len(counts) // 2, -N_PAD:] == 0).all()
    assert (draws == np.round(draws)).all() and (draws >= 0).all()
    p = counts / n[:, None]
    mean, var, se_mean, se_var = _stats(draws)
    live = counts > 0
    assert (np.abs(mean - n[:, None] * p)[live] <= 4 * se_mean[live]).all()
    law_var = n[:, None] * p * (1 - p)
    assert (np.abs(var - law_var)[live] <= 4 * se_var[live]).all()


@pytest.mark.parametrize("sampler", ["multinomial", "poisson", "gaussian"])
def test_counts_match_jax_in_distribution(rng, sampler):
    counts, _, _ = _tiles(rng)
    got = _port_draws(counts, sampler)
    want = _jax_draws(counts, sampler)
    assert got.shape == want.shape
    g_mean, g_var, g_se, g_sev = _stats(got)
    w_mean, w_var, w_se, w_sev = _stats(want)
    live = counts > 0
    assert (np.abs(g_mean - w_mean)[live]
            <= 4 * np.hypot(g_se, w_se)[live]).all()
    assert (np.abs(g_var - w_var)[live]
            <= 4 * np.hypot(g_sev, w_sev)[live]).all()
    assert (got[~live] == 0).all() and (want[~live] == 0).all()


def test_poisson_and_gaussian_counts_follow_their_laws(rng):
    counts, _, _ = _tiles(rng)
    n = counts.sum(-1)
    live = counts > 0
    pois = _port_draws(counts, "poisson")
    mean, var, se_mean, se_var = _stats(pois)
    assert (pois == np.round(pois)).all()
    assert (np.abs(mean - counts)[live] <= 4 * se_mean[live]).all()
    assert (np.abs(var - counts)[live] <= 4 * se_var[live]).all()
    # the Gaussian is clamped at 0: its law is the normal one only where
    # the clamp is (almost) never reached, 4 sd above 0
    gauss = _port_draws(counts, "gaussian")
    assert (gauss >= 0).all()
    law_var = counts * (1 - counts / n[:, None])
    far = counts >= 4 * np.sqrt(law_var) + 1
    assert far.sum() > 10
    mean, var, se_mean, se_var = _stats(gauss)
    assert (np.abs(mean - counts)[far] <= 4 * se_mean[far]).all()
    assert (np.abs(var - law_var)[far] <= 4 * se_var[far]).all()


def test_unknown_sampler_raises(rng):
    counts, _, _ = _tiles(rng)
    with pytest.raises(ValueError, match="sampler"):
        _port_draws(counts, "binomial")
    with pytest.raises(ValueError, match="sampler"):
        t_sampling.fused_bootstrap_sums(torch.ones(2, 3), torch.ones(2, 3, 1),
                                        3.0, 8, 0, sampler="poisson")


def test_exact_fused_sums_match_materialized_draws(rng):
    """The exact fused sums against the materialized multinomial draws
    contracted with the same weights (other seeds): in law; the weight-1
    sum of every replicate equals N exactly in both."""
    counts, _, _ = _tiles(rng)
    weights = rng.normal(size=(*counts.shape, 3)).astype(np.float32)
    weights[..., 0] = 1.0
    n = counts.sum(-1)
    fused = t_sampling.fused_bootstrap_sums(
        torch.as_tensor(counts), torch.as_tensor(weights),
        torch.as_tensor(n), B, 5, sampler="multinomial").numpy()
    draws = _port_draws(counts, "multinomial", seed=6)
    contracted = np.einsum("tuw,tub->twb", weights, draws)
    assert fused.shape == contracted.shape == (len(counts), 3, B)
    np.testing.assert_array_equal(fused[:, 0], np.repeat(n[:, None], B, 1))
    np.testing.assert_array_equal(contracted[:, 0],
                                  np.repeat(n[:, None], B, 1))
    f_mean, f_var, f_se, f_sev = _stats(fused[:, 1:])
    c_mean, c_var, c_se, c_sev = _stats(contracted[:, 1:])
    assert (np.abs(f_mean - c_mean) <= 4 * np.hypot(f_se, c_se)).all()
    assert (np.abs(f_var - c_var) <= 4 * np.hypot(f_sev, c_sev)).all()
    # and against the JAX package's exact fused sums
    want = np.stack([np.asarray(j_sampling.fused_bootstrap_sums(
        jax.random.key(i), jnp.asarray(counts[i]), jnp.asarray(weights[i]),
        float(n[i]), B, sampler="multinomial")) for i in range(len(counts))])
    w_mean, w_var, w_se, w_sev = _stats(want[:, 1:])
    assert (np.abs(f_mean - w_mean) <= 4 * np.hypot(f_se, w_se)).all()
    assert (np.abs(f_var - w_var) <= 4 * np.hypot(f_sev, w_sev)).all()


def test_exact_fused_sums_per_row_trials_and_padding(rng):
    """Rows with their own N (as the tile flattens groups) and an all-zero
    padding row: each row conserves its own N; the padding row sums to 0."""
    counts, _, _ = _tiles(rng, t=4)
    counts[3] = 0.0
    n = counts.sum(-1)
    sums = t_sampling.fused_bootstrap_sums(
        torch.as_tensor(counts), torch.ones(*counts.shape, 1),
        torch.as_tensor(n), 64, 2, sampler="multinomial")
    np.testing.assert_array_equal(sums[:, 0].numpy(),
                                  np.repeat(n[:, None], 64, 1))


@pytest.mark.parametrize("model", ["hyper_relative", "poi_relative",
                                   "mean_only"])
def test_mean_var_compressed_matches_jax_on_the_same_draws(rng, model):
    counts, values, inv_sf = _tiles(rng)
    draws = _port_draws(counts, "multinomial", num_boot=64)
    n_obs, q = float(counts.sum(-1).max()), 0.1
    want = j_est.mean_var_compressed(
        jnp.asarray(values), jnp.asarray(draws), jnp.asarray(inv_sf),
        jnp.asarray(inv_sf**2), n_obs, q, j_est.get_noise_model(model))
    got = t_est.mean_var_compressed(
        torch.as_tensor(values), torch.as_tensor(draws),
        torch.as_tensor(inv_sf), torch.as_tensor(inv_sf**2), n_obs, q,
        t_est.get_noise_model(model))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    # observed moments: the estimator on the original multiplicities
    want = j_boot.observed_moments_compressed(
        jnp.asarray(values), jnp.asarray(counts), jnp.asarray(inv_sf),
        jnp.asarray(inv_sf**2), n_obs, q, j_est.get_noise_model(model))
    got = t_boot.observed_moments_compressed(
        torch.as_tensor(values), torch.as_tensor(counts),
        torch.as_tensor(inv_sf), torch.as_tensor(inv_sf**2), n_obs, q,
        t_est.get_noise_model(model))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_cov_compressed_matches_jax_on_the_same_draws(rng):
    counts, values, inv_sf = _tiles(rng)
    values_2 = rng.integers(0, 6, size=values.shape).astype(np.float32)
    draws = _port_draws(counts, "poisson", num_boot=64)
    n_obs = float(counts.sum(-1).max())
    want = j_est.cov_compressed(
        jnp.asarray(values), jnp.asarray(values_2), jnp.asarray(draws),
        jnp.asarray(inv_sf), jnp.asarray(inv_sf**2), n_obs)
    got = t_est.cov_compressed(
        *(torch.as_tensor(x) for x in (values, values_2, draws, inv_sf,
                                       inv_sf**2)), n_obs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_mean_var_compressed_per_row_trials(rng):
    """Per-row ``n_obs`` and ``q`` (``[R, 1]``, as the tiles pass them)
    give each row the moments of its own scalars."""
    counts, values, inv_sf = _tiles(rng)
    draws = torch.as_tensor(_port_draws(counts, "gaussian", num_boot=16))
    n_obs = torch.tensor([[400.0], [500.0]])
    q = torch.tensor([[0.1], [0.2]])
    args = [torch.as_tensor(x).reshape(2, 3, -1)
            for x in (values, inv_sf, inv_sf**2)]
    got = t_est.mean_var_compressed(args[0], draws.reshape(2, 3, -1, 16),
                                    args[1], args[2], n_obs, q,
                                    t_est.HYPER_RELATIVE)
    for r in range(2):
        want = t_est.mean_var_compressed(
            args[0][r], draws.reshape(2, 3, -1, 16)[r], args[1][r],
            args[2][r], float(n_obs[r, 0]), float(q[r, 0]),
            t_est.HYPER_RELATIVE)
        for g, w in zip(got, want):
            torch.testing.assert_close(g[r], w)


@pytest.mark.parametrize("sampler", ["poisson", "gaussian", "multinomial"])
def test_bootstrap_1d_and_2d_take_every_sampler(rng, sampler):
    """The tiles' moments under each sampler against the JAX package's, in
    law (mean within 4 standard errors of the difference, sd within 15%)."""
    counts, values, inv_sf = _tiles(rng)
    values_2 = rng.integers(0, 6, size=values.shape).astype(np.float32)
    n_obs = float(counts.sum(-1).max())
    counts[:, 0] += n_obs - counts.sum(-1)  # every row holds N cells
    t_args = [torch.as_tensor(x) for x in (values, values_2, counts, inv_sf,
                                           inv_sf**2)]
    j_args = [jnp.asarray(x) for x in (values, values_2, counts, inv_sf,
                                       inv_sf**2)]
    got = t_boot.bootstrap_2d(*t_args, n_obs, 0.1, t_est.HYPER_RELATIVE, B,
                              3, sampler)
    want = j_boot.bootstrap_2d(jax.random.key(3), *j_args, n_obs, 0.1,
                               j_est.HYPER_RELATIVE, B, sampler)
    got_1d = t_boot.bootstrap_1d(*t_args[:1], *t_args[2:], n_obs, 0.1,
                                 t_est.HYPER_RELATIVE, B, 4, sampler)
    want_1d = j_boot.bootstrap_1d(jax.random.key(4), *j_args[:1],
                                  *j_args[2:], n_obs, 0.1,
                                  j_est.HYPER_RELATIVE, B, sampler)
    for g, w in zip((*got, *got_1d), (*want, *want_1d)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (len(counts), B)
        g_mean, _, g_se, _ = _stats(g)
        w_mean, _, w_se, _ = _stats(w)
        assert (np.abs(g_mean - w_mean) <= 4 * np.hypot(g_se, w_se)).all()
        np.testing.assert_allclose(g.std(-1), w.std(-1), rtol=0.15)
