"""Simulation suite: generative models for validation.

Counterpart of ``memento_tpu/models/simulate.py``, equal to it output for
output for the same ``numpy.random.Generator``: parameter extraction from
real data, a negative-binomial-marginal Gaussian-copula transcriptome
generator, the capture-process samplers (multivariate hypergeometric or
Poisson thinning, optionally with Beta-distributed per-cell efficiency), a
read sampler, and the two-condition fixture with planted effects that the
tests use.  It sits on the port's own ``estimate_size_factor`` and
``mean_var_sparse``.

Host-side numpy: simulation makes test data, it is not a hot path.
"""

from __future__ import annotations

import numpy as np
import scipy.stats as stats

from ..ops.estimators import mean_var_sparse
from ..ops.size_factor import estimate_size_factor


def extract_parameters(data, q=0.1, min_mean=0.001):
    """Fit x-space (relative) and z-space (absolute) moments of a real
    dataset."""
    import scipy.sparse as sparse

    data = data if sparse.issparse(data) else sparse.csr_matrix(data)
    sf = estimate_size_factor(data, "hyper_relative", total=True, shrinkage=0.0)
    x_mean, x_var = mean_var_sparse(data, sf, q, "hyper_relative")

    good_idx = np.where(np.asarray(data.mean(axis=0)).ravel() > min_mean)[0]
    nc = np.asarray(data.sum(axis=1)).ravel() / q

    z_mean = x_mean * nc.mean()
    z_var = (x_var + x_mean**2) * (nc**2).mean() - x_mean**2 * nc.mean() ** 2
    return (
        (x_mean[good_idx], x_var[good_idx]),
        (z_mean[good_idx], z_var[good_idx]),
        nc,
        good_idx,
    )


def gamma_params_from_moments(m, v):
    """Gamma shape and scale from a mean and a variance."""
    return m**2 / v, v / m


def convert_params_nb(mu, theta):
    """Mean/dispersion negative binomial -> scipy's (n, p)."""
    r = theta
    var = mu + 1 / r * mu**2
    p = (var - mu) / var
    return r, 1 - p


def simulate_transcriptomes(n_cells, means, variances, Nc, norm_cov=None,
                            rng=None):
    """Negative-binomial-marginal Gaussian-copula transcriptome generator.

    Args:
      means, variances: per-gene z-space (pre-capture) moments.
      Nc: empirical cell-size pool to resample from.
      norm_cov: None -> random SPD copula covariance (scikit-learn's
        ``make_spd_matrix``); any string (``'independent'``) -> independent
        NB draws; an array -> that copula covariance.
    """
    rng = np.random.default_rng() if rng is None else rng
    means = np.asarray(means, dtype=np.float64)
    variances = np.asarray(variances, dtype=np.float64)
    n_genes = means.shape[0]

    dispersions = (variances - means) / means**2
    dispersions[dispersions < 0] = 1e-5
    thetas = 1 / dispersions

    if isinstance(norm_cov, str):
        return stats.nbinom.rvs(
            *convert_params_nb(means, thetas), size=(n_cells, n_genes),
            random_state=rng,
        )

    norm_mean = rng.random(n_genes)
    if norm_cov is None:
        from sklearn.datasets import make_spd_matrix

        norm_cov = make_spd_matrix(n_genes, random_state=rng.integers(2**31))
    norm_var = np.diag(norm_cov)

    gaussians = stats.multivariate_normal.rvs(
        mean=norm_mean, cov=norm_cov, size=n_cells, random_state=rng
    )
    uniforms = stats.norm.cdf(gaussians, loc=norm_mean, scale=np.sqrt(norm_var))
    nb_vars = stats.nbinom.ppf(uniforms, *convert_params_nb(means, thetas))

    cell_sizes = rng.choice(Nc, size=n_cells).reshape(-1, 1)
    relative = nb_vars / nb_vars.sum(axis=1).reshape(-1, 1)
    return np.round(relative * cell_sizes).astype(int)


def capture_sampling(transcriptomes, q, q_sq=None, process="hyper", rng=None):
    """Simulate the capture process.

    'hyper': per-cell multivariate hypergeometric draw of round(q*total)
    molecules; 'poisson': Poisson thinning.  ``q_sq`` turns on Beta-
    distributed per-cell efficiencies with the given second moment.

    Returns:
      (qs, captured): per-cell efficiencies and captured count matrix.
    """
    rng = np.random.default_rng(42343) if rng is None else rng
    transcriptomes = np.asarray(transcriptomes)
    n_cells = transcriptomes.shape[0]
    if q_sq is None:
        qs = np.ones(n_cells) * q
    else:
        m = q
        v = q_sq - q**2
        alpha = m * (m * (1 - m) / v - 1)
        beta = (1 - m) * (m * (1 - m) / v - 1)
        qs = stats.beta.rvs(alpha, beta, size=n_cells, random_state=rng)

    if process == "hyper":
        captured = np.vstack(
            [
                rng.multivariate_hypergeometric(
                    transcriptomes[i, :],
                    int(np.round(qs[i] * transcriptomes[i, :].sum())),
                )
                for i in range(n_cells)
            ]
        )
    else:  # poisson
        captured = rng.poisson(transcriptomes * qs.reshape(-1, 1))
    return qs, captured


def sequencing_sampling(transcriptomes, num_reads, rng=None):
    """Simulate read sampling on top of captured molecules.

    Each of ``num_reads`` reads hits one molecule uniformly; a molecule is
    observed if it receives at least one read (UMI collapse).
    """
    rng = np.random.default_rng() if rng is None else rng
    transcriptomes = np.asarray(transcriptomes)
    observed = np.zeros_like(transcriptomes)
    num_molecules = transcriptomes.sum()
    p_hit = 1.0 - (1.0 - 1.0 / num_molecules) ** num_reads
    observed = rng.binomial(transcriptomes, p_hit)
    return observed


def simulate_two_groups(
    n_cells_per_group,
    n_genes,
    q=0.1,
    de_genes=None,
    de_lfc=0.5,
    dv_genes=None,
    dv_scale=2.0,
    n_replicates=1,
    base_mean_range=(0.5, 10.0),
    dispersion=0.3,
    rng=None,
):
    """Two-condition fixture with planted effects, used by the hypothesis-
    test validation: gamma-Poisson counts, a mean effect ``exp(de_lfc)`` on
    ``de_genes`` and a dispersion factor ``dv_scale`` on ``dv_genes`` in
    condition 1, a small per-replicate effect on every gene.

    Returns:
      (X, condition, replicate, qs): stacked count matrix, per-cell labels,
      and per-cell capture efficiencies.
    """
    rng = np.random.default_rng(0) if rng is None else rng
    base = np.exp(
        rng.uniform(np.log(base_mean_range[0]), np.log(base_mean_range[1]),
                    n_genes)
    )
    de_genes = np.array([], dtype=int) if de_genes is None else np.asarray(de_genes)
    dv_genes = np.array([], dtype=int) if dv_genes is None else np.asarray(dv_genes)

    Xs, conds, reps = [], [], []
    for rep in range(n_replicates):
        rep_effect = np.exp(rng.normal(0, 0.05, n_genes))
        for cond in (0, 1):
            mu = base * rep_effect
            disp = np.full(n_genes, dispersion)
            if cond == 1:
                mu = mu.copy()
                mu[de_genes] = mu[de_genes] * np.exp(de_lfc)
                disp = disp.copy()
                disp[dv_genes] = disp[dv_genes] * dv_scale
            theta = 1 / disp
            lam = rng.gamma(theta, mu / theta, size=(n_cells_per_group, n_genes))
            Xs.append(rng.poisson(lam * q))
            conds.append(np.full(n_cells_per_group, cond))
            reps.append(np.full(n_cells_per_group, rep))
    X = np.vstack(Xs)
    return (
        X,
        np.concatenate(conds),
        np.concatenate(reps),
        np.full(X.shape[0], q),
    )


__all__ = [
    "extract_parameters",
    "gamma_params_from_moments",
    "convert_params_nb",
    "simulate_transcriptomes",
    "capture_sampling",
    "sequencing_sampling",
    "simulate_two_groups",
]
