"""Custom ``(fn_1d, fn_cov)`` estimators in the port (the reference's custom
API), the analogues of ``tests/test_custom_estimator.py``.

An estimator written with operators and ``.sum(axis=0)`` only runs on torch
tensors, JAX arrays and numpy arrays alike: the port runs it batched on the
device, the JAX package traced.  One that converts its inputs with
``np.asarray`` runs item by item on the host in both packages.  Observed
coefficients are deterministic: a custom estimator that computes a registry
model's moments gives that model's coefficients (rtol 1e-6 in 1D, 1e-5 in
2D), and the port's custom run gives the JAX package's (rtol 1e-5).  SEs come
from other draws (exact multinomial for a custom estimator, the cascade for
the registry) and agree within Monte Carlo tolerance.
"""

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sparse
import torch

import memento_tpu as mt
from memento_tpu.models.simulate import simulate_two_groups

import memento_tpu_torch as mtt
from memento_tpu_torch.ops import bootstrap as t_boot

# the suite runs under several pytest workers at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)


def poisson_1d(data, n_obs, q, size_factor=None):
    """``poi_relative``'s moments with the reference's dual signature:
    tuple ``(expr [U, 1], draws [U, B])`` or a sparse matrix."""
    if isinstance(data, tuple):
        m1 = (data[0] * data[1] * size_factor[0]).sum(axis=0) / n_obs
        m2 = (data[0] ** 2 * data[1] * size_factor[1]
              - data[0] * data[1] * size_factor[1]).sum(axis=0) / n_obs
        return [m1, m2 - m1 * m1]
    row_weight = (1.0 / size_factor).reshape(1, -1)
    m1 = np.asarray(row_weight @ data).ravel() / n_obs
    m2 = (np.asarray((row_weight**2) @ data.power(2)).ravel() / n_obs
          - np.asarray((row_weight**2) @ data).ravel() / n_obs)
    return [m1, m2 - m1 * m1]


def hyper_1d(data, n_obs, q, size_factor=None):
    """``hyper_relative``'s moments, dual signature."""
    if isinstance(data, tuple):
        m1 = (data[0] * data[1] * size_factor[0]).sum(axis=0) / n_obs
        m2 = (data[0] ** 2 * data[1] * size_factor[1]
              - (1 - q) * data[0] * data[1] * size_factor[1]).sum(
                  axis=0) / n_obs
        return [m1, m2 - m1 * m1]
    row_weight = (1.0 / size_factor).reshape(1, -1)
    m1 = np.asarray(row_weight @ data).ravel() / n_obs
    m2 = (np.asarray(row_weight**2 @ data.power(2)).ravel() / n_obs
          - (1 - q) * np.asarray(row_weight**2 @ data).ravel() / n_obs)
    return [m1, m2 - m1 * m1]


def numpy_hyper_1d(data, n_obs, q, size_factor=None):
    """``hyper_1d`` as a reference-style numpy estimator: ``np.asarray``
    fails on a CUDA tensor and makes numpy arrays of a CPU one."""
    if isinstance(data, tuple):
        expr, rvs = (np.asarray(x, dtype=np.float64) for x in data)
        isf, isf2 = (np.asarray(x, dtype=np.float64) for x in size_factor)
        m1 = (expr * rvs * isf).sum(axis=0) / n_obs
        m2 = (expr**2 * rvs * isf2 - (1 - q) * expr * rvs * isf2).sum(
            axis=0) / n_obs
        return [m1, m2 - m1**2]
    return hyper_1d(data, n_obs, q, size_factor)


def poisson_cov(data, n_obs, q, size_factor, idx1=None, idx2=None):
    """``poi_relative``'s pair covariance, dual signature: tuple
    ``(expr1 [U, 1], expr2 [U, 1], draws [U, B])`` or a sparse matrix with
    the pairs' gene indices."""
    if isinstance(data, tuple):
        m1 = (data[0] * data[2] * size_factor[0]).sum(axis=0) / n_obs
        m2 = (data[1] * data[2] * size_factor[0]).sum(axis=0) / n_obs
        mx = (data[0] * data[1] * data[2] * size_factor[1]).sum(
            axis=0) / n_obs
        return mx - m1 * m2
    row_weight = (1.0 / size_factor).reshape(-1, 1)
    X = data[:, idx1].multiply(row_weight).tocsr()
    Y = data[:, idx2].multiply(row_weight).tocsr()
    prod = np.asarray(X.multiply(Y).sum(axis=0)).ravel() / n_obs
    m1 = np.asarray(X.mean(axis=0)).ravel()
    m2 = np.asarray(Y.mean(axis=0)).ravel()
    return prod - m1 * m2


def numpy_poisson_cov(data, n_obs, q, size_factor, idx1=None, idx2=None):
    if isinstance(data, tuple):
        data = tuple(np.asarray(x, dtype=np.float64) for x in data)
        size_factor = tuple(np.asarray(x, dtype=np.float64)
                            for x in size_factor)
    return poisson_cov(data, n_obs, q, size_factor, idx1, idx2)


def wrong_axis_1d(data, n_obs, q, size_factor=None):
    """Sums over the replicates instead of the bins: tensors, wrong shape."""
    m1 = (data[0] * data[1] * size_factor[0]).sum(axis=1) / n_obs
    return [m1, m1]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X, cond, rep, qs = simulate_two_groups(
        n_cells_per_group=400, n_genes=20, q=0.1, de_genes=np.arange(3),
        de_lfc=0.8, n_replicates=2, rng=rng)
    obs = pd.DataFrame({"condition": cond.astype(str),
                        "replicate": rep.astype(str), "capture_q": qs})
    return sparse.csr_matrix(X.astype(np.float64)), obs


def _run(pkg, data, estimator_type, pairs=None, device=None, **over):
    """The 1D test (or with ``pairs`` the 2D test) through ``pkg``'s API."""
    X, obs = data
    adata = pkg.AnnData(X.copy(), obs=obs.copy())
    pkg.setup_memento(adata, q_column="capture_q", filter_mean_thresh=0.01,
                      trim_percent=0.3, estimator_type=estimator_type)
    pkg.create_groups(adata, label_columns=["condition", "replicate"])
    pkg.compute_1d_moments(adata, min_perc_group=0.5)
    groups = pkg.get_groups(adata)
    kw = dict(covariate=pd.DataFrame(np.ones((len(groups), 1)),
                                     index=groups.index),
              treatment=pd.DataFrame({"tx": np.asarray(groups["condition"])
                                      .astype(int)}, index=groups.index),
              num_boot=150, resampling="bootstrap", seed=0, verbose=0)
    kw.update(over)
    if device is not None:
        kw["device"] = device
    if pairs is None:
        pkg.ht_1d_moments(adata, tile_size=24, **kw)
        return pkg.get_1d_ht_result(adata)
    genes = list(adata.var.index)
    pkg.compute_2d_moments(adata, [(genes[a], genes[b]) for a, b in pairs])
    pkg.ht_2d_moments(adata, **kw)
    return pkg.get_2d_ht_result(adata)


def _column(table, name):
    return np.asarray(table[name], dtype=np.float64)


def _se_log_ratio(a, b, name):
    a, b = _column(a, name), _column(b, name)
    ok = np.isfinite(a) & np.isfinite(b) & (b > 0)
    return ok.sum(), np.median(np.abs(np.log(a[ok] / b[ok])))


def test_custom_1d_matches_registry_poisson(data):
    t_boot.reset_custom_paths()
    custom = _run(mtt, data, (poisson_1d, poisson_cov), device="cpu")
    assert t_boot.CUSTOM_PATHS == {"device": 4, "host": 0}
    registry = _run(mtt, data, "poi_relative", device="cpu")
    assert list(custom["gene"]) == list(registry["gene"])
    np.testing.assert_allclose(_column(custom, "de_coef"),
                               _column(registry, "de_coef"), rtol=1e-6,
                               equal_nan=True)
    n_ok, log_ratio = _se_log_ratio(custom, registry, "de_se")
    assert n_ok >= 10 and log_ratio < 0.4
    planted = np.isin(custom["gene"], ["gene_0", "gene_1", "gene_2"])
    assert (_column(custom, "de_pval")[planted] < 0.1).any()
    assert _column(custom, "de_coef")[planted].mean() > 0.2


PAIRS = [(0, 1), (0, 2), (0, 3), (0, 4), (5, 6)]


def test_custom_2d_matches_registry_poisson(data):
    t_boot.reset_custom_paths()
    custom = _run(mtt, data, (poisson_1d, poisson_cov), pairs=PAIRS,
                  device="cpu", num_boot=120)
    assert t_boot.CUSTOM_PATHS == {"device": 4, "host": 0}
    registry = _run(mtt, data, "poi_relative", pairs=PAIRS, device="cpu",
                    num_boot=120)
    np.testing.assert_allclose(_column(custom, "corr_coef"),
                               _column(registry, "corr_coef"), rtol=1e-5,
                               equal_nan=True)
    n_ok, log_ratio = _se_log_ratio(custom, registry, "corr_se")
    assert n_ok >= 2 and log_ratio < 0.5


def _group_tiles(rng, t=5, u=16):
    values = torch.as_tensor(rng.integers(0, 6, (t, u)).astype(np.float32))
    counts = torch.as_tensor(rng.integers(0, 50, (t, u)).astype(np.float32))
    isf = torch.as_tensor(rng.random((t, u)).astype(np.float32) + 0.5)
    return values, counts, isf, isf * isf


def test_numpy_only_estimator_takes_the_host_path(rng):
    """On CPU tensors a numpy-only estimator returns numpy arrays: the probe
    calls that the host path, and it gives the tensor-native estimator's
    numbers from the same draws (rtol 1e-5)."""
    values, counts, isf, isf2 = _group_tiles(rng)
    args = (values, counts, isf, isf2, 400.0, 0.1, 64, 3)
    t_boot.reset_custom_paths()
    m_host, v_host = t_boot.bootstrap_1d_custom(numpy_hyper_1d, *args)
    assert t_boot.CUSTOM_PATHS == {"device": 0, "host": 1}
    m_dev, v_dev = t_boot.bootstrap_1d_custom(hyper_1d, *args)
    assert t_boot.CUSTOM_PATHS == {"device": 1, "host": 1}
    assert m_host.shape == m_dev.shape == (5, 64)
    torch.testing.assert_close(m_host, m_dev, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(v_host, v_dev, rtol=1e-5, atol=1e-5)

    values_2 = torch.as_tensor(rng.integers(0, 6, (5, 16)).astype(np.float32))
    args = (values, values_2, counts, isf, isf2, 400.0, 0.1, 64, 3)
    host = t_boot.bootstrap_2d_custom(numpy_hyper_1d, numpy_poisson_cov,
                                      *args)
    # one numpy-only estimator of the two sends the pair to the host
    mixed = t_boot.bootstrap_2d_custom(hyper_1d, numpy_poisson_cov, *args)
    dev = t_boot.bootstrap_2d_custom(hyper_1d, poisson_cov, *args)
    assert t_boot.CUSTOM_PATHS == {"device": 2, "host": 3}
    for h, x, d in zip(host, mixed, dev):
        torch.testing.assert_close(h, d, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(x, d, rtol=1e-5, atol=1e-5)


def test_probe_verdicts():
    """The probe's verdict on small tensors on the run's device."""
    dev = torch.device("cpu")

    def probe(fn):
        return t_boot._runs_on_device(
            lambda v, d, isf, isf2: fn(data=(v[:, None], d), n_obs=10.0,
                                       q=0.1, size_factor=(isf[:, None],
                                                           isf2[:, None])),
            1, dev)

    assert probe(hyper_1d)
    assert probe(poisson_1d)
    assert not probe(numpy_hyper_1d)  # numpy arrays back from CPU tensors
    assert not probe(wrong_axis_1d)  # tensors of the wrong shape

    def raises(data, n_obs, q, size_factor=None):
        raise TypeError("not for tensors")

    assert not probe(raises)


def test_cascade_samplers_draw_exact_multinomial_for_custom(rng):
    """A custom estimator under ``cascade`` / ``cascade_cuda`` draws exact
    multinomial counts: the same numbers as ``sampler='multinomial'``."""
    values, counts, isf, isf2 = _group_tiles(rng)
    args = (values, counts, isf, isf2, float(counts.sum(1).max()), 0.1, 32, 9)
    want = t_boot.bootstrap_1d_custom(hyper_1d, *args, sampler="multinomial")
    for sampler in ("cascade", "cascade_cuda"):
        got = t_boot.bootstrap_1d_custom(hyper_1d, *args, sampler=sampler)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_custom_full_api_matches_jax_1d(data):
    """The same custom estimator tuple through both packages' APIs:
    coefficients rtol 1e-5; SEs within Monte Carlo tolerance."""
    want = _run(mt, data, (hyper_1d, poisson_cov))
    got = _run(mtt, data, (hyper_1d, poisson_cov), device="cpu")
    assert list(got["gene"]) == list(want["gene"])
    for col in ("de_coef", "dv_coef"):
        np.testing.assert_allclose(_column(got, col), _column(want, col),
                                   rtol=1e-5, atol=1e-6, equal_nan=True)
    n_ok, log_ratio = _se_log_ratio(got, want, "de_se")
    assert n_ok >= 10 and log_ratio < 0.25


def test_custom_full_api_matches_jax_2d_and_numpy_only(data):
    """2D through both APIs with the same tuple (rtol 1e-5), and a
    numpy-only 1D estimator through the port's API: the host path, the
    registry model's coefficients."""
    want = _run(mt, data, (poisson_1d, poisson_cov), pairs=PAIRS,
                num_boot=120)
    got = _run(mtt, data, (poisson_1d, poisson_cov), pairs=PAIRS,
               device="cpu", num_boot=120)
    np.testing.assert_allclose(_column(got, "corr_coef"),
                               _column(want, "corr_coef"), rtol=1e-5,
                               atol=1e-6, equal_nan=True)
    t_boot.reset_custom_paths()
    host = _run(mtt, data, (numpy_hyper_1d, poisson_cov), device="cpu")
    assert t_boot.CUSTOM_PATHS == {"device": 0, "host": 4}
    registry = _run(mtt, data, "hyper_relative", device="cpu")
    np.testing.assert_allclose(_column(host, "de_coef"),
                               _column(registry, "de_coef"), rtol=1e-5,
                               equal_nan=True)
    n_ok, log_ratio = _se_log_ratio(host, registry, "de_se")
    assert n_ok >= 8 and log_ratio < 0.4


def test_get_corr_matrix_refuses_custom(data):
    X, obs = data
    adata = mtt.AnnData(X.copy(), obs=obs.copy())
    mtt.setup_memento(adata, q_column="capture_q",
                      estimator_type=(poisson_1d, poisson_cov))
    mtt.create_groups(adata, label_columns=["condition"])
    mtt.compute_1d_moments(adata, min_perc_group=0.5)
    with pytest.raises(NotImplementedError, match="registry"):
        mtt.get_corr_matrix(adata, adata.uns["memento"]["groups"][0],
                            device="cpu")
