"""The port's public API against the JAX package's, end to end.

Both pipelines run ``setup_memento -> create_groups -> compute_1d_moments ->
ht_1d_moments -> get_1d_ht_result`` on the same simulated data (the fixture of
``tests/test_api.py``), then ``compute_2d_moments -> ht_2d_moments ->
get_2d_ht_result`` and ``get_corr_matrix`` on the state that left.  The host
stages are float64 and agree to rounding (rtol 1e-12 in 1D, 1e-10 for the
pair covariances); the tests' results agree by name and order (observed
coefficients rtol 1e-5, SEs within Monte Carlo tolerance), and both detect
the planted effects.
"""

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sparse
import torch

import memento_tpu as mt
from memento_tpu.models.simulate import simulate_two_groups

import memento_tpu_torch as mtt

# tier-1 runs several pytest workers at once: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

N_DE = 5
B = 400


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    X, cond, rep, qs = simulate_two_groups(
        n_cells_per_group=450, n_genes=40, q=0.1, de_genes=np.arange(N_DE),
        de_lfc=0.6, dv_genes=np.arange(5, 10), dv_scale=3.0, n_replicates=2,
        rng=rng)
    obs = pd.DataFrame({"condition": cond.astype(str),
                        "replicate": rep.astype(str), "capture_q": qs})
    genes = [f"G{i}" for i in range(X.shape[1])]
    return sparse.csr_matrix(X.astype(np.float64)), obs, genes


def _run(pkg, adata, device=None):
    pkg.setup_memento(adata, q_column="capture_q", filter_mean_thresh=0.01,
                      trim_percent=0.3)
    pkg.create_groups(adata, label_columns=["condition", "replicate"])
    pkg.compute_1d_moments(adata, min_perc_group=0.5)
    groups = pkg.get_groups(adata)
    covariate = pd.DataFrame(np.ones((len(groups), 1)), index=groups.index,
                             columns=["intercept"])
    treatment = pd.DataFrame({"tx": np.asarray(groups["condition"])
                              .astype(int)}, index=groups.index)
    kw = dict(covariate=covariate, treatment=treatment, num_boot=B,
              resampling="bootstrap", tile_size=64, verbose=0)
    if device is not None:
        kw["device"] = device
    pkg.ht_1d_moments(adata, **kw)
    return adata


@pytest.fixture(scope="module")
def pipelines(data):
    X, obs, genes = data
    var = pd.DataFrame(index=genes)
    jax_ad = _run(mt, mt.AnnData(X.copy(), obs=obs.copy(), var=var.copy()))
    # the port takes the DataFrames by duck typing, without importing pandas
    port_ad = _run(mtt, mtt.AnnData(X.copy(), obs=obs.copy(), var=var.copy()),
                   device="cpu")
    return jax_ad, port_ad


def test_uns_state_matches(pipelines):
    jax_ad, port_ad = pipelines
    ju, pu = jax_ad.uns["memento"], port_ad.uns["memento"]
    assert set(pu) == set(ju)
    for key in ("q_column", "estimator_type", "num_bins", "groups",
                "label_columns", "least_variable_genes", "gene_list"):
        assert pu[key] == ju[key], key
    assert pu["all_q"] == pytest.approx(ju["all_q"], rel=1e-12)
    np.testing.assert_array_equal(pu["overall_gene_filter"],
                                  ju["overall_gene_filter"])
    np.testing.assert_allclose(np.asarray(port_ad.obs["memento_size_factor"]),
                               jax_ad.obs["memento_size_factor"].values,
                               rtol=1e-12)
    for a, b in zip(pu["all_1d_moments"], ju["all_1d_moments"]):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    for g in ju["groups"]:
        np.testing.assert_allclose(pu["approx_size_factor"][g],
                                   ju["approx_size_factor"][g], rtol=1e-12)
        np.testing.assert_allclose(pu["mv_regressor"][g],
                                   ju["mv_regressor"][g], rtol=1e-12)
        assert pu["group_q"][g] == pytest.approx(ju["group_q"][g], rel=1e-12)
        for a, b in zip(pu["1d_moments"][g], ju["1d_moments"][g]):
            np.testing.assert_allclose(a, b, rtol=1e-12, equal_nan=True)
        assert (pu["group_cells"][g] != ju["group_cells"][g]).nnz == 0
    assert list(port_ad.var.index) == list(jax_ad.var.index)


def test_getters_match(pipelines):
    jax_ad, port_ad = pipelines
    jg, pg = mt.get_groups(jax_ad), mtt.get_groups(port_ad)
    assert pg.columns == list(jg.columns)
    assert list(pg.index) == list(jg.index)
    for col in jg.columns:
        np.testing.assert_array_equal(pg[col], jg[col].values)
    jm, jv, jc = mt.get_1d_moments(jax_ad)
    pm, pv, pc = mtt.get_1d_moments(port_ad)
    assert pc == jc and pm.columns == list(jm.columns)
    for col in list(jm.columns)[1:]:
        np.testing.assert_allclose(pm[col], jm[col].values, rtol=1e-12)
        np.testing.assert_allclose(pv[col], jv[col].values, rtol=1e-12,
                                   equal_nan=True)
    jgm, _ = mt.get_1d_moments(jax_ad, groupby="condition")
    pgm, _ = mtt.get_1d_moments(port_ad, groupby="condition")
    assert pgm.columns == list(jgm.columns)
    for col in list(jgm.columns)[1:]:
        np.testing.assert_allclose(pgm[col], jgm[col].values, rtol=1e-12)


def test_results_match_and_detect_effects(pipelines):
    jax_ad, port_ad = pipelines
    jax_res = mt.get_1d_ht_result(jax_ad)
    port_res = mtt.get_1d_ht_result(port_ad)
    assert port_res.columns == list(jax_res.columns) == [
        "gene", "tx", "de_coef", "de_se", "de_pval", "dv_coef", "dv_se",
        "dv_pval"]
    assert list(port_res["gene"]) == list(jax_res["gene"])
    assert list(port_res["tx"]) == list(jax_res["tx"])
    for col in ("de_coef", "dv_coef"):
        np.testing.assert_allclose(port_res[col], jax_res[col].values, rtol=1e-5,
                                   atol=1e-6, equal_nan=True)
    ok = np.isfinite(port_res["de_se"]) & np.isfinite(jax_res["de_se"].values)
    ratio = np.median(port_res["de_se"][ok] / jax_res["de_se"].values[ok])
    assert 0.85 <= ratio <= 1.15

    gene = np.asarray(port_res["gene"])
    planted = np.isin(gene, [f"G{i}" for i in range(N_DE)])
    null = np.isin(gene, [f"G{i}" for i in range(10, 40)])
    assert (port_res["de_pval"][planted] < 0.05).mean() >= 0.8
    assert port_res["de_coef"][planted].mean() > 0.3
    assert 0.3 <= np.nanmedian(port_res["de_pval"][null]) <= 0.7
    assert (port_res["de_pval"][null] < 0.05).mean() < 0.25


def test_api_refuses_what_is_not_ported(pipelines):
    """Every option of the JAX package's API runs in the port: ``mesh`` (a
    CPU mesh here) and ``distributed=True`` (outside a process group: one
    process) equal the plain runs bit for bit, in 1D, in 2D and in
    ``get_corr_matrix`` (atol 1e-5); what is still refused is refused as the
    JAX package refuses it: ``get_corr_matrix`` with a custom estimator
    tuple, and the default device (the card) where there is none."""
    _, port_ad = pipelines
    groups = mtt.get_groups(port_ad)
    tx = np.asarray(groups["condition"], float)[:, None]
    ad = port_ad.copy()
    genes = list(ad.var.index)
    mtt.compute_2d_moments(ad, [(genes[0], genes[1]), (genes[2], genes[3])])
    kw = dict(covariate=np.ones((4, 1)), treatment=tx, num_boot=16,
              approx=True, device="cpu", verbose=0)
    for test, result in ((mtt.ht_1d_moments, mtt.get_1d_ht_result),
                         (mtt.ht_2d_moments, mtt.get_2d_ht_result)):
        test(ad, **kw)
        want = result(ad)
        for option in (dict(mesh=("cpu", "cpu")), dict(distributed=True)):
            test(ad, **dict(kw, **option))
            got = result(ad)
            for col in want.columns:
                np.testing.assert_array_equal(got[col], want[col],
                                              err_msg=f"{option} {col}")
    group = ad.uns["memento"]["groups"][0]
    np.testing.assert_allclose(
        mtt.get_corr_matrix(ad, group, mesh=("cpu", "cpu")),
        mtt.get_corr_matrix(ad, group, device="cpu"), atol=1e-5,
        equal_nan=True)
    custom = ad.copy()
    custom.uns["memento"]["estimator_type"] = (len, len)
    with pytest.raises(NotImplementedError, match="registry estimator_type"):
        mtt.get_corr_matrix(custom, custom.uns["memento"]["groups"][0],
                            device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        for call in (
            lambda: mtt.ht_1d_moments(ad, **dict(kw, device=None)),
            lambda: mtt.ht_2d_moments(ad, **dict(kw, device=None)),
            lambda: mtt.get_corr_matrix(ad, ad.uns["memento"]["groups"][0]),
        ):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()


# ---------------------------------------------------------------------------
# the 2D path and the correlation matrix
# ---------------------------------------------------------------------------


def _gene_pairs(genes):
    """Pairs over the tested genes: distinct pairs, one repeated, one
    reversed, and a gene with itself."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, len(genes), 14)
    b = (a + 1 + rng.integers(0, len(genes) - 1, 14)) % len(genes)
    pairs = [(genes[i], genes[j]) for i, j in zip(a, b)]
    return pairs + [pairs[0], pairs[1][::-1], (genes[4], genes[4])]


def _run_2d(pkg, adata, n_tx=1, device=None):
    pkg.compute_2d_moments(adata, _gene_pairs(list(adata.var.index)))
    groups = pkg.get_groups(adata)
    covariate = pd.DataFrame(np.ones((len(groups), 1)), index=groups.index,
                             columns=["intercept"])
    tx = np.asarray(groups["condition"]).astype(int)
    treatment = pd.DataFrame({"tx": tx, "rep": np.asarray(
        groups["replicate"]).astype(int)}, index=groups.index)
    kw = dict(covariate=covariate, treatment=treatment.iloc[:, :n_tx],
              num_boot=B, resampling="bootstrap", tile_size=64, verbose=0,
              seed=4)
    if device is not None:
        kw["device"] = device
    pkg.ht_2d_moments(adata, **kw)
    return adata


@pytest.fixture(scope="module")
def pipelines_2d(pipelines):
    jax_ad, port_ad = pipelines
    return (_run_2d(mt, jax_ad.copy()),
            _run_2d(mtt, port_ad.copy(), device="cpu"))


def test_2d_moments_match(pipelines_2d):
    jax_ad, port_ad = pipelines_2d
    j2 = jax_ad.uns["memento"]["2d_moments"]
    p2 = port_ad.uns["memento"]["2d_moments"]
    assert set(p2) == set(j2)
    assert p2["gene_pairs"] == j2["gene_pairs"]
    for key in ("gene_idx_1", "gene_idx_2"):
        np.testing.assert_array_equal(p2[key], j2[key])
    for g in jax_ad.uns["memento"]["groups"]:
        assert set(p2[g]) == {"cov", "corr", "var_1", "var_2"}
        for key in p2[g]:
            np.testing.assert_allclose(p2[g][key], j2[g][key], rtol=1e-10,
                                       atol=1e-14, err_msg=f"{g} {key}")
    jm, jc = mt.get_2d_moments(jax_ad)
    pm, pc = mtt.get_2d_moments(port_ad)
    assert pc == jc and pm.columns == list(jm.columns)
    assert list(pm["gene_1"]) == list(jm["gene_1"])
    assert list(pm["gene_2"]) == list(jm["gene_2"])
    for col in list(jm.columns)[2:]:
        np.testing.assert_allclose(pm[col], jm[col].values, rtol=1e-10)
    for groupby in ("condition", "ALL"):
        jg = mt.get_2d_moments(jax_ad, groupby=groupby)
        pg = mtt.get_2d_moments(port_ad, groupby=groupby)
        assert pg.columns == list(jg.columns)
        for col in list(jg.columns)[2:]:
            np.testing.assert_allclose(pg[col], jg[col].values, rtol=1e-10)


def test_2d_results_match(pipelines_2d):
    jax_ad, port_ad = pipelines_2d
    jax_res = mt.get_2d_ht_result(jax_ad)
    port_res = mtt.get_2d_ht_result(port_ad)
    assert port_res.columns == list(jax_res.columns) == [
        "gene_1", "gene_2", "corr_coef", "corr_se", "corr_pval"]
    assert list(port_res["gene_1"]) == list(jax_res["gene_1"])
    assert list(port_res["gene_2"]) == list(jax_res["gene_2"])
    np.testing.assert_allclose(port_res["corr_coef"],
                               jax_res["corr_coef"].values, rtol=1e-5,
                               atol=1e-6, equal_nan=True)
    n = len(port_res["gene_1"])
    for res in (port_res, {c: jax_res[c].values for c in jax_res.columns}):
        for col in ("corr_coef", "corr_se", "corr_pval"):
            vals = np.asarray(res[col])
            # the repeated and the reversed pair get their first row's result
            assert vals[n - 3] == vals[0] and vals[n - 2] == vals[1], col
            assert np.isnan(vals[n - 1]), col  # a gene with itself
            assert np.isfinite(vals[:n - 1]).all(), col
    ok = np.isfinite(port_res["corr_se"])
    ratio = np.median(port_res["corr_se"][ok] / jax_res["corr_se"].values[ok])
    assert 0.85 <= ratio <= 1.15
    pdiff = np.nanmedian(np.abs(port_res["corr_pval"]
                                - jax_res["corr_pval"].values))
    assert pdiff <= 0.05


def test_2d_multi_column_treatment_warns_and_tests_column_0(pipelines,
                                                            pipelines_2d):
    """Both packages warn and report the first treatment column only; with
    the same seed the port's result equals its one-column run exactly."""
    jax_ad, port_ad = pipelines
    with pytest.warns(UserWarning, match="FIRST"):
        two = _run_2d(mtt, port_ad.copy(), n_tx=2, device="cpu")
    with pytest.warns(UserWarning, match="FIRST"):
        _run_2d(mt, jax_ad.copy(), n_tx=2)
    one = mtt.get_2d_ht_result(pipelines_2d[1])
    got = mtt.get_2d_ht_result(two)
    for col in ("corr_coef", "corr_se", "corr_pval"):
        np.testing.assert_array_equal(got[col], one[col], err_msg=col)


def test_get_corr_matrix_matches_jax(pipelines):
    """Float32 Gram sums on both sides, finished in float64: atol 1e-5, NaN
    pattern equal, unit diagonal."""
    jax_ad, port_ad = pipelines
    for group in jax_ad.uns["memento"]["groups"][:2]:
        want = mt.get_corr_matrix(jax_ad, group)
        got = mtt.get_corr_matrix(port_ad, group, device="cpu")
        assert got.shape == want.shape == (port_ad.n_vars, port_ad.n_vars)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, atol=1e-5, equal_nan=True)
        assert np.isfinite(got).mean() > 0.9
        np.testing.assert_allclose(np.diag(got)[np.isfinite(np.diag(got))],
                                   1.0, atol=1e-4)
