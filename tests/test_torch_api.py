"""The port's public API against the JAX package's, end to end.

Both pipelines run ``setup_memento -> create_groups -> compute_1d_moments ->
ht_1d_moments -> get_1d_ht_result`` on the same simulated data (the fixture of
``tests/test_api.py``).  The host stages are float64 and agree to rounding;
the tests' results agree by name and order, and both detect the planted
effects.
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
    _, port_ad = pipelines
    groups = mtt.get_groups(port_ad)
    tx = np.asarray(groups["condition"], float)[:, None]
    with pytest.raises(NotImplementedError):
        mtt.ht_1d_moments(port_ad.copy(), covariate=np.ones((4, 1)),
                          treatment=tx, checkpoint_dir="x", device="cpu")
    with pytest.raises(NotImplementedError):
        mtt.ht_1d_moments(port_ad.copy(), covariate=np.ones((4, 1)),
                          treatment=tx, treatment_for_gene={}, device="cpu")
