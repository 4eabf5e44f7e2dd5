"""Degenerate inputs and many groups through the port's API, the analogues of
``tests/test_edge_cases.py`` and ``tests/test_many_groups.py``, held against
the JAX package where both compute a result (coefficients rtol 1e-5)."""

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sparse
import torch

import memento_tpu as mt

import memento_tpu_torch as mtt

# the suite runs under several pytest workers at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)


def _adata(pkg, X, cond=None):
    n = X.shape[0]
    obs = pd.DataFrame({"condition": (cond if cond is not None
                                      else np.zeros(n, int)).astype(str),
                        "capture_q": np.full(n, 0.1)})
    return pkg.AnnData(sparse.csr_matrix(np.asarray(X, dtype=np.float64)),
                       obs=obs)


def _design(pkg, adata, column="condition", treat=None):
    groups = pkg.get_groups(adata)
    cov = pd.DataFrame(np.ones((len(groups), 1)), index=groups.index)
    values = np.asarray(groups[column]).astype(int) if treat is None \
        else treat(groups)
    return cov, pd.DataFrame({"t": values}, index=groups.index)


def _both(X, cond, setup, moments, ht, treat=None):
    """The same analysis through both packages; the port on the CPU."""
    out = []
    for pkg, extra in ((mt, {}), (mtt, {"device": "cpu"})):
        adata = _adata(pkg, X, cond)
        pkg.setup_memento(adata, q_column="capture_q", **setup)
        pkg.create_groups(adata, label_columns=["condition"])
        pkg.compute_1d_moments(adata, **moments)
        cov, tx = _design(pkg, adata, treat=treat)
        pkg.ht_1d_moments(adata, covariate=cov, treatment=tx,
                          resampling="bootstrap", verbose=0, **ht, **extra)
        out.append((adata, pkg.get_1d_ht_result(adata)))
    return out


def _agree(jax_res, port_res):
    assert list(port_res["gene"]) == list(jax_res["gene"])
    for col in ("de_coef", "dv_coef"):
        np.testing.assert_allclose(np.asarray(port_res[col]),
                                   jax_res[col].values, rtol=1e-5, atol=1e-6,
                                   equal_nan=True)


def test_single_group_one_sample(rng):
    """One group and an all-ones treatment: the coefficient is the group's
    log mean."""
    X = rng.poisson(1.0, size=(400, 15))
    (_, want), (adata, got) = _both(
        X, None, dict(filter_mean_thresh=0.01, trim_percent=0.3),
        dict(min_perc_group=0.5), dict(num_boot=100, tile_size=16),
        treat=lambda groups: np.ones(len(groups)))
    _agree(want, got)
    mean_table, _, _ = mtt.get_1d_moments(adata)
    group = [c for c in mean_table.columns if c != "gene"][0]
    np.testing.assert_allclose(got["de_coef"], mean_table[group], rtol=1e-4,
                               atol=1e-5)
    assert np.isfinite(got["de_se"]).all()


def test_dead_gene_nan_live_gene_finite(rng):
    X = rng.poisson(rng.gamma(2.0, 1.0, size=(600, 30)))
    X[:, 1] = 0  # a gene with no counts
    cond = (rng.random(600) < 0.5).astype(int)
    (_, want), (_, got) = _both(
        X, cond, dict(filter_mean_thresh=0.001, trim_percent=0.5),
        dict(min_perc_group=0.5, filter_genes=False),
        dict(num_boot=80, tile_size=32))
    _agree(want, got)
    assert len(got["gene"]) == 30
    assert np.isnan(got["de_pval"][1])
    assert np.isfinite(got["de_pval"]).sum() >= 20


def test_tiny_groups(rng):
    """Four groups of six cells: no crash; results may be NaN."""
    X = rng.poisson(1.0, size=(24, 8))
    cond = np.repeat([0, 1, 2, 3], 6)
    (_, want), (_, got) = _both(
        X, cond, dict(filter_mean_thresh=0.001, trim_percent=0.5),
        dict(min_perc_group=0.2, filter_genes=False),
        dict(num_boot=50, tile_size=8, sampler="multinomial"),
        treat=lambda groups: np.asarray(groups["condition"]).astype(int) % 2)
    assert len(got["gene"]) == 8
    _agree(want, got)


def test_gene_list_subselection(rng):
    X = rng.poisson(2.0, size=(300, 12))
    cond = (rng.random(300) < 0.5).astype(int)
    adata = _adata(mtt, X, cond)
    mtt.setup_memento(adata, q_column="capture_q", filter_mean_thresh=0.001,
                      trim_percent=0.5)
    mtt.create_groups(adata, label_columns=["condition"])
    keep = ["gene_2", "gene_5", "gene_7"]
    mtt.compute_1d_moments(adata, min_perc_group=0.5, gene_list=keep)
    assert list(adata.var.index) == keep
    cov, tx = _design(mtt, adata)
    mtt.ht_1d_moments(adata, covariate=cov, treatment=tx, num_boot=60,
                      resampling="bootstrap", tile_size=8, sampler="poisson",
                      device="cpu", verbose=0)
    assert len(mtt.get_1d_ht_result(adata)["gene"]) == 3


def test_not_inplace_copies(rng):
    adata = _adata(mtt, rng.poisson(1.0, size=(200, 10)))
    out = mtt.setup_memento(adata, q_column="capture_q", inplace=False)
    assert "memento" in out.uns and "memento" not in adata.uns


def test_setup_refuses_q_at_or_above_one(rng):
    adata = _adata(mtt, rng.poisson(1.0, size=(50, 5)))
    adata.obs["capture_q"] = 1.5
    with pytest.raises(ValueError, match="capture"):
        mtt.setup_memento(adata, q_column="capture_q")


def test_many_groups_guide_vs_control(rng):
    """24 guide groups (CROP-seq style), 8 of them knocking gene 0 down:
    the knockdown is found, the other genes stay mostly null, and the
    coefficients are the JAX package's."""
    n_guides, per_guide, n_genes, q = 24, 120, 25, 0.1
    base = np.exp(rng.uniform(np.log(2.0), np.log(15.0), n_genes))
    blocks, labels = [], []
    for g in range(n_guides):
        mu = base.copy()
        if g < 8:
            mu[0] *= 0.4
        lam = rng.gamma(3.0, mu / 3.0, size=(per_guide, n_genes))
        blocks.append(rng.poisson(lam * q))
        labels.append(np.full(per_guide, f"guide{g:02d}"))
    X = np.vstack(blocks)
    results = []
    for pkg, extra in ((mt, {}), (mtt, {"device": "cpu"})):
        obs = pd.DataFrame({"guide": np.concatenate(labels),
                            "capture_q": np.full(X.shape[0], q)})
        adata = pkg.AnnData(sparse.csr_matrix(X.astype(np.float64)), obs=obs)
        pkg.setup_memento(adata, q_column="capture_q",
                          filter_mean_thresh=0.01, trim_percent=0.3)
        pkg.create_groups(adata, label_columns=["guide"])
        pkg.compute_1d_moments(adata, min_perc_group=0.8)
        cov, tx = _design(pkg, adata, treat=lambda groups: np.array(
            [int(int(g[5:]) < 8) for g in groups["guide"]]))
        assert len(cov) == n_guides
        pkg.ht_1d_moments(adata, covariate=cov, treatment=tx, num_boot=200,
                          resampling="bootstrap", tile_size=32, verbose=0,
                          **extra)
        results.append(pkg.get_1d_ht_result(adata))
    want, got = results
    _agree(want, got)
    target = np.asarray(got["gene"]) == "gene_0"
    assert target.sum() == 1
    assert got["de_coef"][target][0] < -0.4
    assert got["de_pval"][target][0] < 0.01
    assert (got["de_pval"][~target] < 0.05).mean() < 0.2
