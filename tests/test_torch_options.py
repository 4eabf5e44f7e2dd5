"""The options of the port's API against the JAX package's: per-gene and
per-pair treatments (``treatment_for_gene``, eQTL mode), checkpoint/resume,
``prepare_to_save``, ``resample_rep`` and permutation p-values.  The
analogues of ``tests/test_api_extra.py``.

Observed coefficients are deterministic and agree with the JAX package's to
float32 rounding (rtol 1e-5); SEs and p-values come from other random
streams and agree within Monte Carlo tolerance.  A resumed checkpointed run
equals the uninterrupted one bit for bit.
"""

import ast
import os
import pickle

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sparse
import torch

import memento_tpu as mt
from memento_tpu.models.simulate import simulate_two_groups

import memento_tpu_torch as mtt
from memento_tpu_torch import api as t_api
from memento_tpu_torch.utils.blocks import clear_checkpoints

# the suite runs under several pytest workers at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

B = 200


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    X, cond, rep, qs = simulate_two_groups(
        n_cells_per_group=400, n_genes=30, q=0.1, de_genes=np.arange(4),
        de_lfc=0.8, n_replicates=2, rng=rng)
    obs = pd.DataFrame({"condition": cond.astype(str),
                        "replicate": rep.astype(str), "capture_q": qs})
    var = pd.DataFrame(index=[f"G{i}" for i in range(X.shape[1])])
    return sparse.csr_matrix(X.astype(np.float64)), obs, var


def _prep(pkg, data):
    """``(adata, covariate, treatment)`` after the 1D moments; the treatment
    has the condition ``tx`` and the replicate ``rep``."""
    X, obs, var = data
    adata = pkg.AnnData(X.copy(), obs=obs.copy(), var=var.copy())
    pkg.setup_memento(adata, q_column="capture_q", filter_mean_thresh=0.01,
                      trim_percent=0.3)
    pkg.create_groups(adata, label_columns=["condition", "replicate"])
    pkg.compute_1d_moments(adata, min_perc_group=0.5)
    groups = pkg.get_groups(adata)
    cov = pd.DataFrame(np.ones((len(groups), 1)), index=groups.index)
    tx = pd.DataFrame({"tx": np.asarray(groups["condition"]).astype(int),
                       "rep": np.asarray(groups["replicate"]).astype(int)},
                      index=groups.index)
    return adata, cov, tx


@pytest.fixture(scope="module")
def prepped(data):
    """Both packages' state after the 1D moments (copied per use)."""
    return _prep(mt, data), _prep(mtt, data)


def _copies(prepped):
    (j_ad, cov, tx), (t_ad, _, _) = prepped
    return j_ad.copy(), t_ad.copy(), cov, tx


def _col(table, name):
    return np.asarray(table[name])


KW = dict(num_boot=B, resampling="bootstrap", tile_size=16, seed=3,
          verbose=0)


def test_treatment_for_gene_1d_matches_jax(prepped):
    """Even genes test ``tx``, odd genes ``tx`` and ``rep``: the same
    ``(gene, tx)`` rows and coefficients as the JAX package; every ``tx``
    row's coefficient is that of the run without ``treatment_for_gene``."""
    j_ad, t_ad, cov, tx = _copies(prepped)
    genes = list(t_ad.var.index)
    tfg = {g: ["tx"] if i % 2 == 0 else ["tx", "rep"]
           for i, g in enumerate(genes)}
    mt.ht_1d_moments(j_ad, covariate=cov, treatment=tx,
                     treatment_for_gene=tfg, **KW)
    mtt.ht_1d_moments(t_ad, covariate=cov, treatment=tx,
                      treatment_for_gene=tfg, device="cpu", **KW)
    want, got = mt.get_1d_ht_result(j_ad), mtt.get_1d_ht_result(t_ad)
    assert len(got["gene"]) == sum(len(v) for v in tfg.values())
    assert list(got["gene"]) == list(want["gene"])
    assert list(got["tx"]) == list(want["tx"])
    for col in ("de_coef", "dv_coef"):
        np.testing.assert_allclose(_col(got, col), want[col].values,
                                   rtol=1e-5, atol=1e-6, equal_nan=True)
    ok = np.isfinite(_col(got, "de_se")) & np.isfinite(want["de_se"].values)
    assert np.median(np.abs(np.log(_col(got, "de_se")[ok]
                                   / want["de_se"].values[ok]))) < 0.15
    mtt.ht_1d_moments(t_ad, covariate=cov, treatment=tx[["tx"]],
                      device="cpu", **KW)
    plain = mtt.get_1d_ht_result(t_ad)
    on_tx = _col(got, "tx") == "tx"
    np.testing.assert_array_equal(_col(got, "gene")[on_tx], plain["gene"])
    for col in ("de_coef", "dv_coef"):
        np.testing.assert_allclose(_col(got, col)[on_tx], plain[col],
                                   rtol=1e-5, atol=1e-6, equal_nan=True)


def test_treatment_for_gene_2d_matches_jax(prepped):
    j_ad, t_ad, cov, tx = _copies(prepped)
    genes = list(t_ad.var.index)
    pairs = [(genes[0], genes[1]), (genes[2], genes[3]), (genes[5], genes[4]),
             (genes[1], genes[0])]
    tfg = {frozenset((genes[0], genes[1])): ["tx"],
           frozenset((genes[2], genes[3])): ["tx", "rep"],
           frozenset((genes[4], genes[5])): ["rep"]}
    for pkg, ad, extra in ((mt, j_ad, {}), (mtt, t_ad, {"device": "cpu"})):
        pkg.compute_2d_moments(ad, pairs)
        pkg.ht_2d_moments(ad, covariate=cov, treatment=tx,
                          treatment_for_gene=tfg, **KW, **extra)
    want, got = mt.get_2d_ht_result(j_ad), mtt.get_2d_ht_result(t_ad)
    assert list(got["gene_1"]) == list(want["gene_1"])
    assert list(got["gene_2"]) == list(want["gene_2"])
    np.testing.assert_allclose(_col(got, "corr_coef"),
                               want["corr_coef"].values, rtol=1e-5,
                               atol=1e-6, equal_nan=True)
    assert np.isfinite(_col(got, "corr_coef")).all()
    assert _col(got, "corr_coef")[3] == _col(got, "corr_coef")[0]
    assert "treatment_for_gene" in t_ad.uns["memento"]["2d_ht"]


def test_per_gene_one_sample_mixed(prepped):
    """Genes whose treatment subset is all ones get the weighted average of
    the log means (one-sample); the other genes of the same tile get the
    regression coefficient of an unmixed run."""
    _, t_ad, cov, tx = _copies(prepped)
    genes = list(t_ad.var.index)
    tx1 = tx.copy()
    tx1["ones"] = 1.0
    tfg = {g: ["ones"] if i % 3 == 0 else ["tx"] for i, g in enumerate(genes)}
    mtt.ht_1d_moments(t_ad, covariate=cov, treatment=tx1,
                      treatment_for_gene=tfg, device="cpu", **KW)
    res = mtt.get_1d_ht_result(t_ad)
    assert len(res["gene"]) == len(genes)
    uns = t_ad.uns["memento"]
    groups = uns["groups"]
    nc = np.array([uns["group_cells"][g].shape[0] for g in groups], float)
    tm = np.stack([uns["1d_moments"][g][0] for g in groups])
    checked = 0
    for i in range(0, len(genes), 3):
        valid = np.isfinite(tm[:, i]) & (tm[:, i] > 0)
        if valid.any() and np.isfinite(res["de_coef"][i]):
            want = np.average(np.log(tm[valid, i]), weights=nc[valid])
            np.testing.assert_allclose(res["de_coef"][i], want, rtol=1e-4)
            checked += 1
    assert checked >= 5
    tfg_reg = {g: ["tx"] for g in genes}
    unmixed = t_ad.copy()
    mtt.ht_1d_moments(unmixed, covariate=cov, treatment=tx1,
                      treatment_for_gene=tfg_reg, device="cpu", **KW)
    reg = mtt.get_1d_ht_result(unmixed)
    rows = np.arange(len(genes)) % 3 != 0
    np.testing.assert_allclose(res["de_coef"][rows], reg["de_coef"][rows],
                               rtol=1e-5, equal_nan=True)


def _run_checkpointed(ad, cov, tx, path, test, **over):
    kw = dict(KW, tile_size=8, checkpoint_dir=str(path), checkpoint_block=8)
    kw.update(over)
    if test == "1d":
        mtt.ht_1d_moments(ad, covariate=cov, treatment=tx[["tx"]],
                          device="cpu", **kw)
        return mtt.get_1d_ht_result(ad)
    mtt.ht_2d_moments(ad, covariate=cov, treatment=tx[["tx"]], device="cpu",
                      **kw)
    return mtt.get_2d_ht_result(ad)


def _pairs_2d(ad):
    genes = list(ad.var.index)
    return [(genes[i], genes[(i * 7 + 3) % len(genes)])
            for i in range(len(genes))]


@pytest.mark.parametrize("test", ["1d", "2d"])
def test_checkpoint_resume_is_bit_for_bit(prepped, tmp_path, monkeypatch,
                                          test):
    """Delete one block file and run again: only that block is computed,
    and the result equals the uninterrupted run bit for bit."""
    _, ad, cov, tx = _copies(prepped)
    if test == "2d":
        mtt.compute_2d_moments(ad, _pairs_2d(ad))
    first = _run_checkpointed(ad, cov, tx, tmp_path, test)
    name = f"{test}_ht"
    files = sorted(os.listdir(tmp_path))
    assert len(files) >= 3 and all(f.startswith(name) for f in files)
    os.remove(tmp_path / f"{name}_block00001.npz")
    runner = "run_ht_1d" if test == "1d" else "run_ht_2d"
    calls = []
    real = getattr(t_api, runner)

    def counted(*a, **kw):
        calls.append(kw["seed"])
        return real(*a, **kw)

    monkeypatch.setattr(t_api, runner, counted)
    again = _run_checkpointed(ad, cov, tx, tmp_path, test)
    assert len(calls) == 1
    assert sorted(os.listdir(tmp_path)) == files
    for col in first.columns:
        np.testing.assert_array_equal(np.asarray(again[col]),
                                      np.asarray(first[col]), err_msg=col)


def test_checkpoint_fingerprint_mismatch_raises(prepped, tmp_path):
    """Blocks of another run (seed, B) raise; once cleared, the other run
    computes and writes its own."""
    _, ad, cov, tx = _copies(prepped)
    _run_checkpointed(ad, cov, tx, tmp_path, "1d")
    with pytest.raises(ValueError, match="different run"):
        _run_checkpointed(ad, cov, tx, tmp_path, "1d", seed=4)
    with pytest.raises(ValueError, match="different run"):
        _run_checkpointed(ad, cov, tx, tmp_path, "1d", num_boot=B + 1)
    n_blocks = len(os.listdir(tmp_path))
    assert clear_checkpoints(str(tmp_path), "2d_ht") == 0
    assert clear_checkpoints(str(tmp_path), "1d_ht") == n_blocks
    res = _run_checkpointed(ad, cov, tx, tmp_path, "1d", seed=4)
    assert len(os.listdir(tmp_path)) == n_blocks
    assert np.isfinite(res["de_coef"]).mean() > 0.9


@pytest.mark.parametrize("test", ["1d", "2d"])
def test_one_block_equals_no_checkpoint(prepped, tmp_path, test):
    _, ad, cov, tx = _copies(prepped)
    if test == "2d":
        mtt.compute_2d_moments(ad, _pairs_2d(ad))
    ckpt = _run_checkpointed(ad, cov, tx, tmp_path, test,
                             checkpoint_block=4096)
    assert len(os.listdir(tmp_path)) == 1
    plain = _run_checkpointed(ad, cov, tx, tmp_path, test,
                              checkpoint_dir=None)
    for col in plain.columns:
        np.testing.assert_array_equal(np.asarray(ckpt[col]),
                                      np.asarray(plain[col]), err_msg=col)


@pytest.mark.parametrize("keep", [False, True])
def test_prepare_to_save_matches_jax(prepped, keep):
    j_ad, t_ad, _, _ = _copies(prepped)
    regressors = dict(t_ad.uns["memento"]["mv_regressor"])
    mt.prepare_to_save(j_ad, keep=keep)
    mtt.prepare_to_save(t_ad, keep=keep)
    got = t_ad.uns["memento"]["mv_regressor"]
    assert set(got) == set(j_ad.uns["memento"]["mv_regressor"])
    if not keep:
        assert got == {}
        return
    for group, text in got.items():
        assert isinstance(text, str)
        np.testing.assert_array_equal(
            pickle.loads(ast.literal_eval(text)), regressors[group])


@pytest.mark.parametrize("option", [
    dict(resample_rep=True),
    dict(approx=True, resampling="permutation"),
])
def test_api_options_match_jax(prepped, option):
    """``resample_rep`` and approximate permutation p-values through both
    APIs: coefficients rtol 1e-5, SEs and p-values within Monte Carlo
    tolerance; the bootstrap finds the planted effects (permuting four
    groups cannot give a p-value below 1/3)."""
    j_ad, t_ad, cov, tx = _copies(prepped)
    kw = dict(KW, **option)
    mt.ht_1d_moments(j_ad, covariate=cov, treatment=tx[["tx"]], **kw)
    mtt.ht_1d_moments(t_ad, covariate=cov, treatment=tx[["tx"]], device="cpu",
                      **kw)
    want, got = mt.get_1d_ht_result(j_ad), mtt.get_1d_ht_result(t_ad)
    assert list(got["gene"]) == list(want["gene"])
    for col in ("de_coef", "dv_coef"):
        np.testing.assert_allclose(_col(got, col), want[col].values,
                                   rtol=1e-5, atol=1e-6, equal_nan=True)
    ok = np.isfinite(_col(got, "de_se")) & np.isfinite(want["de_se"].values)
    assert ok.mean() > 0.8
    assert np.median(np.abs(np.log(_col(got, "de_se")[ok]
                                   / want["de_se"].values[ok]))) < 0.2
    assert np.nanmedian(np.abs(_col(got, "de_pval")
                               - want["de_pval"].values)) < 0.1
    if kw["resampling"] == "bootstrap":
        planted = np.isin(_col(got, "gene"), [f"G{i}" for i in range(4)])
        assert (_col(got, "de_pval")[planted] < 0.2).mean() >= 0.5
