"""The port's host surface against the JAX package's: the simulation suite,
the statistics helpers, the ``memento.util`` names, ``refine_flagged`` and
the ``.h5ad`` reader and writer.

All of it is numpy/scipy on the host, so the port's functions are held bit
for bit: the simulator equal for the same ``numpy.random.Generator`` seed,
the statistics equal, the GEV refinement within 1e-12; files written by
either package read back equal in the other.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sparse

import memento_tpu as mt
from memento_tpu import util as j_util
from memento_tpu.inference import asl as j_asl
from memento_tpu.io import h5ad as j_h5ad
from memento_tpu.models import simulate as j_sim
from memento_tpu.utils import stats as j_stats

import memento_tpu_torch as mtt
from memento_tpu_torch import util as t_util
from memento_tpu_torch.inference import asl as t_asl
from memento_tpu_torch.io import h5ad as t_h5ad
from memento_tpu_torch.models import simulate as t_sim
from memento_tpu_torch.utils import stats as t_stats

REPO = Path(__file__).resolve().parent.parent


def _same(a, b):
    """Equal outputs: arrays element for element, tuples item by item."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kwargs", [
    dict(n_cells_per_group=120, n_genes=15),
    dict(n_cells_per_group=80, n_genes=12, q=0.2, de_genes=np.arange(3),
         de_lfc=0.7, dv_genes=[4, 5], dv_scale=3.0, n_replicates=3,
         base_mean_range=(0.2, 5.0), dispersion=0.5)])
def test_simulate_two_groups_is_bit_equal(kwargs):
    _same(t_sim.simulate_two_groups(rng=np.random.default_rng(4), **kwargs),
          j_sim.simulate_two_groups(rng=np.random.default_rng(4), **kwargs))


@pytest.mark.parametrize("norm_cov", ["independent", "explicit", None])
def test_simulate_transcriptomes_is_bit_equal(norm_cov):
    means = np.linspace(1.0, 20.0, 6)
    variances = means * 1.5 + means**2 * 0.2
    nc = np.random.default_rng(1).integers(1000, 5000, 50)
    if norm_cov == "explicit":
        a = np.random.default_rng(2).normal(size=(6, 6))
        norm_cov = a @ a.T + 6 * np.eye(6)
    outs = [sim.simulate_transcriptomes(40, means, variances, nc,
                                        norm_cov=norm_cov,
                                        rng=np.random.default_rng(9))
            for sim in (t_sim, j_sim)]
    _same(*outs)
    assert outs[0].shape == (40, 6)


@pytest.mark.parametrize("process,q_sq", [("hyper", None), ("poisson", None),
                                          ("hyper", 0.02)])
def test_capture_and_sequencing_sampling_are_bit_equal(process, q_sq):
    tx = np.random.default_rng(3).poisson(30.0, size=(25, 8))
    _same(*(sim.capture_sampling(tx, 0.1, q_sq=q_sq, process=process,
                                 rng=np.random.default_rng(5))
            for sim in (t_sim, j_sim)))
    _same(*(sim.sequencing_sampling(tx, 500, rng=np.random.default_rng(6))
            for sim in (t_sim, j_sim)))


def test_parameter_helpers_are_bit_equal():
    X = sparse.csr_matrix(np.random.default_rng(7).poisson(
        1.5, size=(200, 30)).astype(float))
    _same(t_sim.extract_parameters(X, q=0.1),
          j_sim.extract_parameters(X, q=0.1))
    m, v = np.array([1.0, 2.5, 4.0]), np.array([2.0, 3.0, 9.0])
    _same(t_sim.gamma_params_from_moments(m, v),
          j_sim.gamma_params_from_moments(m, v))
    _same(t_sim.convert_params_nb(m, 1 / v), j_sim.convert_params_nb(m, 1 / v))
    # the package's aliases, as the JAX package has them
    assert mtt.simulate is t_sim and mtt.util is t_util


def test_stats_helpers_are_equal():
    rng = np.random.default_rng(8)
    p = rng.uniform(size=200) ** 2
    p[::17] = np.nan
    _same(t_stats.fdrcorrect(p), j_stats.fdrcorrect(p))
    _same(t_util._fdrcorrect(p), j_util._fdrcorrect(p))
    ok = p[np.isfinite(p)]
    for alpha in (0.05, 0.2):
        _same(t_stats.fdrcorrection(ok, alpha), j_stats.fdrcorrection(ok,
                                                                      alpha))
    _same(t_stats.lambda_gc(p), j_stats.lambda_gc(p))
    a = rng.normal(size=100)
    b = a + rng.normal(size=100)
    a[3], b[7] = np.nan, np.inf
    _same(t_stats.concordance(a, b), j_stats.concordance(a, b))
    assert np.isnan(t_stats.concordance(a[:1], b[:1]))
    _same(tuple(t_stats.robust_correlation(a, b)),
          tuple(j_stats.robust_correlation(a, b)))
    _same(tuple(t_stats.robust_linregress(a, b)),
          tuple(j_stats.robust_linregress(a, b)))


def test_util_slicing_helpers_are_equal():
    rng = np.random.default_rng(9)
    X = sparse.csr_matrix(rng.poisson(1.0, size=(60, 10)).astype(float))
    groups = np.where(rng.random(60) < 0.5, "sg^a", "sg^b")
    genes = [f"g{i}" for i in range(10)]
    j_ad = mt.AnnData(X, obs=pd.DataFrame({"memento_group": groups}),
                      var=pd.DataFrame(index=genes))
    t_ad = mtt.AnnData(X, obs={"memento_group": groups},
                       var=mtt.ColumnTable(index=genes))
    for group in ("sg^a", "sg^b"):
        got = t_util._select_cells(t_ad, group)
        assert got.format == "csc"
        _same(got.toarray(), j_util._select_cells(j_ad, group).toarray())
    _same(t_util._get_gene_idx(t_ad, ["g3", "g0", "g9"]),
          j_util._get_gene_idx(j_ad, ["g3", "g0", "g9"]))


@pytest.mark.parametrize("resampling", ["bootstrap", "permutation"])
def test_refine_flagged_matches_jax(resampling):
    """Flagged rows refined by the batched GEV fit: within 1e-12 of the JAX
    package's; unflagged rows untouched."""
    rng = np.random.default_rng(10)
    stat = rng.choice([0.0, 3.5, -4.0, 8.0, 12.0], size=(12, 2, 1))
    null = rng.standard_t(3, size=(12, 2, 800))
    # bootstrap replicates scatter around the observed statistic
    coef = np.concatenate(
        [stat, null + (stat if resampling == "bootstrap" else 0)], -1)
    pvals = ((np.abs(null) >= np.abs(stat)).sum(-1) + 1) / 801
    needs = pvals < 0.01
    assert needs.any() and not needs.all()
    got = t_asl.refine_flagged(coef, pvals, needs, resampling)
    want = j_asl.refine_flagged(coef, pvals, needs, resampling)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)
    _same(got[~needs], pvals[~needs])
    none = t_asl.refine_flagged(coef, pvals, np.zeros_like(needs), resampling)
    _same(none, pvals)
    assert none is not pvals


def _tables_equal(got, want):
    """A port ColumnTable against a pandas DataFrame (or two tables), as
    string values where the column holds strings."""
    assert list(got.columns) == list(want.columns)
    assert [str(x) for x in got.index] == [str(x) for x in want.index]
    for c in want.columns:
        w = np.asarray(want[c])
        g = np.asarray(got[c])
        if w.dtype.kind in "OUS" or g.dtype.kind in "OUS":
            assert [str(x) for x in g] == [str(x) for x in w], c
        else:
            np.testing.assert_array_equal(g, w, err_msg=c)


def _analysis(rng):
    X = sparse.csr_matrix(rng.poisson(1.0, size=(30, 8)).astype(np.float32))
    cond = np.array(["ctrl", "stim", "stim"] * 10)
    q = rng.random(30)
    flag = rng.random(30) < 0.5
    genes = [f"g{i}" for i in range(8)]
    result = {"gene": np.array(genes), "de_coef": rng.normal(size=8),
              "de_pval": rng.uniform(size=8)}
    uns = {"memento": {"all_q": 0.1, "groups": ["sg^ctrl", "sg^stim"],
                       "n_boot": 500, "arr": np.arange(6.0).reshape(2, 3),
                       "flags": np.array([True, False]),
                       "nested": {"s": "text", "names": np.array(["a", "b"])},
                       "cells": sparse.csc_matrix(X[:5])}}
    return X, cond, q, flag, genes, result, uns


def test_h5ad_jax_file_reads_in_the_port(tmp_path):
    rng = np.random.default_rng(11)
    X, cond, q, flag, genes, result, uns = _analysis(rng)
    obs = pd.DataFrame({"cond": pd.Categorical(cond), "q": q, "flag": flag,
                        "name": [f"c{i}" for i in range(30)]},
                       index=[f"cell{i}" for i in range(30)])
    uns["memento"]["1d_result"] = pd.DataFrame(result)
    j_ad = mt.AnnData(X, obs=obs, var=pd.DataFrame(index=genes), uns=uns)
    j_h5ad.write_h5ad(tmp_path / "j.h5ad", j_ad)
    got = t_h5ad.read_h5ad(tmp_path / "j.h5ad")
    want = j_h5ad.read_h5ad(tmp_path / "j.h5ad")
    _same(got.X.toarray(), X.toarray())
    assert got.X.format == "csr" and got.X.dtype == X.dtype
    _tables_equal(got.obs, want.obs)
    assert list(got.obs["cond"]) == list(cond)  # categorical: its values
    _tables_equal(got.var, want.var)
    gm, wm = got.uns["memento"], want.uns["memento"]
    assert sorted(gm) == sorted(wm)
    for key in ("all_q", "groups", "n_boot", "arr", "flags"):
        _same(gm[key], wm[key])
    assert gm["nested"]["s"] == "text"
    _same(gm["nested"]["names"], wm["nested"]["names"])
    assert gm["cells"].format == "csc"
    _same(gm["cells"].toarray(), wm["cells"].toarray())
    _tables_equal(gm["1d_result"], wm["1d_result"])


def test_h5ad_port_file_reads_in_jax(tmp_path):
    rng = np.random.default_rng(12)
    X, cond, q, flag, genes, result, uns = _analysis(rng)
    uns["memento"]["1d_result"] = mtt.ColumnTable(result)
    t_ad = mtt.AnnData(X, obs=mtt.ColumnTable(
        {"cond": cond, "q": q, "flag": flag},
        index=[f"cell{i}" for i in range(30)]),
        var=mtt.ColumnTable(index=genes), uns=uns)
    t_h5ad.write_h5ad(tmp_path / "t.h5ad", t_ad)
    want = j_h5ad.read_h5ad(tmp_path / "t.h5ad")
    back = t_h5ad.read_h5ad(tmp_path / "t.h5ad")
    # string columns are stored as categoricals (codes + categories)
    assert isinstance(want.obs["cond"].dtype, pd.CategoricalDtype)
    assert list(want.obs["cond"].cat.categories) == ["ctrl", "stim"]
    for table in (want, back):
        _same(table.X.toarray(), X.toarray())
        _tables_equal(table.obs, pd.DataFrame(
            {"cond": cond, "q": q, "flag": flag},
            index=[f"cell{i}" for i in range(30)]))
        assert [str(x) for x in table.var.index] == genes
        m = table.uns["memento"]
        _same(m["arr"], uns["memento"]["arr"])
        assert list(m["groups"]) == ["sg^ctrl", "sg^stim"]
        assert m["all_q"] == 0.1 and m["n_boot"] == 500
        _tables_equal(m["1d_result"], pd.DataFrame(result))
    # dense X, and what h5ad cannot hold is dropped with a warning
    t_ad.X = X.toarray()
    t_ad.uns["memento"]["fn"] = len
    with pytest.warns(UserWarning, match="dropped"):
        t_h5ad.write_h5ad(tmp_path / "d.h5ad", t_ad)
    _same(j_h5ad.read_h5ad(tmp_path / "d.h5ad").X, X.toarray())
    assert "fn" not in t_h5ad.read_h5ad(tmp_path / "d.h5ad").uns["memento"]


def test_port_imports_without_h5py():
    """h5py is imported inside the functions: the package, and the module,
    import where it is absent (as on the card's machine)."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'h5py':\n"
        "            raise ImportError('h5py blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import memento_tpu_torch, memento_tpu_torch.io.h5ad as h\n"
        "memento_tpu_torch.util._fdrcorrect\n"
        "memento_tpu_torch.simulate.simulate_two_groups\n"
        "try:\n"
        "    h.read_h5ad('x.h5ad')\n"
        "except ImportError as e:\n"
        "    print('refused:', e)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "refused: h5py blocked" in proc.stdout
