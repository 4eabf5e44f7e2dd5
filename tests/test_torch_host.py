"""The port's host numerics, containers, seeds and isolation.

Host stages of ``memento_tpu_torch`` are numpy/scipy in float64 and must equal
the JAX package's functions to float64 rounding (compression exactly).  The
package itself must import neither JAX, ``memento_tpu`` nor pandas.
"""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sparse
import torch

from memento_tpu.ops import compress as j_compress
from memento_tpu.ops import estimators as j_est
from memento_tpu.ops import mv_regression as j_mv
from memento_tpu.ops import size_factor as j_sf

from memento_tpu_torch import AnnData, ColumnTable
from memento_tpu_torch.convert import from_jax_outputs
from memento_tpu_torch.device import fold_seed, generator, resolve_device
from memento_tpu_torch.ops import compress as t_compress
from memento_tpu_torch.ops import estimators as t_est
from memento_tpu_torch.ops import mv_regression as t_mv
from memento_tpu_torch.ops import size_factor as t_sf

# tier-1 runs several pytest workers at once: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "memento_tpu_torch"


def _counts(rng, n=400, g=24):
    lam = rng.gamma(2.0, rng.uniform(0.1, 4.0, g) / 2.0, size=(n, g))
    X = rng.poisson(lam).astype(np.float64)
    X[:, 3] = 0.0  # an all-zero gene
    return sparse.csr_matrix(X)


@pytest.mark.parametrize("estimator", ["hyper_relative", "poi_relative",
                                       "hyper_absolute", "mean_only"])
def test_mean_var_sparse_matches_jax(rng, estimator):
    X = _counts(rng)
    sf = rng.uniform(0.5, 2.0, X.shape[0])
    want = j_est.mean_var_sparse(X, sf, 0.1, estimator)
    got = t_est.mean_var_sparse(X, sf, 0.1, estimator)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)


def test_suffstats_and_moments_match_jax(rng):
    X = _counts(rng)
    sf = rng.uniform(0.5, 2.0, X.shape[0])
    for w, g in zip(j_est.suffstats_sparse(X.tocsc(), sf),
                    t_est.suffstats_sparse(X, sf)):
        np.testing.assert_allclose(g, w, rtol=1e-12)
    s = t_est.suffstats_sparse(X, sf)
    for model in ("hyper_relative", "mean_only"):
        want = j_est.mean_var_from_suffstats(*s, X.shape[0], 0.2,
                                             j_est.get_noise_model(model))
        got = t_est.mean_var_from_suffstats(*s, X.shape[0], 0.2,
                                            t_est.get_noise_model(model))
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, rtol=1e-12)
    with pytest.raises(ValueError):
        t_est.get_noise_model("no_such_model")


def test_size_factor_matches_jax(rng):
    X = _counts(rng)
    mask = rng.random(X.shape[1]) > 0.5
    np.testing.assert_allclose(
        t_sf.estimate_size_factor(X, total=True, shrinkage=0.0),
        j_sf.estimate_size_factor(X, total=True, shrinkage=0.0), rtol=1e-12)
    np.testing.assert_allclose(
        t_sf.estimate_size_factor(X, mask=mask, shrinkage=0.5),
        j_sf.estimate_size_factor(X, mask=mask, shrinkage=0.5), rtol=1e-12)
    np.testing.assert_array_equal(
        t_sf.estimate_size_factor(X, "hyper_absolute", total=True),
        np.ones(X.shape[0]))
    with pytest.raises(ValueError):
        t_sf.estimate_size_factor(X)
    sf = rng.random(X.shape[0]) * 3 + 0.1
    approx = t_sf.bin_size_factor(sf, num_bins=30)
    np.testing.assert_allclose(approx, j_sf.bin_size_factor(sf, num_bins=30),
                               rtol=1e-12)
    for w, g in zip(j_sf.factorize_approx_sf(approx),
                    t_sf.factorize_approx_sf(approx)):
        np.testing.assert_array_equal(g, w)


def test_fit_mv_regressor_matches_jax(rng):
    m = np.exp(rng.normal(0, 1, 200))
    v = m * (1 + 0.3 * m) * np.exp(rng.normal(0, 0.2, 200))
    m[:5] = 0.0
    v[5:8] = -1.0
    np.testing.assert_allclose(t_mv.fit_mv_regressor(m, v),
                               j_mv.fit_mv_regressor(m, v), rtol=1e-12)
    np.testing.assert_array_equal(t_mv.fit_mv_regressor(m[:2], v[:2]),
                                  np.zeros(3))


def test_residual_variance_matches_jax(rng):
    import jax.numpy as jnp

    mean = rng.gamma(2.0, 1.0, (3, 7, 50)).astype(np.float32)
    var = rng.gamma(2.0, 2.0, (3, 7, 50)).astype(np.float32)
    mean[0, 0, :5] = 0.0
    var[1, 2, :5] = -1.0
    coeffs = rng.normal(0, 0.3, (3, 1, 3)).astype(np.float32)
    want = np.asarray(j_mv.residual_variance(jnp.asarray(mean),
                                             jnp.asarray(var),
                                             jnp.asarray(coeffs)))
    got = t_mv.residual_variance(torch.tensor(mean), torch.tensor(var),
                                 torch.tensor(coeffs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                               equal_nan=True)
    assert np.isnan(got[0, 0, :5]).all() and np.isnan(got[1, 2, :5]).all()


GROUP_FIELDS = ("values", "counts", "n_unique", "sf_bin", "bin_inv_sf",
                "inv_sf", "inv_sf_sq")


@pytest.mark.parametrize("cols", [None, (5, 17)])
def test_compress_group_exact(rng, cols):
    X = _counts(rng, n=500, g=30)
    X.data[::7] = 41.0  # values above the int8 range of some codes
    approx = j_sf.bin_size_factor(rng.uniform(0.4, 2.5, X.shape[0]), 30)
    want = j_compress.compress_group(X.tocsc(), approx, backend="numpy",
                                     cols=cols)
    got = t_compress.compress_group(X.tocsc(), approx, backend="numpy",
                                    cols=cols)
    for field in GROUP_FIELDS:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert got.n_obs == want.n_obs and got.padded_u == want.padded_u
    dense = t_compress.compress_group(X.toarray(), approx, backend="numpy",
                                      cols=cols)
    np.testing.assert_array_equal(dense.counts, got.counts)


@pytest.mark.parametrize("cols", [None, (5, 17)])
def test_compress_group_native_default_exact(rng, cols):
    """The port's default (native) packer equals the JAX package's native
    packer field for field, on CSC (zero-copy range path) and dense input."""
    X = _counts(rng, n=500, g=30)
    X.data[::7] = 41.0
    approx = j_sf.bin_size_factor(rng.uniform(0.4, 2.5, X.shape[0]), 30)
    want = j_compress.compress_group(X.tocsc(), approx, backend="native",
                                     cols=cols)
    got = t_compress.compress_group(X.tocsc(), approx, cols=cols)
    for field in GROUP_FIELDS:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert got.n_obs == want.n_obs and got.padded_u == want.padded_u
    dense = t_compress.compress_group(X.toarray(), approx, cols=cols)
    np.testing.assert_array_equal(dense.counts, got.counts)


def test_convert_from_jax_outputs(rng):
    X = _counts(rng, n=300, g=10)
    approx = j_sf.bin_size_factor(rng.uniform(0.5, 2.0, 300), 30)
    comps = [j_compress.compress_group(X.tocsc(), approx, backend="numpy")]
    uns = {
        "size_factor": {"sg^a": np.arange(3.0)},
        "approx_size_factor": {"sg^a": approx},
        "1d_moments": {"sg^a": [np.ones(10), np.full(10, 2.0),
                                np.full(10, 3.0)]},
        "mv_regressor": {"sg^a": np.array([0.1, 1.0, 0.0]),
                         "all": np.array([0.1, 1.0, 0.0])},
        "groups": ["sg^a"],
    }
    out = from_jax_outputs(compressed=comps, memento_uns=uns)
    got = out["compressed"][0]
    assert isinstance(got, t_compress.CompressedGroup)
    for field in ("values", "counts", "n_unique", "sf_bin", "bin_inv_sf",
                  "inv_sf"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(comps[0], field))
    np.testing.assert_array_equal(out["approx_size_factor"]["sg^a"], approx)
    assert len(out["1d_moments"]["sg^a"]) == 3
    assert set(out["mv_regressor"]) == {"sg^a", "all"}
    assert "groups" not in out


def test_fold_seed_is_a_pure_function_of_coordinates():
    a = fold_seed(0, 128, 1, 0)
    assert a == fold_seed(0, 128, 1, 0)
    assert 0 <= a < 2**64
    seen = {fold_seed(s, start, stage, grp)
            for s in range(3) for start in (0, 64, 128)
            for stage in range(3) for grp in range(4)}
    assert len(seen) == 3 * 3 * 3 * 4
    assert fold_seed(0, 1, 2) != fold_seed(0, 2, 1)
    x = torch.rand(5, generator=generator(a, "cpu"))
    y = torch.rand(5, generator=generator(a, "cpu"))
    assert torch.equal(x, y)


def test_resolve_device_never_falls_back():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for request in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(request)


def test_column_table_and_anndata():
    df = pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", "z"]},
                      index=["c0", "c1", "c2"])
    t = ColumnTable(df)  # duck-typed DataFrame
    assert t.columns == ["a", "b"] and list(t.index) == ["c0", "c1", "c2"]
    np.testing.assert_array_equal(t["a"], [1, 2, 3])
    t["c"] = 1.5
    assert t.shape == (3, 3)
    sub = t.take(np.array([True, False, True]))
    assert list(sub.index) == ["c0", "c2"] and list(sub["b"]) == ["x", "z"]
    np.testing.assert_array_equal(
        ColumnTable({"p": [1.0, 0.0], "q": [0.0, 1.0]}).values, np.eye(2))
    with pytest.raises(ValueError):
        t["d"] = [1, 2]

    ad = AnnData(sparse.random(3, 4, density=0.5, format="csr"), obs=df)
    assert list(ad.var.index) == ["gene_0", "gene_1", "gene_2", "gene_3"]
    cp = ad.copy()
    cp._inplace_subset_var(np.array([True, False, True, False]))
    assert cp.shape == (3, 2) and ad.shape == (3, 4)
    assert list(cp.var.index) == ["gene_0", "gene_2"]
    with pytest.raises(ValueError):
        AnnData(np.zeros((2, 2)), obs={"a": np.arange(3)})


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax_nor_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    bad = []
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "memento_tpu", "pandas"):
                bad.append(f"{f.relative_to(REPO)}: {name}")
    assert not bad, bad


ISOLATED = textwrap.dedent("""
    import os
    import sys
    for name in ("jax", "jaxlib", "memento_tpu", "pandas"):
        sys.modules[name] = None  # any import of these now raises
    import numpy as np
    import scipy.sparse as sparse
    import memento_tpu_torch as mtt

    rng = np.random.default_rng(3)
    base = np.exp(rng.uniform(np.log(0.5), np.log(4.0), 24))
    blocks, cond, rep = [], [], []
    for c in range(2):
        for r in range(2):
            mu = base * (np.r_[np.full(4, 1.8), np.ones(20)] if c else 1.0)
            blocks.append(rng.poisson(rng.gamma(2.0, mu / 2.0, (150, 24))))
            cond += [str(c)] * 150
            rep += [str(r)] * 150
    ad = mtt.AnnData(sparse.csr_matrix(np.vstack(blocks).astype(float)),
                     obs={"condition": np.array(cond),
                          "replicate": np.array(rep),
                          "capture_q": np.full(600, 0.1)})
    mtt.setup_memento(ad, q_column="capture_q", filter_mean_thresh=0.01)
    mtt.create_groups(ad, label_columns=["condition", "replicate"])
    mtt.compute_1d_moments(ad, min_perc_group=0.5)
    groups = mtt.get_groups(ad)
    mtt.ht_1d_moments(ad, covariate=np.ones((len(groups), 1)),
                      treatment=groups["condition"][:, None].astype(float),
                      num_boot=64, approx=True, tile_size=64, device="cpu",
                      verbose=0)
    res = mtt.get_1d_ht_result(ad)
    mean_df, var_df, counts = mtt.get_1d_moments(ad)
    assert res.columns == ["gene", "tx", "de_coef", "de_se", "de_pval",
                           "dv_coef", "dv_se", "dv_pval"]
    assert np.isfinite(res["de_coef"]).all(), res["de_coef"]
    genes = list(ad.var.index)
    mtt.compute_2d_moments(ad, [(genes[0], genes[1]), (genes[2], genes[5]),
                                (genes[1], genes[0])])
    mtt.ht_2d_moments(ad, covariate=np.ones((len(groups), 1)),
                      treatment=groups["condition"][:, None].astype(float),
                      num_boot=64, approx=True, device="cpu", verbose=0)
    res2 = mtt.get_2d_ht_result(ad)
    corr_df, _ = mtt.get_2d_moments(ad)
    assert res2.columns == ["gene_1", "gene_2", "corr_coef", "corr_se",
                            "corr_pval"]
    assert np.isfinite(res2["corr_coef"]).all(), res2["corr_coef"]
    assert res2["corr_coef"][0] == res2["corr_coef"][2]
    mat = mtt.get_corr_matrix(ad, groups.index[0], device="cpu")
    assert mat.shape == (len(genes), len(genes))
    assert abs(mat[0, 1] - corr_df[groups.index[0]][0]) < 1e-4

    # the options: the exact sampler, eQTL mode, a checkpointed run, and a
    # custom estimator tuple (observed moments from its sparse branch)
    import tempfile
    from memento_tpu_torch.ops import bootstrap
    tx = groups["condition"][:, None].astype(float)
    kw = dict(covariate=np.ones((len(groups), 1)), num_boot=64, approx=True,
              tile_size=64, device="cpu", verbose=0)
    mtt.ht_1d_moments(ad, treatment=tx, sampler="multinomial", **kw)
    exact = mtt.get_1d_ht_result(ad)
    np.testing.assert_allclose(exact["de_coef"], res["de_coef"], rtol=1e-6)
    two = np.column_stack([tx[:, 0], groups["replicate"].astype(float)])
    tfg = {g: [0] if i % 2 else [0, 1] for i, g in enumerate(genes)}
    mtt.ht_1d_moments(ad, treatment=two, treatment_for_gene=tfg, **kw)
    eqtl = mtt.get_1d_ht_result(ad)
    assert len(eqtl["gene"]) == sum(len(v) for v in tfg.values())
    with tempfile.TemporaryDirectory() as ckpt:
        mtt.ht_1d_moments(ad, treatment=tx, checkpoint_dir=ckpt,
                          checkpoint_block=8, **kw)
        assert len(os.listdir(ckpt)) == -(-len(genes) // 8)
    assert np.isfinite(mtt.get_1d_ht_result(ad)["de_coef"]).all()

    def hyper(data, n_obs, q, size_factor=None):
        if isinstance(data, tuple):
            m1 = (data[0] * data[1] * size_factor[0]).sum(axis=0) / n_obs
            m2 = (data[0] ** 2 * data[1] * size_factor[1] - (1 - q)
                  * data[0] * data[1] * size_factor[1]).sum(axis=0) / n_obs
            return [m1, m2 - m1 * m1]
        w = (1.0 / size_factor).reshape(1, -1)
        m1 = np.asarray(w @ data).ravel() / n_obs
        m2 = (np.asarray(w**2 @ data.power(2)).ravel()
              - (1 - q) * np.asarray(w**2 @ data).ravel()) / n_obs
        return [m1, m2 - m1 * m1]

    cust = mtt.AnnData(ad.X.copy(), obs={k: ad.obs[k] for k in ad.obs.columns})
    mtt.setup_memento(cust, q_column="capture_q", filter_mean_thresh=0.01,
                      estimator_type=(hyper, None))
    mtt.create_groups(cust, label_columns=["condition", "replicate"])
    mtt.compute_1d_moments(cust, min_perc_group=0.5)
    mtt.ht_1d_moments(cust, treatment=tx, **kw)
    assert bootstrap.CUSTOM_PATHS["device"] == len(groups)
    assert np.isfinite(mtt.get_1d_ht_result(cust)["de_coef"]).all()

    # the observability layer: the profiler, the phase readers, the cost
    # model
    import torch
    from memento_tpu_torch.utils import profiling, roofline
    with tempfile.TemporaryDirectory() as logdir:
        with profiling.device_trace(logdir, device="cpu") as prof:
            with profiling.phase("isolated.phase"):
                total = profiling.sync_pull({"x": [torch.ones(3)]})
        assert total == 3.0 and prof is not None
        assert os.path.exists(os.path.join(logdir, profiling.TRACE_FILE))
    assert "isolated.phase" in profiling.report()
    assert profiling.steady_state(1.0, "ht1d", 10)["steady_s"] > 0
    roof = roofline.roofline(np.full((8, 12), 3.0, np.float32), 16, 1e-3, 2)
    assert roof["limiting_resource"] in ("fp32", "hbm")
    loaded = [m for m in sys.modules if sys.modules[m] is not None
              and m.split(".")[0] in ("jax", "jaxlib", "memento_tpu",
                                      "pandas")]
    assert not loaded, loaded
    print("ISOLATED_OK", len(res))
""")


def test_port_runs_with_jax_and_pandas_blocked():
    env = dict(os.environ, OMP_NUM_THREADS="1")  # see set_num_threads above
    proc = subprocess.run([sys.executable, "-c", ISOLATED], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED_OK" in proc.stdout
