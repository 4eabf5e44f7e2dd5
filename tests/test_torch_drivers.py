"""The port's scale drivers (``memento_tpu_torch/drivers/``) against the JAX
package's scripts, and the tile loop's first-use warm-up.

- Each generator of ``drivers/_data.py`` equals the JAX script's, bit for
  bit at the same seed: the script's function imported from its file (its
  ``main`` does not run), or, where the script draws inline in ``main``, its
  own lines of code run on the same inputs.
- Each driver's ``main`` runs with ``--device cpu`` at a small size and
  prints a last JSON line with the contract's keys; without ``--device
  cpu`` it raises here (no CUDA).
- On the same generated data the drivers' paths equal the JAX package run
  as its own tests run it on the CPU: observed moments rtol 1e-12,
  coefficients rtol 1e-5 / atol 1e-6, the correlation matrix atol 1e-5;
  p-values in distribution only (null median in [0.3, 0.7]).
- The warm-up (``inference/ht.py::_warm_up``): results equal a second call
  bit for bit, the real-launch counter counts the tiles only, a failing
  warm-up raises.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sparse
import torch

import memento_tpu as mt
from memento_tpu.inference.ht import run_ht_1d as j_run_ht_1d
from memento_tpu.ops.corr import corr_matrix_device as j_corr_matrix_device
from memento_tpu.ops.estimators import get_noise_model as j_noise_model

from memento_tpu_torch.device import is_warming
from memento_tpu_torch.drivers import (_data, bench, corr_north_star,
                                       eqtl_north_star, kernel_bench,
                                       north_star, north_star_2d)
from memento_tpu_torch.inference import ht as t_ht
from memento_tpu_torch.ops import bootstrap as t_boot
from memento_tpu_torch.ops import cuda_kernels, sampling

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
N_CELLS, N_GENES = 2000, 200
B = 200


def _script(relpath: str):
    """A JAX driver script loaded from its file as a module (its ``main``
    is not run)."""
    path = REPO / relpath
    name = "_jax_" + path.stem
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _snippet(relpath: str, first: str, last: str, **names) -> dict:
    """Run the lines of a JAX script from the one holding ``first`` to the
    statement holding ``last`` on ``names``; returns their namespace."""
    lines = (REPO / relpath).read_text().splitlines()
    a = next(i for i, line in enumerate(lines) if first in line)
    b = next(i for i in range(a, len(lines)) if last in lines[i])
    while True:
        src = textwrap.dedent("\n".join(lines[a:b + 1]))
        try:
            code = compile(src, relpath, "exec")
            break
        except SyntaxError:
            b += 1
    ns = {"np": np, **names}
    exec(code, ns)  # noqa: S102 - the JAX script's own lines
    return ns


def _equal_csr(a, b):
    a, b = sparse.csr_matrix(a), sparse.csr_matrix(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.data, b.data)


# --------------------------------------------------------------------------
# generators, bit for bit


@pytest.fixture(scope="module")
def ns_counts():
    return _data.north_star_simulate(N_CELLS, N_GENES, verbose=False)


def test_north_star_simulate_equals_jax(ns_counts):
    jax_ns = _script("examples/north_star.py")
    _equal_csr(ns_counts, jax_ns.simulate(N_CELLS, N_GENES))
    _equal_csr(_data.north_star_simulate(1500, 30, q=0.2, seed=4,
                                         verbose=False),
               jax_ns.simulate(1500, 30, q=0.2, seed=4))


def test_bench_simulate_equals_jax():
    jax_bench = _script("bench.py")
    for n, g, seed in ((25_000, 16, 0), (3000, 40, 3)):
        _equal_csr(_data.bench_simulate(n, g, seed=seed),
                   jax_bench.simulate(n, g, seed=seed))


def test_bench_pairs_equal_jax():
    for n_genes, n_pairs in ((1024, 512), (37, 90)):
        ns = _snippet("bench.py", "rng = np.random.default_rng(7)",
                      "idx2 = (idx1 + 1", N_GENES=n_genes, N_PAIRS=n_pairs)
        idx1, idx2 = _data.bench_pairs(n_genes, n_pairs)
        assert np.array_equal(idx1, ns["idx1"])
        assert np.array_equal(idx2, ns["idx2"])
        assert (idx1 != idx2).all()


def test_top_expressed_pairs_equal_jax(ns_counts):
    for n_pairs, n_top in ((300, 4000), (50, 4000)):
        ns = _snippet("examples/north_star_2d.py",
                      "expr = np.asarray(adata.X.sum(axis=0)).ravel()",
                      "i1, i2 = top[p1], top[p2]",
                      adata=types.SimpleNamespace(X=ns_counts),
                      N_PAIRS=n_pairs)
        i1, i2 = _data.top_expressed_pairs(ns_counts, n_pairs, n_top)
        assert np.array_equal(i1, ns["i1"]) and np.array_equal(i2, ns["i2"])


@pytest.mark.parametrize("script,genes_name", [
    ("examples/eqtl_north_star.py", "g"), ("bench.py", "EQTL_GENES")])
def test_eqtl_design_equals_jax(script, genes_name):
    for n_genes, kt in ((64, 8), (33, 3)):
        ns = _snippet(script, "rng = np.random.default_rng(11)",
                      "tens[i, :, : nt[i]] = rng.integers(0, 3, (2, nt[i]))",
                      **{genes_name: n_genes, "EQTL_KT": kt})
        nt, tens = _data.eqtl_design(n_genes, kt)
        assert np.array_equal(nt, ns["nt"])
        assert np.array_equal(tens, ns["tens"]) and tens.shape == (n_genes,
                                                                    2, kt)


def test_kernel_counts_equal_jax():
    jax_kb = _script("examples/kernel_bench.py")
    n = 50_000
    want = jax_kb.ragged_counts(np.random.default_rng(2), 64, 96, n)
    got = _data.kernel_counts(np.random.default_rng(2), 64, 96, True, n)
    assert np.array_equal(got, want)
    ns = _snippet("examples/kernel_bench.py",
                  "counts = rng.integers(1, 40, size=(t_dim, u_dim))",
                  "counts[:, 0] += n - counts.sum(1)",
                  rng=np.random.default_rng(3), t_dim=32, u_dim=48, n=n)
    got = _data.kernel_counts(np.random.default_rng(3), 32, 48, False, n)
    assert np.array_equal(got, ns["counts"])
    assert np.allclose(got.sum(1), n) and (got >= 0).all()


def test_north_star_device_law(ns_counts):
    """The chunked torch generator: a valid CSR of float32 counts, the same
    for the same seed, with the numpy generator's law (per-gene mean q*base
    and variance q*base + q^2 base^2 / 2, within 6 standard errors)."""
    n, g, q = 40_000, 12, 0.1
    X = _data.north_star_device(n, g, q=q, seed=5, device="cpu",
                                chunk=7_000)
    again = _data.north_star_device(n, g, q=q, seed=5, device="cpu",
                                    chunk=7_000)
    _equal_csr(X, again)
    assert X.dtype == np.float32 and X.has_canonical_format
    assert X.shape == (n, g) and (X.data > 0).all()
    base = np.exp(np.random.default_rng(5).uniform(np.log(0.05),
                                                   np.log(3.0), g))
    dense = X.toarray().astype(np.float64)
    mean = q * base
    var = q * base + q * q * base * base / 2.0
    se = np.sqrt(var / n)
    assert (np.abs(dense.mean(0) - mean) < 6 * se).all()
    # the variance's standard error from the fourth moment, bounded by 5x
    assert (np.abs(dense.var(0) / var - 1.0) < 6 * np.sqrt(5.0 / n)
            * np.sqrt(1 + 1 / var)).all()
    other = _data.north_star_device(n, g, q=q, seed=6, device="cpu")
    assert not np.array_equal(other.toarray(), dense)


def test_load_or_simulate_cache(tmp_path):
    cache = str(tmp_path / "sub" / "ns.npz")
    first = _data.load_or_simulate(cache, 300, 20)
    assert os.path.exists(cache)
    _equal_csr(_data.load_or_simulate(cache, 300, 20), first)
    with pytest.raises(ValueError):
        _data.load_or_simulate(cache, 300, 21)
    _equal_csr(_data.load_or_simulate("", 300, 20), first)


# --------------------------------------------------------------------------
# each driver's main on the CPU

SMALL = {
    "NS_CELLS": "2000", "NS_GENES": "200", "NS_BOOT": "120",
    "NS_PAIRS": "30", "NS_TILE": "64", "EQTL_GENES": "24", "EQTL_BOOT": "120",
    "EQTL_KT": "3", "EQTL_TILE": "16", "CORR_BLOCK": "512",
    "CORR_ROW_BLOCK": "64", "KB_ROWS": "8", "KB_BINS": "24",
    "KB_BINS_HEAD": "16", "KB_BOOT": "40", "KB_BOOT_HEAD": "24",
    "KB_REPS": "1", "BENCH_CELLS": "2000", "BENCH_GENES": "64",
    "BENCH_BOOT": "80", "BENCH_TILE": "32", "BENCH_REPS": "1",
    "BENCH_B10K_GENES": "16", "BENCH_B10K_BOOT": "150", "BENCH_PAIRS": "20",
    "BENCH_CORR_CELLS": "500", "BENCH_EQTL_GENES": "16",
    "BENCH_EQTL_BOOT": "100", "BENCH_EQTL_KT": "3",
}
RESOURCE_KEYS = {"peak_device_gib", "peak_host_rss_gib", "cascade_launches",
                 "card"}
DRIVER_KEYS = {
    north_star: {"config", "phases_s", "ht_genes_per_s", "ht_oneoff_s",
                 "ht_steady_genes_per_s", "finite_pval_frac"},
    north_star_2d: {"config", "phases_s", "ht_pairs_per_s", "ht_oneoff_s",
                    "ht_steady_pairs_per_s", "finite_pval_frac"},
    corr_north_star: {"config", "phases_s", "corr_total_s", "finite_frac"},
    eqtl_north_star: {"config", "tests_per_s", "oneoff_s",
                      "steady_tests_per_s", "finite_pval_frac"},
    bench: {"metric", "value", "unit", "median_value", "extra"},
    kernel_bench: {"config", "tiles"},
}


@pytest.fixture
def small_env(monkeypatch, tmp_path):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(kernel_bench, "MULTINOMIAL_CALLS",
                        (("1d", 6, 300, 2), ("2d", 4, 60, 5)))
    monkeypatch.setenv("NS_CACHE", str(tmp_path / "ns.npz"))
    return tmp_path


@pytest.mark.parametrize("driver", list(DRIVER_KEYS),
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_driver_main_on_cpu(driver, small_env, capsys):
    assert driver.main(["--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(last)
    assert DRIVER_KEYS[driver] | RESOURCE_KEYS <= set(out), set(out)
    assert out["device"] == "cpu" and out["card"] is None
    assert out["peak_device_gib"] is None and out["cascade_launches"] == 0
    assert out["peak_host_rss_gib"] > 0
    if "finite_pval_frac" in out:
        assert out["finite_pval_frac"] >= 0.9
    if driver is kernel_bench:
        assert [(t["W"], t["kind"]) for t in out["tiles"]] == [
            (2, "dense"), (5, "dense")] * 2 + [(2, "ragged"), (5, "ragged")]
        for t in out["tiles"]:
            assert t["bound_ms"] > 0 and t["bound_by"] in ("operations",
                                                           "bytes")
            assert t["library_ms"] is None and t["plain_ms"] > 0
        assert [(t["kind"], t["W"]) for t in out["multinomial"]] == [
            ("1d", 2), ("2d", 5)]
        for t in out["multinomial"]:
            assert t["ms"] > 0 and t["chain_ms"] > 0 and t["launches"] == 0
            assert t["bound_ms"] > 0 and t["bound_by"] == "operations"
    if driver is corr_north_star:
        assert out["finite_frac"] >= 0.95  # NaN: genes with no variance
        assert out["phases_s"]["gram_stream"] >= out["phases_s"]["upload"]


@pytest.mark.parametrize("driver", [north_star, eqtl_north_star],
                         ids=["north_star", "eqtl_north_star"])
def test_driver_draws_on_the_device(driver, small_env, monkeypatch, capsys):
    """``NS_DRAW=device``: the counts of ``_data.north_star_device``."""
    monkeypatch.setenv("NS_DRAW", "device")
    monkeypatch.setenv("NS_CACHE", "")
    assert driver.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["finite_pval_frac"] >= 0.9 and out["cascade_launches"] == 0
    monkeypatch.setenv("NS_DRAW", "gpu")
    with pytest.raises(ValueError, match="draw"):
        north_star.main(["--device", "cpu"])


@pytest.mark.parametrize("driver", list(DRIVER_KEYS),
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_driver_refuses_without_cuda(driver, small_env):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main([])


def test_drivers_import_no_jax_nor_pandas():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "memento_tpu", "pandas"):
            sys.modules[name] = None
        from memento_tpu_torch.drivers import (_data, _report, bench,
            corr_north_star, eqtl_north_star, kernel_bench, north_star,
            north_star_2d)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# --------------------------------------------------------------------------
# the drivers' paths against the JAX package on the same data


def _jax_prepare(X):
    """``examples/north_star.py``'s API sequence in the JAX package."""
    n = X.shape[0]
    cond = (np.arange(n) >= n // 2).astype(int)
    obs = pd.DataFrame({"condition": cond.astype(str),
                        "capture_q": np.full(n, 0.1)})
    adata = mt.AnnData(X.copy(), obs=obs)
    mt.setup_memento(adata, q_column="capture_q", filter_mean_thresh=0.0,
                     trim_percent=0.1)
    mt.create_groups(adata, label_columns=["condition"])
    mt.compute_1d_moments(adata, min_perc_group=0.0)
    return adata


def _jax_design(adata):
    groups = mt.get_groups(adata)
    covariate = pd.DataFrame(np.ones((len(groups), 1)), index=groups.index)
    treatment = pd.DataFrame(
        {"tx": groups["condition"].astype(int).values}, index=groups.index)
    return covariate, treatment


@pytest.fixture(scope="module")
def paths(ns_counts):
    """Both packages through the 1D and then the 2D driver path."""
    jax_ad = _jax_prepare(ns_counts)
    covariate, treatment = _jax_design(jax_ad)
    mt.ht_1d_moments(jax_ad, covariate=covariate, treatment=treatment,
                     num_boot=B, resampling="bootstrap", tile_size=64,
                     verbose=0)
    jax_1d = mt.get_1d_ht_result(jax_ad)

    phases = {}
    port_ad = north_star.prepare(ns_counts.copy(), phases)
    port_1d, steady = north_star.run_1d(port_ad, B, 64, "cpu", phases,
                                        verbose=0)

    n_pairs = 40
    i1, i2 = _data.top_expressed_pairs(jax_ad.X, n_pairs)
    names = np.asarray(jax_ad.var.index)
    mt.compute_2d_moments(jax_ad, list(zip(names[i1], names[i2])))
    mt.ht_2d_moments(jax_ad, covariate=covariate, treatment=treatment,
                     num_boot=B, resampling="bootstrap", verbose=0)
    jax_2d = mt.get_2d_ht_result(jax_ad)
    port_2d, steady_2d = north_star_2d.run_2d(port_ad, n_pairs, B, None,
                                              "cpu", phases, verbose=0)
    return {"jax_ad": jax_ad, "port_ad": port_ad, "jax_1d": jax_1d,
            "port_1d": port_1d, "jax_2d": jax_2d, "port_2d": port_2d,
            "phases": phases, "steady": (steady, steady_2d)}


def _col(table, name):
    return np.asarray(table[name], dtype=np.float64)


def test_north_star_path_matches_jax(paths):
    ju = paths["jax_ad"].uns["memento"]
    pu = paths["port_ad"].uns["memento"]
    assert pu["groups"] == ju["groups"] and pu["gene_list"] == ju["gene_list"]
    assert len(pu["gene_list"]) == N_GENES  # every gene tested
    for g in ju["groups"]:
        for a, b in zip(pu["1d_moments"][g], ju["1d_moments"][g]):
            np.testing.assert_allclose(a, b, rtol=1e-12, equal_nan=True)
    got, want = paths["port_1d"], paths["jax_1d"]
    assert list(got["gene"]) == list(want["gene"])
    for col in ("de_coef", "dv_coef"):
        np.testing.assert_allclose(_col(got, col), _col(want, col),
                                   rtol=1e-5, atol=1e-6, equal_nan=True)
    for table in (got, want):  # a null design: p-values in distribution
        for col in ("de_pval", "dv_pval"):
            assert 0.3 <= np.nanmedian(_col(table, col)) <= 0.7
    assert set(paths["phases"]) >= {"setup", "moments_1d", "ht_1d",
                                    "moments_2d", "ht_2d"}
    steady = paths["steady"][0]
    assert steady["oneoff_s"] >= 0 and steady["steady_items_per_s"] > 0


def test_north_star_2d_path_matches_jax(paths):
    ju = paths["jax_ad"].uns["memento"]["2d_moments"]
    pu = paths["port_ad"].uns["memento"]["2d_moments"]
    assert np.array_equal(pu["gene_idx_1"], ju["gene_idx_1"])
    assert np.array_equal(pu["gene_idx_2"], ju["gene_idx_2"])
    for g in paths["jax_ad"].uns["memento"]["groups"]:
        for key in ("cov", "corr"):
            np.testing.assert_allclose(pu[g][key], ju[g][key], rtol=1e-12,
                                       atol=1e-15)
    got, want = paths["port_2d"], paths["jax_2d"]
    assert list(got["gene_1"]) == list(want["gene_1"])
    np.testing.assert_allclose(_col(got, "corr_coef"), _col(want, "corr_coef"),
                               rtol=1e-5, atol=1e-6, equal_nan=True)
    for table in (got, want):
        assert 0.3 <= np.nanmedian(_col(table, "corr_pval")) <= 0.7


def test_corr_path_matches_jax(ns_counts):
    """The corr driver's path (its size factors and variances, then
    ``corr_matrix_device`` in row blocks) against the JAX engine."""
    Xg = ns_counts[: N_CELLS // 2].tocsr()
    sf, var = corr_north_star.group_inputs(Xg)
    mat, phases = corr_north_star.run_corr(Xg, sf, var, 256, 64, "cpu")
    want = j_corr_matrix_device(Xg, sf, 0.1, var,
                                j_noise_model("hyper_relative"), block=256,
                                row_block=64, out_dtype=np.float32)
    assert mat.dtype == np.float32 and mat.shape == (N_GENES, N_GENES)
    assert np.array_equal(np.isnan(mat), np.isnan(want))
    np.testing.assert_allclose(mat, want, atol=1e-5, equal_nan=True)
    assert np.isnan(mat[var <= 0]).all() and np.isfinite(mat).mean() > 0.9
    assert phases["gram_stream"] >= phases["upload"] > 0
    assert phases["gather_finish"] >= phases["gather_only"] > 0


def test_eqtl_path_matches_jax(ns_counts):
    X = ns_counts[:, :40].tocsr()
    state = eqtl_north_star.prepare(X)
    nt, treatment = _data.eqtl_design(X.shape[1], 3)
    res, wall = eqtl_north_star.run_eqtl(state, treatment, B, 16, "cpu",
                                         verbose=False)
    want = j_run_ht_1d(
        key=jax.random.key(0), groups=state["groups"],
        approx_sf=state["approx_sf"], true_mean=state["true_mean"],
        true_res_var=state["true_res_var"], mv_coeffs=state["mv_coeffs"],
        q=np.full(2, 0.1), covariate=np.ones((2, 1)), treatment=treatment,
        num_boot=B, model=j_noise_model("hyper_relative"), sampler="auto",
        resampling="bootstrap", approx=False, boot_chunk=B, tile_size=16)
    valid = np.arange(3)[None, :] < nt[:, None]
    for key in ("mean_coef", "var_coef"):
        np.testing.assert_allclose(res[key][valid], np.asarray(want[key])[
            valid], rtol=1e-5, atol=1e-6, equal_nan=True)
    for out in (res, want):
        p = np.asarray(out["mean_pval"])[valid]
        assert np.isfinite(p).mean() >= 0.99
        assert 0.3 <= np.nanmedian(p) <= 0.7
    # the setup equals the JAX driver's, from its own lines
    ns = _snippet("examples/eqtl_north_star.py", "q = 0.1",
                  "for r in range(2)])",
                  X=X, g=X.shape[1], n=X.shape[0],
                  get_noise_model=j_noise_model,
                  **_jax_setup_names())
    for a, b in ((state["true_mean"], ns["tm"]),
                 (state["true_res_var"], ns["trv"])):
        np.testing.assert_allclose(a, b, rtol=1e-12, equal_nan=True)
    rec = eqtl_north_star.record({"kt": 3, "num_boot": B, "tile": 16},
                                 X.shape[0], nt, res, wall)
    assert rec["config"]["tests"] == int(nt.sum())
    assert rec["finite_pval_frac"] >= 0.99


def _jax_setup_names():
    from memento_tpu.api import _residual_variance_np
    from memento_tpu.ops.estimators import mean_var_sparse
    from memento_tpu.ops.mv_regression import fit_mv_regressor
    from memento_tpu.ops.size_factor import (bin_size_factor,
                                             estimate_size_factor)

    return {"_residual_variance_np": _residual_variance_np,
            "mean_var_sparse": mean_var_sparse,
            "fit_mv_regressor": fit_mv_regressor,
            "bin_size_factor": bin_size_factor,
            "estimate_size_factor": estimate_size_factor}


# --------------------------------------------------------------------------
# the first-use warm-up


@pytest.fixture(scope="module")
def warm_state(ns_counts):
    return eqtl_north_star.prepare(ns_counts[:600, :40].tocsr())


def _counting_kernel(fail_while_warming=False):
    """A stand-in for the CUDA wrapper on CPU tensors: the plain version,
    counted as the wrapper counts its launches."""
    def kernel(counts, weights, n_obs, num_boot, seed):
        if fail_while_warming and is_warming():
            raise RuntimeError("no kernel image for this device")
        cuda_kernels.count_launch(weights.shape[-1])
        return sampling.fused_bootstrap_sums(counts, weights, n_obs,
                                             num_boot, seed)
    return kernel


def _run_1d(state, num_boot, tile=16):
    return t_ht.run_ht_1d(
        3, groups=state["groups"], approx_sf=state["approx_sf"],
        true_mean=state["true_mean"], true_res_var=state["true_res_var"],
        mv_coeffs=state["mv_coeffs"], q=np.full(2, 0.1),
        covariate=np.ones((2, 1)), treatment=np.array([[0.0], [1.0]]),
        num_boot=num_boot, model=_port_model(), sampler="cascade_cuda",
        tile_size=tile, device="cpu")


def _port_model():
    from memento_tpu_torch.ops.estimators import get_noise_model

    return get_noise_model("hyper_relative")


def test_warm_up_counts_apart_and_changes_nothing(warm_state, monkeypatch):
    monkeypatch.setattr(t_boot, "fused_bootstrap_sums_cuda",
                        _counting_kernel())
    cuda_kernels.reset_launches()
    first = _run_1d(warm_state, 97)  # a run key no other test uses
    assert cuda_kernels.LAUNCHES["cascade_bootstrap"] == 3  # 40 genes / 16
    assert cuda_kernels.LAUNCHES_BY_W[2] == 3
    assert cuda_kernels.WARM_LAUNCHES["cascade_bootstrap"] == 1
    assert t_ht.profiling.timings()["ht1d.warm"]["count"] >= 1
    cuda_kernels.reset_launches()
    second = _run_1d(warm_state, 97)  # warm already: no warm-up
    assert cuda_kernels.LAUNCHES["cascade_bootstrap"] == 3
    assert cuda_kernels.WARM_LAUNCHES["cascade_bootstrap"] == 0
    for key in first:
        assert np.array_equal(first[key], second[key], equal_nan=True), key
    # a run with other options warms again, and the tiles do not move
    cuda_kernels.reset_launches()
    _run_1d(warm_state, 97, tile=24)
    assert cuda_kernels.LAUNCHES["cascade_bootstrap"] == 2
    assert cuda_kernels.WARM_LAUNCHES["cascade_bootstrap"] == 0
    cuda_kernels.reset_launches()


def test_warm_up_2d_counts_apart(warm_state, monkeypatch):
    monkeypatch.setattr(t_boot, "fused_bootstrap_sums_cuda",
                        _counting_kernel())
    idx1, idx2 = _data.bench_pairs(40, 20)
    kw = dict(groups=warm_state["groups"], approx_sf=warm_state["approx_sf"],
              idx1=idx1, idx2=idx2, true_corr=np.zeros((2, 20)),
              q=np.full(2, 0.1), covariate=np.ones((2, 1)),
              treatment=np.array([[0.0], [1.0]]), num_boot=61,
              model=_port_model(), sampler="cascade_cuda", tile_size=8,
              device="cpu")
    cuda_kernels.reset_launches()
    first = t_ht.run_ht_2d(5, **kw)
    assert cuda_kernels.LAUNCHES["cascade_bootstrap"] == 3
    assert cuda_kernels.LAUNCHES_BY_W[5] == 3
    assert cuda_kernels.WARM_LAUNCHES["cascade_bootstrap"] == 1
    cuda_kernels.reset_launches()
    second = t_ht.run_ht_2d(5, **kw)
    assert cuda_kernels.WARM_LAUNCHES["cascade_bootstrap"] == 0
    for key in first:
        assert np.array_equal(first[key], second[key], equal_nan=True), key
    cuda_kernels.reset_launches()


def test_failing_warm_up_raises(warm_state, monkeypatch):
    monkeypatch.setattr(t_boot, "fused_bootstrap_sums_cuda",
                        _counting_kernel(fail_while_warming=True))
    cuda_kernels.reset_launches()
    with pytest.raises(RuntimeError, match="warm-up") as info:
        _run_1d(warm_state, 89)
    assert "no kernel image" in str(info.value.__cause__)
    assert cuda_kernels.LAUNCHES["cascade_bootstrap"] == 0
    cuda_kernels.reset_launches()


def test_warm_up_runs_on_the_dispatching_thread(warm_state, monkeypatch):
    """The warm-up's launches come from the thread that dispatches the
    tiles (PyTorch's library handles are per thread)."""
    import threading

    threads = {"warm": set(), "real": set()}
    plain = _counting_kernel()

    def kernel(*a):
        threads["warm" if is_warming() else "real"].add(
            threading.get_ident())
        return plain(*a)

    monkeypatch.setattr(t_boot, "fused_bootstrap_sums_cuda", kernel)
    _run_1d(warm_state, 83)
    assert threads["warm"] == threads["real"] == {threading.get_ident()}
    cuda_kernels.reset_launches()


# --------------------------------------------------------------------------
# repairs found at the north-star scale


def test_get_corr_matrix_finishes_in_row_blocks(monkeypatch):
    """``get_corr_matrix`` finishes the Gram matrix in slices of
    ``CORR_ROW_BLOCK`` rows: the same matrix as a whole finish, with host
    temporaries of one slice (the whole finish of a 20,000-gene matrix held
    33 GiB on the card's host)."""
    import tracemalloc

    import memento_tpu_torch as mtt
    from memento_tpu_torch import api as t_api
    from memento_tpu_torch.ops.corr import corr_matrix_device

    X = _data.north_star_simulate(1200, 320, verbose=False)
    cond = (np.arange(1200) >= 600).astype(str)
    adata = mtt.AnnData(X, obs={"c": cond, "q": np.full(1200, 0.1)})
    mtt.setup_memento(adata, q_column="q", filter_mean_thresh=0.0)
    mtt.create_groups(adata, label_columns=["c"])
    mtt.compute_1d_moments(adata, min_perc_group=0.0)
    uns = adata.uns["memento"]
    group = uns["groups"][0]
    g = adata.n_vars
    whole = corr_matrix_device(
        uns["group_cells"][group], uns["size_factor"][group],
        uns["group_q"][group], uns["1d_moments"][group][1], _port_model(),
        device="cpu")
    monkeypatch.setattr(t_api, "CORR_ROW_BLOCK", 40)
    tracemalloc.start()
    try:
        blocked = mtt.get_corr_matrix(adata, group, device="cpu")
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert np.array_equal(blocked, whole, equal_nan=True)
    result_bytes = g * g * 8
    # a whole finish holds about six G x G float64 arrays at once
    assert peak < 2.5 * result_bytes, (peak, result_bytes)
    with_mesh = mtt.get_corr_matrix(adata, group, mesh=("cpu",))
    np.testing.assert_allclose(with_mesh, whole, atol=1e-5, equal_nan=True)
