"""The port's mesh path (``memento_tpu_torch/parallel``) on a CPU mesh.

A mesh of the port is a tuple of devices; ``("cpu", "cpu")`` (and three
CPUs, for an uneven split) stands in for the JAX tests' virtual 8-device CPU
mesh.  Holds:

- cell-split sufficient statistics and streamed moments against the host
  float64 passes of both packages: rtol 1e-10 at ``precision='high'`` (the
  order of addition differs, and ``m2 - m1^2`` amplifies it), the JAX test's
  tolerances at ``'fast'`` (mean rtol 3e-4; variance rtol 3e-3, atol 1e-5);
- the JAX package's own streamed moments, correlation matrix and API state
  on its 8-device mesh (run in a subprocess, as its tests run them) at the
  JAX tests' tolerances;
- a tile split over the mesh bit for bit equal to its pieces run unsplit at
  their offsets, and ``run_ht_*`` / ``ht_*_moments`` with a mesh bit for bit
  equal to no mesh at the same tile size;
- the column-split correlation matrix against the one-device matrix and the
  JAX one at ``get_corr_matrix``'s tolerance (atol 1e-5, NaN pattern equal).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sparse
import torch

from conftest import scrubbed_env
from memento_tpu.ops import estimators as j_est

import memento_tpu_torch as mtt
from memento_tpu_torch import api as t_api
from memento_tpu_torch.device import fold_seed
from memento_tpu_torch.inference import ht as t_ht
from memento_tpu_torch.models.simulate import simulate_two_groups
from memento_tpu_torch.ops import compress as t_compress
from memento_tpu_torch.ops import corr as t_corr
from memento_tpu_torch.ops import estimators as t_est
from memento_tpu_torch.ops.mv_regression import fit_mv_regressor
from memento_tpu_torch.ops.size_factor import bin_size_factor
from memento_tpu_torch.parallel import mesh as t_mesh
from memento_tpu_torch.parallel import sharded, streaming

# tier-1 runs several pytest workers at once: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CPU2 = ("cpu", "cpu")
CPU3 = ("cpu", "cpu", "cpu")
HIGH = dict(rtol=1e-10)
FAST_MEAN = dict(rtol=3e-4)
FAST_VAR = dict(rtol=3e-3, atol=1e-5)


def _stream_data():
    """The JAX streaming test's matrix: 700 cells (divisible neither by the
    block nor the mesh) x 25 genes."""
    rng = np.random.default_rng(0)
    n, g = 700, 25
    X = sparse.csr_matrix(rng.poisson(0.8, size=(n, g)).astype(float))
    sf = np.asarray(X.sum(1)).ravel() + 1.0
    sf /= sf.mean()
    return X, sf


def _corr_data():
    """The JAX sharded-correlation test's matrix: 37 genes, not divisible by
    the mesh."""
    rng = np.random.default_rng(0)
    n, g = 500, 37
    X = sparse.csr_matrix(
        rng.poisson(rng.gamma(2.0, 1.0, size=(n, g)) * 0.4).astype(float))
    sf = np.asarray(X.sum(1)).ravel()
    sf /= sf.mean()
    _, var = t_est.mean_var_sparse(X, sf, 0.1)
    return X, sf, var


def _api_data():
    rng = np.random.default_rng(0)
    X, _ = _stream_data()
    obs = {"q": np.full(X.shape[0], 0.1),
           "c": rng.integers(0, 2, X.shape[0]).astype(str)}
    return X, obs


JAX_MESH_RUN = """
import sys
import numpy as np, pandas as pd, scipy.sparse as sparse
import memento_tpu as mt
from memento_tpu.ops.estimators import HYPER_RELATIVE
from memento_tpu.parallel.mesh import make_mesh
from memento_tpu.parallel.streaming import stream_mean_var
from memento_tpu.parallel.sharded import corr_matrix_sharded

d = np.load(sys.argv[1], allow_pickle=True)
out = {}
X = sparse.csr_matrix((d["x_data"], d["x_indices"], d["x_indptr"]),
                      shape=tuple(d["x_shape"]))
for precision in ("high", "fast"):
    m, v = stream_mean_var(make_mesh(shape=(8, 1)), X, d["sf"], 0.1,
                           HYPER_RELATIVE, block=192, precision=precision)
    out["m_" + precision], out["v_" + precision] = m, v
C = sparse.csr_matrix((d["c_data"], d["c_indices"], d["c_indptr"]),
                      shape=tuple(d["c_shape"]))
out["corr"] = corr_matrix_sharded(make_mesh(shape=(2, 4)), C, d["c_sf"], 0.1,
                                  d["c_var"], HYPER_RELATIVE, block=128)
mesh = make_mesh(shape=(8, 1))
ad = mt.AnnData(X.copy(), obs=pd.DataFrame({"q": d["q"], "c": d["c"]}))
mt.setup_memento(ad, q_column="q", filter_mean_thresh=0.01, mesh=mesh)
out["all_m"], out["all_v"] = ad.uns["memento"]["all_1d_moments"][:2]
mt.create_groups(ad, label_columns=["c"])
mt.compute_1d_moments(ad, min_perc_group=0.5, mesh=mesh)
for g in ad.uns["memento"]["groups"]:
    for i, key in enumerate(("mean", "var", "res_var")):
        out[key + "_" + g] = ad.uns["memento"]["1d_moments"][g][i]
np.savez(sys.argv[2], **out)
print("jax mesh ok")
"""


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    """The JAX package's results on its virtual 8-device CPU mesh, computed
    in one scrubbed subprocess (the in-process JAX has one CPU device)."""
    tmp = tmp_path_factory.mktemp("jax_mesh")
    X, sf = _stream_data()
    C, c_sf, c_var = _corr_data()
    _, obs = _api_data()
    np.savez(tmp / "in.npz", x_data=X.data, x_indices=X.indices,
             x_indptr=X.indptr, x_shape=X.shape, sf=sf, c_data=C.data,
             c_indices=C.indices, c_indptr=C.indptr, c_shape=C.shape,
             c_sf=c_sf, c_var=c_var, q=obs["q"], c=obs["c"])
    proc = subprocess.run(
        [sys.executable, "-c", JAX_MESH_RUN, str(tmp / "in.npz"),
         str(tmp / "out.npz")], env=scrubbed_env(8), cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(tmp / "out.npz") as z:
        return {k: z[k] for k in z.files}


def test_make_mesh():
    mesh = t_mesh.make_mesh(CPU2)
    assert mesh == (torch.device("cpu"), torch.device("cpu"))
    assert t_mesh.as_mesh(["cpu"]) == (torch.device("cpu"),)
    with pytest.raises(TypeError, match="sequence of devices"):
        t_mesh.as_mesh("cpu")
    with pytest.raises(ValueError, match="at least one"):
        t_mesh.make_mesh([])
    assert t_mesh.split_range(10, 3) == [(0, 4), (4, 7), (7, 10)]
    assert t_mesh.split_range(1, 2) == [(0, 1), (1, 1)]
    if torch.cuda.is_available():
        assert len(t_mesh.make_mesh()) == torch.cuda.device_count()
    else:  # the default mesh is the cards; no CPU in their place
        with pytest.raises(RuntimeError, match="CUDA"):
            t_mesh.make_mesh()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mesh", [CPU2, CPU3])
def test_dp_suffstats_matches_host_sums(dtype, mesh):
    """Cell slabs reduced per device and added equal the host float64 sums
    (float64: rtol 1e-12; float32: the JAX test's rtol 2e-4)."""
    rng = np.random.default_rng(0)
    x = rng.poisson(1.0, size=(64, 24)).astype(np.int8)
    w = rng.random(64) + 0.5
    got = sharded.dp_suffstats(mesh, x, (1 / w).astype(dtype),
                               (1 / w**2).astype(dtype))
    want = t_est.suffstats_sparse(sparse.csr_matrix(x.astype(float)), w)
    tol = 1e-12 if dtype == np.float64 else 2e-4
    for a, b in zip(got, want):
        assert a.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        np.testing.assert_allclose(a.numpy(), b, rtol=tol)
    m, v = sharded.dp_mean_var(mesh, x, 1 / w, 1 / w**2, 64, 0.1,
                               t_est.HYPER_RELATIVE)
    mw, vw = t_est.mean_var_sparse(sparse.csr_matrix(x.astype(float)), w, 0.1)
    np.testing.assert_allclose(m.numpy(), mw, rtol=1e-12)
    np.testing.assert_allclose(v.numpy(), vw, rtol=1e-10)


@pytest.mark.parametrize("mesh", [CPU2, CPU3])
@pytest.mark.parametrize("precision", ["high", "fast"])
def test_stream_mean_var_matches_host_of_both_packages(mesh, precision):
    X, sf = _stream_data()
    m, v = streaming.stream_mean_var(mesh, X, sf, 0.1, t_est.HYPER_RELATIVE,
                                     block=192, precision=precision)
    for mean_var in (t_est.mean_var_sparse, j_est.mean_var_sparse):
        mw, vw = (np.asarray(a) for a in mean_var(X, sf, 0.1))
        if precision == "high":
            np.testing.assert_allclose(m, mw, **HIGH)
            np.testing.assert_allclose(v, vw, **HIGH)
        else:
            np.testing.assert_allclose(m, mw, **FAST_MEAN)
            np.testing.assert_allclose(v, vw, **FAST_VAR)
    s = streaming.stream_suffstats(mesh, X.toarray(), sf, block=192,
                                   precision=precision)
    want = t_est.suffstats_sparse(X, sf)
    for a, b in zip(s, want):  # dense input ships as float
        np.testing.assert_allclose(a, b, rtol=1e-10 if precision == "high"
                                   else 2e-4)


def test_stream_absolute_model_ignores_size_factors():
    X, sf = _stream_data()
    m, v = streaming.stream_mean_var(CPU2, X, sf, 0.1, t_est.HYPER_ABSOLUTE,
                                     block=100)
    mw, vw = t_est.mean_var_sparse(X, np.ones(X.shape[0]), 0.1,
                                   "hyper_absolute")
    np.testing.assert_allclose(m, mw, **HIGH)
    np.testing.assert_allclose(v, vw, **HIGH)
    with pytest.raises(ValueError, match="precision"):
        streaming.stream_suffstats(CPU2, X, sf, precision="double")


@pytest.mark.parametrize("precision", ["high", "fast"])
def test_stream_mean_var_matches_jax_mesh(jax_mesh, precision):
    """The JAX package's own streaming test holds its 8-device stream to
    these tolerances only, so they are what the two streams are held to."""
    X, sf = _stream_data()
    m, v = streaming.stream_mean_var(CPU2, X, sf, 0.1, t_est.HYPER_RELATIVE,
                                     block=192, precision=precision)
    np.testing.assert_allclose(m, jax_mesh["m_" + precision], **FAST_MEAN)
    np.testing.assert_allclose(v, jax_mesh["v_" + precision], **FAST_VAR)


@pytest.fixture(scope="module")
def tiles():
    """Two groups of simulated counts, their compressed tiles and observed
    moments, and 6 gene pairs."""
    rng = np.random.default_rng(3)
    X, cond, _, _ = simulate_two_groups(n_cells_per_group=300, n_genes=20,
                                        de_genes=np.arange(3), rng=rng)
    X = X.astype(np.float64)
    sf = (X.sum(1) + 1.0) / (X.sum(1) + 1.0).mean()  # no zero factor
    approx = bin_size_factor(sf, 20)
    groups = [sparse.csc_matrix(X[cond == c]) for c in (0, 1)]
    asf = [approx[cond == c] for c in (0, 1)]
    tm, tv = zip(*(t_est.mean_var_sparse(grp, sf[cond == c], 0.1)
                   for c, grp in enumerate(groups)))
    tm, tv = np.array(tm), np.array(tv)
    mv = fit_mv_regressor(tm.ravel(), tv.ravel())
    trv = np.stack([t_api._residual_variance_np(tm[r], tv[r], mv)
                    for r in range(2)])
    idx1, idx2 = np.array([0, 2, 4, 6, 8, 1]), np.array([1, 3, 5, 7, 9, 12])
    cov = [t_corr.cov_sparse_pairs(grp, sf[cond == c], 0.1, idx1, idx2,
                                   t_est.HYPER_RELATIVE)
           for c, grp in enumerate(groups)]
    with np.errstate(invalid="ignore"):
        true_corr = np.stack([np.clip(cov[r] / np.sqrt(tv[r][idx1]
                                                       * tv[r][idx2]), -1, 1)
                              for r in range(2)])
    return dict(groups=groups, approx_sf=asf, true_mean=tm,
                true_res_var=trv, mv_coeffs=np.tile(mv, (2, 1)),
                q=np.full(2, 0.1), covariate=np.ones((2, 1)),
                treatment=np.array([[0.0], [1.0]]), idx1=idx1, idx2=idx2,
                true_corr=true_corr)


def _pad(a, u, fill=0.0):
    return np.pad(a, ((0, 0), (0, u - a.shape[1])), constant_values=fill)


def _sf_args(comps, u, binned):
    if binned:
        nb = max(len(c.bin_inv_sf) for c in comps)
        return (np.stack([_pad(c.sf_bin, u) for c in comps]),
                np.stack([np.pad(c.bin_inv_sf, (0, nb - len(c.bin_inv_sf)),
                                 constant_values=1.0) for c in comps]))
    return (np.stack([_pad(c.inv_sf, u, 1.0) for c in comps]),
            np.stack([_pad(c.inv_sf_sq, u, 1.0) for c in comps]))


def _tile_1d(inp, t, binned):
    comps = [t_compress.compress_group(grp, asf, cols=(0, t))
             for grp, asf in zip(inp["groups"], inp["approx_sf"])]
    u = max(c.padded_u for c in comps)
    n_obs = np.array([c.n_obs for c in comps], np.float32)
    return (np.stack([_pad(c.values, u) for c in comps]),
            np.stack([_pad(c.counts, u) for c in comps]),
            *_sf_args(comps, u, binned),
            np.stack([c.n_unique for c in comps]),
            inp["true_mean"][:, :t], inp["true_res_var"][:, :t],
            inp["mv_coeffs"], inp["q"], n_obs, inp["covariate"],
            np.broadcast_to(inp["treatment"], (t, 2, 1)).copy())


def _tile_2d(inp, binned):
    comps = [t_compress.compress_pairs(grp, asf, inp["idx1"], inp["idx2"])
             for grp, asf in zip(inp["groups"], inp["approx_sf"])]
    u = max(c.padded_u for c in comps)
    p = len(inp["idx1"])
    n_obs = np.array([c.n_obs for c in comps], np.float32)
    return (np.stack([_pad(c.values_1, u) for c in comps]),
            np.stack([_pad(c.values_2, u) for c in comps]),
            np.stack([_pad(c.counts, u) for c in comps]),
            *_sf_args(comps, u, binned), inp["true_corr"], inp["q"], n_obs,
            inp["covariate"],
            np.broadcast_to(inp["treatment"], (p, 2, 1)).copy())


STATIC = dict(num_boot=64, model=t_est.HYPER_RELATIVE, sampler="cascade",
              resampling="bootstrap")


def _piece(args, axes, table, lo, hi):
    """Genes ``[lo, hi)`` of a tile's args (positions after the seed), the
    bin table at position ``table`` left whole."""
    return [a[(slice(None),) * axes[i] + (slice(lo, hi),)]
            if i in axes and i != table else a
            for i, a in enumerate(args, start=1)]


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("mesh", [CPU2, CPU3])
@pytest.mark.parametrize("binned", [False, True])
def test_sharded_ht_1d_tile_equals_its_pieces(tiles, mesh, binned):
    """Each device's piece is a tile of its own, seeded at its global
    offset: the split tile equals the unsplit pieces bit for bit."""
    args = _tile_1d(tiles, 10, binned)
    got = sharded.sharded_ht_1d_tile(mesh, 5, *args, start=40,
                                     sf_binned=binned, **STATIC)
    pieces = []
    for lo, hi in t_mesh.split_range(10, len(mesh)):
        piece = _piece(args, sharded.HT1D_GENE_AXES, 4 if binned else None,
                       lo, hi)
        pieces.append(t_ht.ht_1d_tile(fold_seed(5, 40 + lo), *piece,
                                      sf_binned=binned, device="cpu",
                                      **STATIC))
    want = {k: torch.cat([p[k] for p in pieces]) for k in pieces[0]}
    _assert_same(got, want)
    assert got["mean_coef"].shape == (10, 1)


@pytest.mark.parametrize("binned", [False, True])
def test_sharded_ht_2d_tile_equals_its_pieces(tiles, binned):
    args = _tile_2d(tiles, binned)
    got = sharded.sharded_ht_2d_tile(CPU2, 5, *args, start=0,
                                     sf_binned=binned, **STATIC)
    pieces = []
    for lo, hi in t_mesh.split_range(6, 2):
        piece = _piece(args, sharded.HT2D_PAIR_AXES, 5 if binned else None,
                       lo, hi)
        pieces.append(t_ht.ht_2d_tile(fold_seed(5, lo), *piece,
                                      sf_binned=binned, device="cpu",
                                      **STATIC))
    want = {k: torch.cat([p[k] for p in pieces]) for k in pieces[0]}
    _assert_same(got, want)


def _ht_kwargs(inp, keys):
    return dict({k: inp[k] for k in keys}, num_boot=64,
                model=t_est.HYPER_RELATIVE, tile_size=8, sampler="cascade",
                groups=inp["groups"], approx_sf=inp["approx_sf"])


@pytest.mark.parametrize("mesh", [CPU2, CPU3])
def test_run_ht_1d_with_mesh_equals_no_mesh(tiles, mesh):
    kw = _ht_kwargs(tiles, ("true_mean", "true_res_var", "mv_coeffs", "q",
                            "covariate", "treatment"))
    want = t_ht.run_ht_1d(0, device="cpu", **kw)
    got = t_ht.run_ht_1d(0, mesh=mesh, **kw)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.isfinite(want["mean_pval"]).mean() > 0.8


@pytest.mark.parametrize("mesh", [CPU2, CPU3])
def test_run_ht_2d_with_mesh_equals_no_mesh(tiles, mesh):
    kw = _ht_kwargs(tiles, ("true_corr", "q", "covariate", "treatment",
                            "idx1", "idx2"))
    kw["tile_size"] = 2
    want = t_ht.run_ht_2d(0, device="cpu", **kw)
    got = t_ht.run_ht_2d(0, mesh=mesh, **kw)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.isfinite(want["corr_pval"]).all()


@pytest.mark.parametrize("mesh", [CPU2, CPU3])
def test_corr_matrix_sharded_matches_one_device_and_jax(jax_mesh, mesh):
    X, sf, var = _corr_data()
    want = t_corr.corr_matrix_device(X, sf, 0.1, var, t_est.HYPER_RELATIVE,
                                     block=128, device="cpu")
    got = sharded.corr_matrix_sharded(mesh, X, sf, 0.1, var,
                                      t_est.HYPER_RELATIVE, block=128)
    assert got.shape == (37, 37) and got.dtype == np.float64
    for ref in (want, jax_mesh["corr"]):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(got, ref, atol=1e-5, equal_nan=True)
    # the row-blocked finish gives the same matrix; float32 output
    got_b = sharded.corr_matrix_sharded(mesh, X, sf, 0.1, var,
                                        t_est.HYPER_RELATIVE, block=128,
                                        row_block=16, out_dtype=np.float32)
    assert got_b.dtype == np.float32
    np.testing.assert_allclose(got_b, got.astype(np.float32), rtol=2e-6,
                               atol=2e-7, equal_nan=True)


@pytest.fixture(scope="module")
def api_states():
    """``setup_memento`` and ``compute_1d_moments`` of the port without a
    mesh and with ``CPU2``."""
    X, obs = _api_data()
    out = {}
    for name, mesh in (("none", None), ("mesh", CPU2)):
        ad = mtt.AnnData(X.copy(), obs=dict(obs))
        mtt.setup_memento(ad, q_column="q", filter_mean_thresh=0.01,
                          mesh=mesh)
        mtt.create_groups(ad, label_columns=["c"])
        mtt.compute_1d_moments(ad, min_perc_group=0.5, mesh=mesh)
        out[name] = ad
    return out


def test_api_moments_with_mesh_equal_no_mesh(api_states):
    one, mesh = (api_states[k].uns["memento"] for k in ("none", "mesh"))
    for a, b in zip(mesh["all_1d_moments"], one["all_1d_moments"]):
        np.testing.assert_allclose(a, b, **HIGH)
    np.testing.assert_array_equal(
        api_states["mesh"].obs["memento_size_factor"],
        api_states["none"].obs["memento_size_factor"])
    assert mesh["gene_list"] == one["gene_list"]
    for g in one["groups"]:
        for a, b in zip(mesh["1d_moments"][g], one["1d_moments"][g]):
            np.testing.assert_allclose(a, b, **HIGH, equal_nan=True)


def test_api_moments_with_mesh_match_jax_mesh(api_states, jax_mesh):
    """The JAX test's tolerances for its mesh-wired setup (rtol 5e-3, atol
    1e-5)."""
    uns = api_states["mesh"].uns["memento"]
    for a, key in zip(uns["all_1d_moments"], ("all_m", "all_v")):
        np.testing.assert_allclose(a, jax_mesh[key], rtol=5e-3, atol=1e-5)
    for g in uns["groups"]:
        for a, key in zip(uns["1d_moments"][g], ("mean", "var", "res_var")):
            np.testing.assert_allclose(a, jax_mesh[f"{key}_{g}"], rtol=5e-3,
                                       atol=1e-5, equal_nan=True)


def test_api_tests_and_corr_matrix_with_mesh(api_states):
    """``ht_1d_moments`` / ``ht_2d_moments`` with a mesh equal the one-device
    runs bit for bit; ``get_corr_matrix(mesh=...)`` the one-device matrix
    at atol 1e-5."""
    ad = api_states["none"].copy()
    groups = mtt.get_groups(ad)
    kw = dict(covariate=np.ones((2, 1)),
              treatment=np.asarray(groups["c"], float)[:, None],
              num_boot=64, tile_size=8, verbose=0)
    genes = list(ad.var.index)
    mtt.compute_2d_moments(ad, [(genes[i], genes[i + 1])
                                for i in range(0, 10, 2)])
    for test, result, cols in (
            (mtt.ht_1d_moments, mtt.get_1d_ht_result,
             ("de_coef", "de_se", "de_pval", "dv_coef", "dv_se", "dv_pval")),
            (mtt.ht_2d_moments, mtt.get_2d_ht_result,
             ("corr_coef", "corr_se", "corr_pval"))):
        test(ad, device="cpu", **kw)
        want = result(ad)
        test(ad, mesh=CPU2, **kw)
        got = result(ad)
        for col in cols:
            np.testing.assert_array_equal(got[col], want[col], err_msg=col)
    group = ad.uns["memento"]["groups"][0]
    want = mtt.get_corr_matrix(ad, group, device="cpu")
    got = mtt.get_corr_matrix(ad, group, mesh=CPU3)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-5, equal_nan=True)
