"""The 2D slice: ``bootstrap_2d``, ``ht_2d_tile`` and ``run_ht_2d`` of the
port against the JAX package.

Both packages get the same joint compressed tiles (the JAX side's
``CompressedPairGroup``s carried across by ``convert.from_jax_outputs``) and
the same observed correlations.  The JAX side runs its plain
``sampler="cascade"`` path on the CPU.  Observed coefficients are
deterministic and agree to float32 tolerance (rtol 1e-5, atol 1e-6, equal
NaN pattern); standard errors and p-values come from different random
streams and agree within bootstrap Monte Carlo tolerance: median SE ratio in
[0.85, 1.15], median |p difference| <= 0.05 (B = 400).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sparse
import torch

from memento_tpu import api as j_api
from memento_tpu.inference.ht import run_ht_2d as j_run_ht_2d
from memento_tpu.ops import bootstrap as j_boot
from memento_tpu.ops import compress as j_compress
from memento_tpu.ops import corr as j_corr
from memento_tpu.ops import estimators as j_est
from memento_tpu.ops.size_factor import bin_size_factor, estimate_size_factor

from memento_tpu_torch.convert import from_jax_outputs
from memento_tpu_torch.inference import ht as t_ht
from memento_tpu_torch.ops import bootstrap as t_boot
from memento_tpu_torch.ops import estimators as t_est

# the suite runs under several pytest workers at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

B = 400
TILE = 64
N_GENES = 32
N_CORR = 4  # planted pairs (0,1), (2,3), ... in condition 1 only
N_PAIRS = 24


def _simulate(rng, n_per=450):
    """2 conditions x 2 replicates of gamma-Poisson counts; in condition 1
    the genes of each planted pair share half of their gamma factor."""
    base = np.exp(rng.uniform(np.log(0.8), np.log(3.0), N_GENES))
    blocks, labels = [], []
    for cond in range(2):
        for rep in range(2):
            fac = rng.gamma(1.0, 1.0, (n_per, N_GENES)) \
                + rng.gamma(1.0, 1.0, (n_per, N_GENES))
            if cond == 1:
                for k in range(N_CORR):
                    shared = rng.gamma(1.0, 1.0, n_per)
                    for j in (2 * k, 2 * k + 1):
                        fac[:, j] = shared + rng.gamma(1.0, 1.0, n_per)
            blocks.append(rng.poisson(fac * base / 2.0))
            labels += [cond * 2 + rep] * n_per
    return np.vstack(blocks).astype(np.float64), np.array(labels)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(23)
    X, labels = _simulate(rng)
    sf = estimate_size_factor(X, mask=np.arange(N_GENES) >= 2 * N_CORR,
                              shrinkage=0.5)
    approx = bin_size_factor(sf, 30)
    idx1 = np.r_[np.arange(0, 2 * N_CORR, 2),
                 rng.integers(2 * N_CORR, N_GENES, N_PAIRS - N_CORR)]
    idx2 = np.r_[np.arange(1, 2 * N_CORR, 2),
                 (idx1[N_CORR:] - 2 * N_CORR + 1
                  + rng.integers(0, N_GENES - 2 * N_CORR - 1,
                                 N_PAIRS - N_CORR))
                 % (N_GENES - 2 * N_CORR) + 2 * N_CORR]
    assert (idx1 != idx2).all()
    groups, comps, true_corr = [], [], []
    for lab in range(4):
        rows = labels == lab
        grp = sparse.csc_matrix(X[rows])
        groups.append(grp)
        comps.append(j_compress.compress_pairs(grp, approx[rows], idx1, idx2,
                                               backend="numpy"))
        _, var = j_est.mean_var_sparse(grp, sf[rows], 0.1)
        cov = j_corr.cov_sparse_pairs(grp, sf[rows], 0.1, idx1, idx2,
                                      j_est.HYPER_RELATIVE)
        true_corr.append(j_api._corr_from_cov_np(cov, var[idx1], var[idx2]))
    return dict(
        groups=groups,
        approx_sf=[approx[labels == lab] for lab in range(4)],
        idx1=idx1,
        idx2=idx2,
        comps=comps,
        true_corr=np.array(true_corr),
        q=np.full(4, 0.1),
        covariate=np.ones((4, 1)),
        treatment=np.array([[float(lab // 2)] for lab in range(4)]),
    )


def _common(inp, **over):
    kw = {k: inp[k] for k in ("true_corr", "q", "covariate", "treatment")}
    kw.update(num_boot=B, tile_size=TILE, sampler="cascade")
    kw.update(over)
    return kw


_CACHE = {}


def _pair(inp, resampling, approx, **over):
    """(JAX result, port result) on the same compressed inputs, cached for
    the module."""
    key = (resampling, approx, tuple(sorted(over)), over.get("sampler"))
    if key not in _CACHE:
        common = _common(inp, resampling=resampling, approx=approx, **over)
        want = j_run_ht_2d(jax.random.key(0), compressed_pairs=inp["comps"],
                           model=j_est.HYPER_RELATIVE, boot_chunk=B, **common)
        ported = from_jax_outputs(compressed_pairs=inp["comps"])
        got = t_ht.run_ht_2d(0, compressed_pairs=ported["compressed_pairs"],
                             model=t_est.HYPER_RELATIVE, device="cpu",
                             **common)
        _CACHE[key] = (want, got)
    return _CACHE[key]


def test_bootstrap_2d_matches_jax_in_distribution(inputs):
    """W = 5 against the JAX ``bootstrap_2d`` on one group's joint tiles:
    per pair, the replicate mean of cov, var_1 and var_2 within 0.15 sd and
    their sd within 15% (B = 2000, independent streams)."""
    c = inputs["comps"][2]
    n, nb = float(c.n_obs), 2000
    want = j_boot.bootstrap_2d(
        jax.random.key(3), *(jnp.asarray(getattr(c, f)) for f in (
            "values_1", "values_2", "counts", "inv_sf", "inv_sf_sq")),
        n, 0.1, j_est.HYPER_RELATIVE, nb, "cascade")
    got = t_boot.bootstrap_2d(
        *(torch.tensor(getattr(c, f)) for f in (
            "values_1", "values_2", "counts", "inv_sf", "inv_sf_sq")),
        n, 0.1, t_est.HYPER_RELATIVE, nb, 5, "cascade")
    for name, w, g in zip(("cov", "var_1", "var_2"), want, got):
        w, g = np.asarray(w), g.numpy()
        assert g.shape == w.shape == (N_PAIRS, nb)
        sd = w.std(1)
        assert (np.abs(g.mean(1) - w.mean(1)) / sd).max() < 0.15, name
        np.testing.assert_allclose(g.std(1) / sd, 1.0, atol=0.15,
                                   err_msg=name)


def test_bootstrap_2d_conserves_cells():
    """With both genes' values and the size factors set to 1, the two mean
    sums are weight-1 columns: every replicate's resample must total N, so
    cov = 1 - 1*1 and var = (1 - c) - 1 hold in every replicate, for rows
    with different N, leading large bins and many small ones."""
    rng = np.random.default_rng(5)
    counts = np.zeros((2, 6, 40), np.float32)
    for r in range(2):
        for i in range(6):
            k = rng.integers(8, 40)
            counts[r, i, 1:k] = rng.integers(1, 7, k - 1)
            counts[r, i, 0] = (900, 400)[r] - counts[r, i, 1:].sum()
    counts = torch.tensor(counts)
    ones = torch.ones_like(counts)
    n_obs = torch.tensor([900.0, 400.0])[:, None]
    cov, var_1, var_2 = t_boot.bootstrap_2d(
        ones, ones, counts, ones, ones, n_obs, 0.1, t_est.HYPER_RELATIVE,
        64, 9, "cascade")
    assert cov.shape == (2, 6, 64)
    np.testing.assert_allclose(cov.numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(var_1.numpy(), -0.9, atol=1e-5)
    np.testing.assert_allclose(var_2.numpy(), -0.9, atol=1e-5)


@pytest.mark.parametrize("resampling,approx", [("bootstrap", False),
                                               ("permutation", True)])
def test_run_ht_2d_matches_jax(inputs, resampling, approx):
    want, got = _pair(inputs, resampling, approx)
    assert got["corr_coef"].shape == want["corr_coef"].shape == (N_PAIRS, 1)
    np.testing.assert_allclose(got["corr_coef"], want["corr_coef"],
                               rtol=1e-5, atol=1e-6, equal_nan=True)
    ok = np.isfinite(want["corr_se"]) & np.isfinite(got["corr_se"])
    assert ok.mean() > 0.9
    ratio = np.median(got["corr_se"][ok] / want["corr_se"][ok])
    assert 0.85 <= ratio <= 1.15, ratio
    pdiff = np.nanmedian(np.abs(got["corr_pval"] - want["corr_pval"]))
    assert pdiff <= 0.05, pdiff
    # the planted correlation shows on both sides
    for res in (want, got):
        assert res["corr_coef"][:N_CORR, 0].mean() > 0.15
        assert np.abs(res["corr_coef"][N_CORR:, 0]).mean() < 0.1
        if resampling == "bootstrap":
            assert (res["corr_pval"][:N_CORR, 0] < 0.05).mean() >= 0.75


def test_perfect_and_invalid_correlations_drop_groups(inputs):
    """An observed |corr| == 1 drops its group for that pair (the
    coefficient comes from the other three); a pair that is invalid in every
    group is NaN; the sentinel replicates stay finite.  Both sides."""
    true_corr = inputs["true_corr"].copy()
    true_corr[1, 5] = 1.0  # one group dropped
    true_corr[:, 6] = [1.0, -1.0, np.nan, 1.0]  # no group left
    true_corr[3, 7] = np.nan
    want, got = _pair(inputs, "bootstrap", False, true_corr=true_corr)
    base_want, base_got = _pair(inputs, "bootstrap", False)
    for res, base in ((want, base_want), (got, base_got)):
        assert np.isnan(res["corr_coef"][6]).all()
        assert np.isnan(res["corr_se"][6]).all()
        assert np.isnan(res["corr_pval"][6]).all()
        assert np.isfinite(res["corr_coef"][[5, 7]]).all()
        assert not np.allclose(res["corr_coef"][5], base["corr_coef"][5])
        untouched = np.setdiff1d(np.arange(N_PAIRS), [5, 6, 7])
        np.testing.assert_allclose(res["corr_coef"][untouched],
                                   base["corr_coef"][untouched], rtol=1e-6)
    np.testing.assert_allclose(got["corr_coef"], want["corr_coef"],
                               rtol=1e-5, atol=1e-6, equal_nan=True)
    # group 1 dropped for pair 5: the slope of the remaining three groups
    tc = inputs["true_corr"][:, 5]
    expect = (tc[2] + tc[3]) / 2 - tc[0]
    np.testing.assert_allclose(got["corr_coef"][5, 0], expect, rtol=1e-4)


def test_pipelined_pair_compression_equals_precompressed(inputs):
    """Raw groups jointly compressed per tile on the prefetch thread give the
    same result, to the bit, as the precompressed tiles, also over several
    tiles with one pending (the per-tile seeds fold the tile start, not the
    execution order)."""
    common = _common(inputs, resampling="bootstrap", approx=True,
                     model=t_est.HYPER_RELATIVE, device="cpu", tile_size=8)
    ported = from_jax_outputs(compressed_pairs=inputs["comps"])
    a = t_ht.run_ht_2d(5, compressed_pairs=ported["compressed_pairs"],
                       **common)
    b = t_ht.run_ht_2d(5, groups=inputs["groups"],
                       approx_sf=inputs["approx_sf"], idx1=inputs["idx1"],
                       idx2=inputs["idx2"], max_pending=1, **common)
    assert set(a) == {"corr_coef", "corr_se", "corr_pval"}
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_2d_tile_seed_differs_from_1d_tile_seed():
    """A pair tile folds the 2D path constant, so its bootstrap stream is
    not the gene tile's for the same derived seed."""
    from memento_tpu_torch.device import fold_seed

    assert fold_seed(fold_seed(7, 0), t_ht._PATH_2D, 0) != \
        fold_seed(fold_seed(7, 0), 0)


def _tile_args(rng, r=2, p=8, u=12, nb=5):
    table = (rng.random((r, nb)) + 0.5).astype(np.float32)
    table[:, 0] = 1.0
    ids = rng.integers(0, nb, size=(r, p, u)).astype(np.uint8)
    inv_sf = np.take_along_axis(table[:, None, :].repeat(p, 1),
                                ids.astype(int), axis=2)
    v1 = rng.integers(0, 6, size=(r, p, u)).astype(np.int8)
    v2 = rng.integers(0, 6, size=(r, p, u)).astype(np.int8)
    counts = rng.integers(1, 30, size=(r, p, u)).astype(np.int16)
    rest = (rng.uniform(-0.5, 0.5, (r, p)).astype(np.float32),
            np.full(r, 0.1, np.float32),
            counts.sum(2).max(1).astype(np.float32),
            np.ones((r, 1), np.float32),
            rng.integers(0, 2, size=(p, r, 1)).astype(np.float32))
    return (v1, v2, counts), ids, table, inv_sf, rest


def test_2d_tile_compact_transport_equals_float_transport(rng):
    """``ht_2d_tile(sf_binned=True)`` (uint8 bin ids + [R, NB] table) equals
    the float size-factor transport to the bit."""
    lead, ids, table, inv_sf, rest = _tile_args(rng)
    static = dict(num_boot=32, model=t_est.HYPER_RELATIVE, device="cpu")
    ref = t_ht.ht_2d_tile(3, *lead, inv_sf, inv_sf * inv_sf, *rest, **static)
    got = t_ht.ht_2d_tile(3, *lead, ids, table, *rest, sf_binned=True,
                          **static)
    assert ref["corr_coef"].shape == (8, 1)
    assert ref["corr_coef_full"].shape == (8, 1, 33)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(),
                                      err_msg=k)


def test_2d_entry_points_raise_without_cuda(inputs, rng):
    """Device entry points default to CUDA and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    common = _common(inputs, model=t_est.HYPER_RELATIVE)
    ported = from_jax_outputs(compressed_pairs=inputs["comps"])
    with pytest.raises(RuntimeError, match="CUDA"):
        t_ht.run_ht_2d(0, compressed_pairs=ported["compressed_pairs"],
                       **common)
    lead, _, _, inv_sf, rest = _tile_args(rng)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_ht.ht_2d_tile(3, *lead, inv_sf, inv_sf * inv_sf, *rest,
                        num_boot=8, model=t_est.HYPER_RELATIVE)


@pytest.mark.parametrize("option,match", [
    (dict(mesh=("cpu", "cpu")), "mesh"),
    (dict(distributed=True), "distributed"),
])
def test_run_ht_2d_refuses_what_is_not_ported(inputs, option, match):
    """The multi-device options once raised here; they now run and equal
    the plain run bit for bit: a CPU mesh of two devices, and
    ``distributed=True`` outside a process group (one process)."""
    common = _common(inputs, model=t_est.HYPER_RELATIVE, device="cpu")
    ported = from_jax_outputs(compressed_pairs=inputs["comps"])
    want = t_ht.run_ht_2d(0, compressed_pairs=ported["compressed_pairs"],
                          **common)
    got = t_ht.run_ht_2d(0, compressed_pairs=ported["compressed_pairs"],
                         **common, **option)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key],
                                      err_msg=f"{match} {key}")


@pytest.mark.parametrize("sampler", ["multinomial", "poisson", "gaussian"])
def test_run_ht_2d_sampler_matches_jax(inputs, sampler):
    """Each sampler against the JAX package's run with the same sampler:
    observed coefficients rtol 1e-5, SEs median |log ratio| < 0.15,
    p-values median |dp| < 0.05; the planted correlations show.  B = 200
    keeps the JAX package's materialized samplers within the file's time."""
    want, got = _pair(inputs, "bootstrap", False, sampler=sampler,
                      num_boot=200)
    np.testing.assert_allclose(got["corr_coef"], want["corr_coef"],
                               rtol=1e-5, atol=1e-6, equal_nan=True)
    ok = np.isfinite(want["corr_se"]) & np.isfinite(got["corr_se"])
    assert ok.mean() > 0.9
    log_ratio = np.median(np.abs(np.log(got["corr_se"][ok]
                                        / want["corr_se"][ok])))
    assert log_ratio < 0.15, log_ratio
    pdiff = np.nanmedian(np.abs(got["corr_pval"] - want["corr_pval"]))
    assert pdiff < 0.05, pdiff
    assert (got["corr_pval"][:N_CORR, 0] < 0.05).mean() >= 0.75


def test_2d_boot_chunk_not_dividing_b_gives_b_replicates(rng):
    """Chunks of 150 replicates give B replicates, the same coefficients as
    one chunk, and SEs of the same size."""
    lead, _, _, inv_sf, rest = _tile_args(rng)
    kw = dict(num_boot=B, model=t_est.HYPER_RELATIVE, sampler="multinomial",
              approx=True, device="cpu")
    res = t_ht.ht_2d_tile(3, *lead, inv_sf, inv_sf * inv_sf, *rest,
                          boot_chunk=150, **kw)
    whole = t_ht.ht_2d_tile(3, *lead, inv_sf, inv_sf * inv_sf, *rest, **kw)
    assert res["corr_coef_full"].shape == (8, 1, B + 1)
    assert torch.isfinite(res["corr_coef_full"]).all()
    torch.testing.assert_close(res["corr_coef"], whole["corr_coef"])
    ratio = (res["corr_se"] / whole["corr_se"]).flatten()
    assert 0.75 < float(ratio.nanmedian()) < 1.33
