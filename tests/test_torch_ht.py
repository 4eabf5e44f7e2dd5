"""The 1D slice as a whole: ``run_ht_1d`` of the port against the JAX package.

Both packages get the same compressed tiles (the JAX side's
``CompressedGroup``s carried across by ``convert.from_jax_outputs``) and the
same observed moments.  Observed coefficients are deterministic and agree to
float32 tolerance (rtol 1e-5); standard errors and p-values come from
different random streams and agree within bootstrap Monte Carlo tolerance:
median SE ratio in [0.85, 1.15], median |p difference| <= 0.05 (B = 400).
"""

import jax
import numpy as np
import pytest
import torch
import scipy.sparse as sparse

from memento_tpu.inference.ht import run_ht_1d as j_run_ht_1d
from memento_tpu.models.simulate import simulate_two_groups
from memento_tpu.ops import compress as j_compress
from memento_tpu.ops import estimators as j_est
from memento_tpu.ops.mv_regression import fit_mv_regressor
from memento_tpu.ops.size_factor import bin_size_factor, estimate_size_factor

from memento_tpu_torch.convert import from_jax_outputs
from memento_tpu_torch.inference import ht as t_ht
from memento_tpu_torch.ops import compress as t_compress
from memento_tpu_torch.ops import estimators as t_est

# tier-1 runs several pytest workers at once: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

B = 400
TILE = 64
N_DE = 6


def _res_var(m, v, coeffs):
    rv = np.full(m.shape, np.nan)
    ok = (m > 0) & (v > 0)
    lm = np.log(m[ok])
    rv[ok] = np.exp(np.log(v[ok]) - np.polyval(coeffs, lm))
    return rv


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    X, cond, rep, _ = simulate_two_groups(
        n_cells_per_group=450, n_genes=48, q=0.1, de_genes=np.arange(N_DE),
        de_lfc=0.6, n_replicates=2, rng=rng)
    X = X.astype(np.float64)
    sf = estimate_size_factor(X, mask=np.arange(48) >= N_DE, shrinkage=0.5)
    approx = bin_size_factor(sf, 30)
    labels = cond * 2 + rep
    groups, comps, means, variances = [], [], [], []
    for lab in range(4):
        rows = labels == lab
        grp = sparse.csc_matrix(X[rows])
        groups.append(grp)
        comps.append(j_compress.compress_group(grp, approx[rows],
                                               backend="numpy"))
        m, v = j_est.mean_var_sparse(grp, sf[rows], 0.1)
        means.append(m)
        variances.append(v)
    means, variances = np.array(means), np.array(variances)
    coeffs = fit_mv_regressor(means.ravel(), variances.ravel())
    treatment = np.array([[float(lab // 2)] for lab in range(4)])
    return dict(
        groups=groups,
        approx_sf=[approx[labels == lab] for lab in range(4)],
        comps=comps,
        true_mean=means,
        true_res_var=np.stack([_res_var(means[r], variances[r], coeffs)
                               for r in range(4)]),
        mv_coeffs=np.tile(coeffs, (4, 1)),
        q=np.full(4, 0.1),
        covariate=np.ones((4, 1)),
        treatment=treatment,
    )


def _common(inp, **over):
    kw = {k: inp[k] for k in ("true_mean", "true_res_var", "mv_coeffs", "q",
                              "covariate", "treatment")}
    kw.update(num_boot=B, tile_size=TILE, sampler="cascade")
    kw.update(over)
    return kw


_CACHE = {}


def _pair(inp, resampling, approx, model="hyper_relative", **over):
    """(JAX result, port result) on the same compressed inputs, cached for
    the module."""
    key = (resampling, approx, model, tuple(sorted(over)), over.get("sampler"))
    if key not in _CACHE:
        common = _common(inp, resampling=resampling, approx=approx, **over)
        want = j_run_ht_1d(jax.random.key(0), compressed=inp["comps"],
                           model=j_est.get_noise_model(model),
                           boot_chunk=B, **common)
        ported = from_jax_outputs(compressed=inp["comps"])["compressed"]
        got = t_ht.run_ht_1d(0, compressed=ported,
                             model=t_est.get_noise_model(model),
                             device="cpu", **common)
        _CACHE[key] = (want, got)
    return _CACHE[key]


@pytest.mark.parametrize("resampling,approx", [("bootstrap", False),
                                               ("permutation", True)])
def test_run_ht_1d_matches_jax(inputs, resampling, approx):
    want, got = _pair(inputs, resampling, approx)
    for stat in ("mean", "var"):
        assert got[f"{stat}_coef"].shape == want[f"{stat}_coef"].shape
        np.testing.assert_allclose(got[f"{stat}_coef"], want[f"{stat}_coef"],
                                   rtol=1e-5, atol=1e-6, equal_nan=True)
        ok = np.isfinite(want[f"{stat}_se"]) & np.isfinite(got[f"{stat}_se"])
        assert ok.mean() > 0.9
        ratio = np.median(got[f"{stat}_se"][ok] / want[f"{stat}_se"][ok])
        assert 0.85 <= ratio <= 1.15, (stat, ratio)
        pdiff = np.nanmedian(np.abs(got[f"{stat}_pval"] - want[f"{stat}_pval"]))
        assert pdiff <= 0.05, (stat, pdiff)
    if resampling == "bootstrap":  # power on the planted genes, both sides
        for res in (want, got):
            assert (res["mean_pval"][:N_DE] < 0.05).mean() >= 0.8


def test_mean_only_matches_jax(inputs):
    """W = 1 contraction (mean_only): observed coefficients agree."""
    want, got = _pair(inputs, "bootstrap", True, model="mean_only")
    np.testing.assert_allclose(got["mean_coef"], want["mean_coef"],
                               rtol=1e-5, atol=1e-6, equal_nan=True)
    ok = np.isfinite(want["mean_se"]) & np.isfinite(got["mean_se"])
    ratio = np.median(got["mean_se"][ok] / want["mean_se"][ok])
    assert 0.85 <= ratio <= 1.15


def test_one_sample_matches_jax(inputs):
    """All-ones treatment: the coefficient is the weighted average of the
    log moments over the surviving groups."""
    want, got = _pair(inputs, "bootstrap", True, treatment=np.ones((4, 1)))
    np.testing.assert_allclose(got["mean_coef"], want["mean_coef"],
                               rtol=1e-5, atol=1e-6, equal_nan=True)
    np.testing.assert_allclose(got["var_coef"], want["var_coef"],
                               rtol=1e-5, atol=1e-6, equal_nan=True)


def test_pipelined_compression_equals_precompressed(inputs):
    """Raw groups compressed per tile on the prefetch thread give the same
    result, to the bit, as the tiles precompressed by the same (default,
    native) packer (the per-tile seeds fold the tile start, not the
    execution order)."""
    common = _common(inputs, resampling="bootstrap", approx=True,
                     model=t_est.HYPER_RELATIVE, device="cpu", tile_size=32)
    packed = [t_compress.compress_group(grp, asf) for grp, asf in
              zip(inputs["groups"], inputs["approx_sf"])]
    a = t_ht.run_ht_1d(5, compressed=packed, **common)
    b = t_ht.run_ht_1d(5, groups=inputs["groups"],
                       approx_sf=inputs["approx_sf"], max_pending=1, **common)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_entry_points_raise_without_cuda(inputs):
    """Device entry points default to CUDA and never fall back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    common = _common(inputs, model=t_est.HYPER_RELATIVE)
    ported = from_jax_outputs(compressed=inputs["comps"])["compressed"]
    with pytest.raises(RuntimeError, match="CUDA"):
        t_ht.run_ht_1d(0, compressed=ported, **common)


@pytest.mark.parametrize("sampler", ["multinomial", "poisson", "gaussian"])
def test_run_ht_1d_sampler_matches_jax(inputs, sampler):
    """Each sampler against the JAX package's run with the same sampler:
    observed coefficients rtol 1e-5, SEs median |log ratio| < 0.15,
    p-values median |dp| < 0.05."""
    want, got = _pair(inputs, "bootstrap", False, sampler=sampler)
    for stat in ("mean", "var"):
        np.testing.assert_allclose(got[f"{stat}_coef"], want[f"{stat}_coef"],
                                   rtol=1e-5, atol=1e-6, equal_nan=True)
        ok = np.isfinite(want[f"{stat}_se"]) & np.isfinite(got[f"{stat}_se"])
        assert ok.mean() > 0.9
        log_ratio = np.median(np.abs(np.log(got[f"{stat}_se"][ok]
                                            / want[f"{stat}_se"][ok])))
        assert log_ratio < 0.15, (stat, log_ratio)
        pdiff = np.nanmedian(np.abs(got[f"{stat}_pval"]
                                    - want[f"{stat}_pval"]))
        assert pdiff < 0.05, (stat, pdiff)
    assert (got["mean_pval"][:N_DE] < 0.05).mean() >= 0.8


def _first_genes(inp, t):
    """``ht_1d_tile``'s inputs for the first ``t`` genes of the ported
    compressed groups, padded to one U."""
    ported = from_jax_outputs(compressed=inp["comps"])["compressed"]
    u = max(c.padded_u for c in ported)

    def stack(field, fill=0.0):
        out = np.full((len(ported), t, u), fill, np.float32)
        for r, c in enumerate(ported):
            x = getattr(c, field)[:t]
            out[r, :, :x.shape[1]] = x
        return out

    inv_sf = stack("inv_sf", 1.0)
    return (stack("values"), stack("counts"), inv_sf, inv_sf * inv_sf,
            np.stack([c.n_unique[:t] for c in ported]),
            inp["true_mean"][:, :t], inp["true_res_var"][:, :t],
            inp["mv_coeffs"], inp["q"],
            np.array([c.n_obs for c in ported], np.float32),
            inp["covariate"], np.tile(inp["treatment"], (t, 1, 1)))


@pytest.mark.parametrize("sampler", ["multinomial", "poisson", "gaussian"])
def test_boot_chunk_not_dividing_b_gives_b_replicates(inputs, sampler):
    """Chunks of 150 replicates (three, the last trimmed) give B replicates
    with the tile's own seeds per (group, chunk): the same coefficients as
    one chunk, SEs of the same size."""
    args = _first_genes(inputs, 8)
    kw = dict(num_boot=B, model=t_est.HYPER_RELATIVE, sampler=sampler,
              approx=True, device="cpu")
    res = t_ht.ht_1d_tile(3, *args, boot_chunk=150, **kw)
    whole = t_ht.ht_1d_tile(3, *args, **kw)
    assert res["mean_coef_full"].shape == (8, 1, B + 1)
    assert torch.isfinite(res["mean_coef_full"]).all()
    assert torch.isfinite(res["var_se"]).all()
    torch.testing.assert_close(res["mean_coef"], whole["mean_coef"])
    ratio = (res["mean_se"] / whole["mean_se"]).flatten()
    assert 0.75 < float(ratio.median()) < 1.33


def test_tile_compact_transport_equals_float_transport(rng):
    """``ht_1d_tile(sf_binned=True)`` (uint8 bin ids + [R, NB] table) equals
    the float size-factor transport to the bit."""
    from memento_tpu_torch.ops.estimators import HYPER_RELATIVE

    r, t, u, nb = 2, 8, 12, 5
    table = (rng.random((r, nb)) + 0.5).astype(np.float32)
    table[:, 0] = 1.0
    ids = rng.integers(0, nb, size=(r, t, u)).astype(np.uint8)
    inv_sf = np.take_along_axis(table[:, None, :].repeat(t, 1),
                                ids.astype(int), axis=2)
    values = rng.integers(0, 6, size=(r, t, u)).astype(np.int8)
    counts = rng.integers(1, 30, size=(r, t, u)).astype(np.int16)
    common = (np.full((r, t), u, np.int32),
              rng.random((r, t)).astype(np.float32) + 0.5,
              rng.random((r, t)).astype(np.float32) + 0.5,
              np.tile(np.array([0.0, 1.0, 0.0], np.float32), (r, 1)),
              np.full(r, 0.1, np.float32),
              counts.sum(2).max(1).astype(np.float32),
              np.ones((r, 1), np.float32),
              rng.integers(0, 2, size=(t, r, 1)).astype(np.float32))
    static = dict(num_boot=32, model=HYPER_RELATIVE, device="cpu")
    ref = t_ht.ht_1d_tile(3, values, counts, inv_sf, inv_sf * inv_sf,
                          *common, **static)
    got = t_ht.ht_1d_tile(3, values, counts, ids, table, *common,
                          sf_binned=True, **static)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(),
                                      err_msg=k)
