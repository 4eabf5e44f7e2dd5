"""The port's inference stages against the JAX package on shared inputs.

The same numpy bootstrap matrices go through both packages: meta-regression,
ASL, invalid-value fill and GEV refinement must agree to float32 tolerance
(rtol 1e-5 / atol 1e-6: both sides run float32, with sums and solves in a
different order), counting p-values exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memento_tpu.inference import asl as j_asl
from memento_tpu.inference import gev as j_gev
from memento_tpu.inference import ht as j_ht
from memento_tpu.inference import regression as j_reg

from memento_tpu_torch.device import generator
from memento_tpu_torch.inference import asl as t_asl
from memento_tpu_torch.inference import gev as t_gev
from memento_tpu_torch.inference import ht as t_ht
from memento_tpu_torch.inference import regression as t_reg

# tier-1 runs several pytest workers at once: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _gene_batch(rng, t=6, r=6, b=40, kt=2, k=2):
    """Per-gene stats [T, R, B+1], treatments [T, R, Kt], weights [T, R]
    (some groups dropped), a covariate with an intercept-like column."""
    stats = rng.normal(0, 1, (t, r, b + 1)).astype(np.float32)
    treat = rng.integers(0, 2, (t, r, kt)).astype(np.float32)
    treat[:, 0, :], treat[:, 1, :] = 0.0, 1.0  # both arms present
    weights = rng.uniform(50, 200, (t, r)).astype(np.float32)
    weights[1, 3] = 0.0
    weights[4, 2:4] = 0.0
    stats[weights == 0] = 0.0
    covariate = np.column_stack([np.ones(r), rng.normal(0, 1, (r, k - 1))]
                                ).astype(np.float32)
    return stats, treat, weights, covariate


def _jax_meta(covariate, treat, stats, weights, one_sample, os_g=None):
    def per_gene(tr, st, w, o):
        return j_reg.meta_regress(jnp.asarray(covariate), tr, st, w,
                                  one_sample=one_sample, one_sample_g=o)
    if os_g is None:
        return np.asarray(jax.vmap(lambda a, b, c: per_gene(a, b, c, None))(
            jnp.asarray(treat), jnp.asarray(stats), jnp.asarray(weights)))
    return np.asarray(jax.vmap(per_gene)(
        jnp.asarray(treat), jnp.asarray(stats), jnp.asarray(weights),
        jnp.asarray(os_g)))


@pytest.mark.parametrize("case", ["regression", "one_sample", "per_gene_os"])
def test_meta_regress_matches_jax(rng, case):
    stats, treat, weights, covariate = _gene_batch(rng)
    os_g = None
    if case == "one_sample":
        treat = np.ones_like(treat)
    elif case == "per_gene_os":
        os_g = np.array([True, False, False, True, False, False])
    want = _jax_meta(covariate, treat, stats, weights, case == "one_sample",
                     os_g)
    got = t_reg.meta_regress(
        torch.tensor(covariate), torch.tensor(treat), torch.tensor(stats),
        torch.tensor(weights), one_sample=case == "one_sample",
        one_sample_g=None if os_g is None else torch.tensor(os_g)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)


def test_wls_and_cross_coef_match_jax(rng):
    stats, treat, weights, covariate = _gene_batch(rng)
    args = (covariate, stats[0], weights[0])
    want = np.asarray(j_reg.wls_residualize(*map(jnp.asarray, args)))
    got = t_reg.wls_residualize(*map(torch.tensor, args)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    args = (treat[0], stats[0], weights[0])
    want = np.asarray(j_reg.cross_coef(*map(jnp.asarray, args)))
    got = t_reg.cross_coef(*map(torch.tensor, args)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_cross_coef_resampled_matches_jax(rng):
    r, m, kt = 5, 30, 2
    A = rng.normal(0, 1, (r, m, kt)).astype(np.float32)
    B = rng.normal(0, 1, (r, m)).astype(np.float32)
    w = rng.uniform(10, 50, (r, m)).astype(np.float32)
    A[:, 3, :] = 1.0  # a resampled set with no contrast -> NaN
    scale = rng.uniform(0.2, 1.0, kt).astype(np.float32)
    for sc in (None, scale):
        want = np.asarray(j_reg.cross_coef_resampled(
            jnp.asarray(A), jnp.asarray(B), jnp.asarray(w),
            scale=None if sc is None else jnp.asarray(sc)))
        got = t_reg.cross_coef_resampled(
            torch.tensor(A), torch.tensor(B), torch.tensor(w),
            scale=None if sc is None else torch.tensor(sc)).numpy()
        np.testing.assert_allclose(got, want, equal_nan=True, **TOL)
        assert np.isnan(got[:, 3]).all()


def test_resampled_indices_and_rep_padding(rng):
    good = torch.tensor([[True, False, True, True], [True] * 4])
    rep, it = t_reg.resampled_indices(generator(1, "cpu"), 4, 100, good=good)
    assert rep.shape == it.shape == (2, 4, 100)
    assert torch.equal(rep[..., 0], torch.arange(4).expand(2, 4))
    assert (it[..., 0] == 0).all() and it.max() <= 100 and it[..., 1:].min() >= 1
    assert not (rep[0, [0, 2, 3], 1:] == 1).any()  # dead row never drawn
    assert (rep[0, 1] == 1).all()  # dead row keeps its own index

    # one-sample genes keep the full B+1 average; regression genes get the
    # NaN pad in the last column (reference semantics)
    R, B = 4, 64
    stats = rng.normal(0, 1, (2, R, B + 1)).astype(np.float32)
    weights = np.tile(np.array([10.0, 20.0, 30.0, 40.0], np.float32), (2, 1))
    treat = np.stack([np.ones((R, 1)), [[0.], [0.], [1.], [1.]]]
                     ).astype(np.float32)
    coef = t_reg.meta_regress(
        torch.ones(R, 1), torch.tensor(treat), torch.tensor(stats),
        torch.tensor(weights), one_sample=False, resample_rep=True,
        gen=generator(0, "cpu"), one_sample_g=torch.tensor([True, False]))
    assert coef.shape == (2, 1, B + 1)
    avg = (weights[0, :, None] * stats[0]).sum(0) / weights[0].sum()
    np.testing.assert_allclose(coef[0, 0].numpy(), avg, rtol=1e-5)
    assert torch.isnan(coef[1, 0, -1])
    assert torch.isfinite(coef[1, 0, :-1]).float().mean() > 0.5


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("resampling", ["bootstrap", "permutation"])
def test_asl_counting_matches_jax(rng, approx, resampling):
    b = 999
    coef = rng.normal(0, 1, (5, 3, b + 1)).astype(np.float32)
    coef[0, 0, 0] = 5.0  # extreme: flagged for GEV
    coef[1, 1] = 0.25  # degenerate row -> NaN
    coef[2, 2, 7] = np.nan  # a NaN row is never degenerate
    p_j, n_j = j_asl.asl_counting(jnp.asarray(coef), resampling, approx)
    p_t, n_t = t_asl.asl_counting(torch.tensor(coef), resampling, approx)
    p_j, p_t = np.asarray(p_j), p_t.numpy()
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    if approx:
        np.testing.assert_allclose(p_t, p_j, equal_nan=True, **TOL)
    else:
        np.testing.assert_array_equal(p_t, p_j)  # counting: exactly equal
    assert np.isnan(p_t[1, 1]) and np.isfinite(p_t[2, 2])
    with pytest.raises(ValueError):
        t_asl.asl_counting(torch.tensor(coef), "jackknife", approx)


def test_fill_invalid_semantics(rng):
    vals = rng.normal(size=(3, 4, 50)).astype(np.float32)
    valid = vals > 0
    valid[2, 1] = False  # a dead row
    filled, dead = t_ht.fill_invalid(generator(0, "cpu"), torch.tensor(vals),
                                     torch.tensor(valid))
    filled, dead = filled.numpy(), dead.numpy()
    _, dead_j = j_ht.fill_invalid(jax.random.key(0), jnp.asarray(vals),
                                  jnp.asarray(valid))
    np.testing.assert_array_equal(dead, np.asarray(dead_j))
    for i in range(3):
        for j in range(4):
            if dead[i, j]:
                continue
            v = valid[i, j]
            np.testing.assert_array_equal(filled[i, j][v], vals[i, j][v])
            assert np.isin(filled[i, j][~v], vals[i, j][v]).all()
    # identity when every entry is valid
    same, none_dead = t_ht.fill_invalid(
        generator(1, "cpu"), torch.tensor(vals), torch.ones(3, 4, 50, dtype=bool))
    assert torch.equal(same, torch.tensor(vals)) and not none_dead.any()


def test_gev_refine_batch_matches_jax(rng):
    b = 1000
    stats = np.array([4.0, -3.5, 0.3, 5.0])
    nulls = rng.normal(0, 1, (4, b))
    nulls[3, 10] = np.nan  # takes the serial scipy path
    fallback = np.full(4, 1.0 / (b + 1))
    want = j_gev.gev_refine_batch(stats, nulls, fallback)
    got = t_gev.gev_refine_batch(stats, nulls, fallback)
    np.testing.assert_array_equal(got, want)
    assert t_asl.gev_refine(4.0, nulls[0], 0.5) == j_asl.gev_refine(
        4.0, nulls[0], 0.5)


def test_contrast_free_treatment_is_nan(rng):
    """Every surviving group in one arm: no residual contrast -> NaN, with a
    covariate whose ridge residual varies."""
    R, B = 4, 200
    covariate = np.column_stack([np.ones(R), [0.2, 0.7, 1.3, 0.4]])
    stats = rng.normal(0, 1, (R, B + 1))
    weights = np.array([100.0, 120.0, 90.0, 110.0])
    coef = t_reg.meta_regress(
        torch.tensor(covariate, dtype=torch.float32),
        torch.ones(R, 1), torch.tensor(stats, dtype=torch.float32),
        torch.tensor(weights, dtype=torch.float32), one_sample=False)
    assert torch.isnan(coef).all()


def test_one_sample_decision_after_group_drop():
    """Dropping every contrast-arm group makes a gene one-sample; treatment
    padding columns are ignored in per-gene mode."""
    treat = np.zeros((3, 4, 2), np.float32)
    treat[:, 2:, 0] = 1.0
    treat[2, :, 1] = 1.0  # gene 2: a second, all-ones column
    good = np.ones((3, 4), bool)
    good[1, :2] = False  # gene 1 loses its zero-arm groups
    for padded in (False, True):
        want = np.asarray(j_ht._dynamic_one_sample(
            jnp.asarray(treat), jnp.asarray(good), padded))
        got = t_ht._dynamic_one_sample(torch.tensor(treat), torch.tensor(good),
                                       padded).numpy()
        np.testing.assert_array_equal(got, want)
    assert got.tolist() == [False, True, False]
