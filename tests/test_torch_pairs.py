"""Host side of the 2D slice: the pair packer, pair covariances, the
covariance -> correlation sentinel, and the correlation matrix.

Each function of ``memento_tpu_torch`` gets the same numpy-seeded inputs as
its counterpart in the JAX package.  Compression is exact (field for field
equal); float64 host stages agree to rtol 1e-10; the float32 Gram matrix
agrees to atol 1e-5 with an equal NaN pattern.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sparse
import torch

from memento_tpu import api as j_api
from memento_tpu.ops import compress as j_compress
from memento_tpu.ops import corr as j_corr
from memento_tpu.ops import estimators as j_est
from memento_tpu.ops import size_factor as j_sf
from memento_tpu.ops import transport as j_transport

from memento_tpu_torch import api as t_api
from memento_tpu_torch.convert import from_jax_outputs
from memento_tpu_torch.ops import compress as t_compress
from memento_tpu_torch.ops import corr as t_corr
from memento_tpu_torch.ops import estimators as t_est
from memento_tpu_torch.ops import transport as t_transport

# the suite runs under several pytest workers at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

PAIR_FIELDS = ("values_1", "values_2", "counts", "inv_sf", "inv_sf_sq",
               "n_unique", "sf_bin", "bin_inv_sf")


def _counts(rng, n=400, g=24):
    lam = rng.gamma(2.0, rng.uniform(0.1, 4.0, g) / 2.0, size=(n, g))
    X = rng.poisson(lam).astype(np.float64)
    X[:, 3] = 0.0  # an all-zero gene
    return sparse.csc_matrix(X)


def _pairs(rng, g, n):
    """Random pairs plus a duplicate, a reversed pair, a self-pair and pairs
    with the all-zero gene 3."""
    idx1 = rng.integers(0, g, n)
    idx2 = rng.integers(0, g, n)
    idx1 = np.r_[idx1, idx1[0], idx2[1], 5, 3, 7, 3]
    idx2 = np.r_[idx2, idx2[0], idx1[1], 5, 9, 3, 3]
    return idx1, idx2


@pytest.mark.parametrize("backend", ["numpy", "loop", "auto"])
def test_compress_pairs_exact(rng, backend):
    """Every field equals the JAX package's numpy packer, exactly."""
    X = _counts(rng, n=500, g=30)
    X.data[::11] = 140.0  # values above the int8 range
    approx = j_sf.bin_size_factor(rng.uniform(0.4, 2.5, X.shape[0]), 30)
    idx1, idx2 = _pairs(rng, 30, 20)
    want = j_compress.compress_pairs(X, approx, idx1, idx2, backend="numpy")
    got = t_compress.compress_pairs(X, approx, idx1, idx2, backend=backend)
    for field in PAIR_FIELDS:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert got.n_obs == want.n_obs
    assert got.padded_u == want.counts.shape[1]
    # every row conserves the group's cells
    np.testing.assert_array_equal(got.counts.sum(1), X.shape[0])


def test_compress_pairs_without_compact_form(rng):
    """More than 254 size-factor bins: no uint8 ids, as in the JAX package."""
    X = _counts(rng, n=600, g=8)
    approx = rng.uniform(0.5, 2.0, 600)  # every cell its own bin
    want = j_compress.compress_pairs(X, approx, [0, 1], [2, 5],
                                     backend="numpy")
    got = t_compress.compress_pairs(X, approx, [0, 1], [2, 5])
    assert got.sf_bin is None and got.bin_inv_sf is None
    assert want.sf_bin is None
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.inv_sf, want.inv_sf)


def test_compress_pairs_backends_refused(rng):
    """An unknown backend is refused; ``native`` runs the C++ packer, which
    equals the numpy packer slot for slot."""
    X = _counts(rng, n=50, g=6)
    approx = np.ones(50)
    with pytest.raises(ValueError, match="backend"):
        t_compress.compress_pairs(X, approx, [0], [1], backend="fast")
    got = t_compress.compress_pairs(X, approx, [0, 2], [1, 2],
                                    backend="native")
    want = t_compress.compress_pairs(X, approx, [0, 2], [1, 2],
                                     backend="numpy")
    for field in PAIR_FIELDS:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


@pytest.mark.parametrize("backend", ["numpy", "auto", "native"])
def test_compress_pairs_code_overflow_falls_through(rng, backend):
    """Counts near 3e8 overflow the joint int64 code space of the one-sort
    packer over four pairs (not that of a single pair): ``numpy`` falls
    through to the loop, as the JAX package does, and every backend gives
    the JAX package's tiles."""
    X = _counts(rng, n=300, g=8)
    X.data[::5] = rng.integers(2e8, 3e8, X.data[::5].size)
    approx = j_sf.bin_size_factor(rng.uniform(0.4, 2.5, X.shape[0]), 30)
    idx1, idx2 = [0, 1, 2, 4], [5, 6, 7, 4]
    with pytest.raises(OverflowError):
        t_compress._compress_pairs_vectorized(X, approx, idx1, idx2, 8, 8)
    want = j_compress.compress_pairs(X, approx, idx1, idx2, backend="numpy")
    got = t_compress.compress_pairs(X, approx, idx1, idx2, backend=backend)
    for field in PAIR_FIELDS:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert got.values_1.max() > 1e8


@pytest.mark.parametrize("estimator", ["hyper_relative", "poi_relative"])
def test_cov_sparse_pairs_matches_jax(rng, estimator):
    """Host float64 on both sides: rtol 1e-10 (same-gene pairs included)."""
    X = _counts(rng)
    sf = rng.uniform(0.5, 2.0, X.shape[0])
    idx1, idx2 = _pairs(rng, X.shape[1], 30)
    want = j_corr.cov_sparse_pairs(X, sf, 0.15, idx1, idx2,
                                   j_est.get_noise_model(estimator))
    got = t_corr.cov_sparse_pairs(X, sf, 0.15, idx1, idx2,
                                  t_est.get_noise_model(estimator))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)
    dense = t_corr.cov_sparse_pairs(X.toarray(), sf, 0.15, idx1, idx2,
                                    t_est.get_noise_model(estimator))
    np.testing.assert_allclose(dense, want, rtol=1e-10, atol=1e-14)


def _grid():
    """(cov, var_1, var_2) over valid, zero, negative and NaN variances and
    a NaN covariance."""
    var = np.array([0.5, 2.0, 0.0, -1.0, np.nan])
    cov = np.array([0.3, -0.4, 5.0, 0.0, np.nan])
    c, v1, v2 = np.meshgrid(cov, var, var, indexing="ij")
    return c.ravel(), v1.ravel(), v2.ravel()


def test_corr_from_cov_np_matches_jax():
    cov, v1, v2 = _grid()
    want = j_api._corr_from_cov_np(cov, v1, v2)
    got = t_api._corr_from_cov_np(cov, v1, v2)
    np.testing.assert_allclose(got, want, rtol=1e-10, equal_nan=True)


def test_corr_from_cov_sentinels_exact():
    """The tensor version equals the JAX function exactly on the grid: 1.0
    for an invalid variance, NaN only for a NaN covariance with valid
    variances, clipped to [-1, 1] otherwise."""
    cov, v1, v2 = (x.astype(np.float32) for x in _grid())
    want = np.asarray(j_est.corr_from_cov(jnp.asarray(cov), jnp.asarray(v1),
                                          jnp.asarray(v2)))
    got = t_est.corr_from_cov(torch.tensor(cov), torch.tensor(v1),
                              torch.tensor(v2)).numpy()
    np.testing.assert_array_equal(got, want)
    invalid = ~(v1 > 0) | ~(v2 > 0)
    assert (got[invalid] == 1.0).all()
    assert np.isnan(got[~invalid & np.isnan(cov)]).all()
    assert np.nanmax(np.abs(got)) == 1.0  # cov 5 with small variances clips


@pytest.mark.parametrize("row_block", [None, 7])
def test_corr_matrix_matches_jax(rng, row_block):
    """The float32 Gram matrix with Kahan accumulation over 5 cell blocks and
    the host float64 finish: atol 1e-5 against the JAX package (both sum
    float32 products, in a different order), NaN pattern equal."""
    X = _counts(rng, n=600, g=20).tocsr()
    sf = rng.uniform(0.5, 2.0, 600)
    _, var = j_est.mean_var_sparse(X, sf, 0.1)
    var = np.asarray(var).copy()
    var[5] = -0.1  # an invalid variance beside the all-zero gene's 0
    want = j_corr.corr_matrix_device(X, sf, 0.1, var, j_est.HYPER_RELATIVE,
                                     block=128, row_block=row_block)
    got = t_corr.corr_matrix_device(X, sf, 0.1, var, t_est.HYPER_RELATIVE,
                                    block=128, row_block=row_block,
                                    device="cpu")
    assert got.shape == (20, 20) and got.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[3]).all() and np.isnan(got[:, 5]).all()
    np.testing.assert_allclose(got, want, atol=1e-5, equal_nan=True)
    ok = ~np.isnan(np.diag(got))
    np.testing.assert_allclose(np.diag(got)[ok], 1.0, atol=1e-4)
    # dense float input and a float32 result
    dense = t_corr.corr_matrix_device(X.toarray(), sf, 0.1, var,
                                      t_est.HYPER_RELATIVE, block=128,
                                      out_dtype=np.float32, device="cpu")
    assert dense.dtype == np.float32
    np.testing.assert_allclose(dense, got, atol=1e-6, equal_nan=True)


def test_corr_matrix_entries_equal_pair_path(rng):
    """Off-diagonal entries of the matrix are the pair path's correlations
    (host float64) to the float32 Gram's accuracy, atol 1e-5, wherever the
    pair path's value is not clipped."""
    X = _counts(rng, n=800, g=16).tocsr()
    sf = rng.uniform(0.5, 2.0, 800)
    _, var = t_est.mean_var_sparse(X, sf, 0.1)
    mat = t_corr.corr_matrix_device(X, sf, 0.1, var, t_est.HYPER_RELATIVE,
                                    block=256, device="cpu")
    idx1, idx2 = np.triu_indices(16, k=1)
    cov = t_corr.cov_sparse_pairs(X, sf, 0.1, idx1, idx2, t_est.HYPER_RELATIVE)
    pair = t_api._corr_from_cov_np(cov, var[idx1], var[idx2])
    ok = np.isfinite(mat[idx1, idx2]) & (np.abs(pair) < 1)
    assert ok.sum() > 80
    np.testing.assert_allclose(mat[idx1, idx2][ok], pair[ok], atol=1e-5)


def test_finish_corr_rows_matches_jax(rng):
    g = 9
    A = rng.normal(size=(40, g))
    S = (A.T @ A).astype(np.float32)
    s1 = A.sum(0).astype(np.float32)
    sdiag = np.abs(A).sum(0).astype(np.float32)
    var = rng.uniform(-0.2, 2.0, g)
    for r0, r1 in ((0, g), (3, 7)):
        want = j_corr.finish_corr_rows(S[r0:r1], r0, s1, sdiag, var, 40, 0.9)
        got = t_corr.finish_corr_rows(S[r0:r1], r0, s1, sdiag, var, 40, 0.9)
        np.testing.assert_allclose(got, want, rtol=1e-12, equal_nan=True)
    np.testing.assert_array_equal(
        t_corr.finish_corr_host(S, s1, sdiag, var, 40, 0.9),
        t_corr.finish_corr_rows(S, 0, s1, sdiag, var, 40, 0.9))


def test_gram_update_keeps_full_float32_and_restores_tf32(rng):
    """The compensated sum of many blocks equals the float64 Gram matrix to
    float32 rounding of the result, not of the block count; the caller's
    TF32 setting is restored."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with t_corr._full_float32_matmul():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    x = rng.poisson(3.0, size=(64 * 40, 6)).astype(np.float32)
    stats = [torch.zeros(6, 6), torch.zeros(6), torch.zeros(6),
             torch.zeros(6, 6), torch.zeros(6), torch.zeros(6)]
    ones = torch.ones(40)
    for b in range(64):
        stats = list(t_corr._gram_update(
            torch.tensor(x[b * 40:(b + 1) * 40]).to(torch.int8), ones, ones,
            *stats))
    exact = x.astype(np.float64).T @ x.astype(np.float64)
    np.testing.assert_allclose(stats[0].numpy(), exact, rtol=2e-7)
    np.testing.assert_allclose(stats[1].numpy(), x.sum(0, dtype=np.float64),
                               rtol=2e-7)


def test_compact_transport_dtype_matches_jax():
    cases = [
        sparse.csr_matrix(np.array([[0.0, 3.0], [127.0, 0.0]])),
        sparse.csr_matrix(np.array([[0.0, 128.0], [1.0, 0.0]])),
        sparse.csr_matrix(np.array([[0.0, 40000.0], [1.0, 0.0]])),
        sparse.csr_matrix(np.array([[0.5, 0.0], [1.0, 0.0]])),
        sparse.csr_matrix(np.array([[-1.0, 0.0], [1.0, 0.0]])),
        sparse.csr_matrix(np.array([[2.0**25, 0.0], [1.0, 0.0]])),
        sparse.csr_matrix((2, 2)),
        np.ones((2, 2)),
    ]
    for X in cases:
        assert t_transport.compact_transport_dtype(X) == \
            j_transport.compact_transport_dtype(X)
    assert t_transport.compact_transport_dtype(cases[0]) == np.int8


def test_convert_carries_pair_groups_and_2d_moments(rng):
    X = _counts(rng, n=300, g=10)
    approx = j_sf.bin_size_factor(rng.uniform(0.5, 2.0, 300), 30)
    pairs = [j_compress.compress_pairs(X, approx, [0, 1, 2], [4, 5, 6],
                                       backend="numpy")]
    uns = {"2d_moments": {
        "gene_pairs": [("a", "b"), ("c", "d")],
        "gene_idx_1": np.array([0, 2]), "gene_idx_2": np.array([1, 3]),
        "sg^x": {"cov": [0.1, 0.2], "corr": [0.5, 1.0],
                 "var_1": [1.0, 2.0], "var_2": [3.0, -1.0]}}}
    out = from_jax_outputs(compressed_pairs=pairs, memento_uns=uns)
    got = out["compressed_pairs"][0]
    assert isinstance(got, t_compress.CompressedPairGroup)
    for field in PAIR_FIELDS:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(pairs[0], field))
    m2 = out["2d_moments"]
    assert m2["gene_pairs"] == uns["2d_moments"]["gene_pairs"]
    np.testing.assert_array_equal(m2["gene_idx_2"], [1, 3])
    assert set(m2["sg^x"]) == {"cov", "corr", "var_1", "var_2"}
    assert m2["sg^x"]["corr"].dtype == np.float64
    assert "compressed" not in out
