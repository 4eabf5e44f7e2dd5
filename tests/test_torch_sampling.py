"""The cascade bootstrap: the port's plain version and its CUDA kernel.

The plain PyTorch cascade (``memento_tpu_torch.ops.sampling``) is held
against the JAX package's XLA cascade, its statistical reference (the Pallas
kernel's PRNG is stubbed to zeros in interpret mode, so it is not run here),
and against numpy's exact multinomial.  The CUDA kernel's own tests are in
``tests/test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memento_tpu.ops import sampling as j_sampling
from memento_tpu.ops.estimators import HYPER_RELATIVE as J_HYPER
from memento_tpu.ops.bootstrap import bootstrap_1d as j_bootstrap_1d

from memento_tpu_torch.ops import sampling
from memento_tpu_torch.ops.bootstrap import bootstrap_1d
from memento_tpu_torch.ops.estimators import HYPER_RELATIVE

# tier-1 runs several pytest workers at once: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)


def _tile(rng, t=10, u=24, n=20000):
    """Rows with one large bin and many small ones (the shape compression
    produces: a big zero-value bin and a tail of rare combos)."""
    counts = np.zeros((t, u), np.float32)
    for i in range(t):
        k = rng.integers(10, u)
        small = rng.integers(1, 40, size=k - 1).astype(np.float32)
        counts[i, 1:k] = small
        counts[i, 0] = n - small.sum()
    return counts


def test_poisson_cdf_table_matches_jax():
    lam = np.array([0.0, 0.3, 1.0, 4.5, 7.9], np.float32)
    want = np.asarray(j_sampling.poisson_cdf_table(jnp.asarray(lam)))
    got = sampling.poisson_cdf_table(torch.tensor(lam)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("w_dim", [1, 2])
def test_conservation_per_row_n(rng, w_dim):
    """Every replicate's weight-1 sum is its row's N, rows of different N."""
    counts = _tile(rng, t=6, u=20, n=1000)
    counts[2] *= 3
    n_rows = counts.sum(1)
    w = np.ones((6, 20, w_dim), np.float32)
    sums = sampling.fused_bootstrap_sums(torch.tensor(counts), torch.tensor(w),
                                         torch.tensor(n_rows), 90, 5).numpy()
    assert sums.shape == (6, w_dim, 90)
    np.testing.assert_allclose(sums, np.broadcast_to(
        n_rows[:, None, None], sums.shape), rtol=1e-5)


def test_padded_bins_inert(rng):
    """Zero-count bins draw 0: weight on them never reaches the sums."""
    counts = _tile(rng, t=5, u=16, n=3000)
    padded = np.zeros((5, 40), np.float32)
    padded[:, ::2][:, :16] = counts  # interleaved and trailing padding
    w = np.ones((5, 40, 1), np.float32)
    w[padded == 0] = 1e6
    sums = sampling.fused_bootstrap_sums(torch.tensor(padded), torch.tensor(w),
                                         3000.0, 64, 2).numpy()
    np.testing.assert_allclose(sums[:, 0], 3000.0, rtol=1e-5)


def test_all_small_bins(rng):
    """Every occupied bin below the Gaussian boundary: the table branch
    alone still conserves."""
    t, u = 8, 48
    counts = np.zeros((t, u), np.float32)
    for i in range(t):
        k = int(rng.integers(12, u))
        counts[i, :k] = rng.integers(1, 7, size=k)
    n_rows = counts.sum(1)
    w = np.ones((t, u, 2), np.float32)
    sums = sampling.fused_bootstrap_sums(torch.tensor(counts), torch.tensor(w),
                                         torch.tensor(n_rows), 70, 9).numpy()
    np.testing.assert_allclose(sums, np.broadcast_to(
        n_rows[:, None, None], sums.shape), rtol=1e-5)


def _assert_same_law(a, b, tol=0.15):
    """Per row and weight: mean within ``tol`` sd, sd ratio within tol."""
    for i in range(a.shape[0]):
        for wi in range(a.shape[1]):
            sd = a[i, wi].std()
            assert abs(a[i, wi].mean() - b[i, wi].mean()) < tol * sd + 1e-6
            assert abs(b[i, wi].std() / sd - 1) < tol


def test_matches_jax_cascade_distribution(rng):
    n, B = 20000, 2000
    counts = _tile(rng, t=8, u=32, n=n)
    w = rng.random((8, 32, 2)).astype(np.float32)
    want = np.asarray(j_sampling.fused_bootstrap_sums(
        jax.random.key(0), jnp.asarray(counts), jnp.asarray(w), float(n), B,
        "cascade"))
    got = sampling.fused_bootstrap_sums(torch.tensor(counts), torch.tensor(w),
                                        float(n), B, 1).numpy()
    _assert_same_law(want, got)


def test_matches_exact_multinomial(rng):
    n, B = 5000, 2000
    counts = _tile(rng, t=4, u=24, n=n)
    w = rng.random((4, 24, 2)).astype(np.float32)
    probs = counts.astype(np.float64) / n
    exact = np.stack([
        np.einsum("bu,uw->wb", rng.multinomial(n, probs[i], size=B), w[i])
        for i in range(4)
    ])
    got = sampling.fused_bootstrap_sums(torch.tensor(counts), torch.tensor(w),
                                        float(n), B, 3).numpy()
    _assert_same_law(exact, got)


def test_bootstrap_1d_matches_jax_moments(rng):
    """Replicate means/variances of one group agree in distribution."""
    t, u, n = 6, 24, 4000
    counts = _tile(rng, t=t, u=u, n=n)
    values = np.tile(np.arange(u, dtype=np.float32), (t, 1))
    inv_sf = rng.uniform(0.6, 1.6, (t, u)).astype(np.float32)
    args = (values, counts, inv_sf, inv_sf * inv_sf)
    jm, jv = j_bootstrap_1d(jax.random.key(2), *map(jnp.asarray, args),
                            float(n), 0.1, J_HYPER, 2000, "cascade")
    tm, tv = bootstrap_1d(*map(torch.tensor, args), float(n), 0.1,
                          HYPER_RELATIVE, 2000, 4)
    want = np.stack([np.asarray(jm), np.asarray(jv)], 1)
    got = np.stack([tm.numpy(), tv.numpy()], 1)
    _assert_same_law(want, got)
