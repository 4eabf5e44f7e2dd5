"""The CUDA cascade-bootstrap kernel and its wrapper.

The wrapper runs the plain PyTorch version for CPU tensors (tested
everywhere) and launches the kernel for CUDA tensors; the kernel has no CPU
mode, so its tests skip without a card.  This file imports neither JAX nor
the JAX package, so it also runs on the card's machine, which has neither:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from memento_tpu_torch.ops import cuda_kernels, sampling

# tier-1 runs several pytest workers at once: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    """The card, or a skip: kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


def _tile(rng, t, u, n):
    """Rows with one large bin and many small ones."""
    counts = np.zeros((t, u), np.float32)
    for i in range(t):
        k = rng.integers(10, u)
        small = rng.integers(1, 40, size=k - 1).astype(np.float32)
        counts[i, 1:k] = small
        counts[i, 0] = n - small.sum()
    return counts


def _assert_same_law(a, b, tol=0.15):
    """Per row and weight: mean within ``tol`` sd, sd ratio within tol."""
    for i in range(a.shape[0]):
        for wi in range(a.shape[1]):
            sd = a[i, wi].std()
            assert abs(a[i, wi].mean() - b[i, wi].mean()) < tol * sd + 1e-6
            assert abs(b[i, wi].std() / sd - 1) < tol


def test_wrapper_takes_plain_version_for_cpu_tensors(rng):
    counts = torch.tensor(_tile(rng, t=4, u=16, n=500))
    w = torch.rand(4, 16, 2, generator=torch.Generator().manual_seed(0))
    cuda_kernels.reset_launches()
    got = cuda_kernels.fused_bootstrap_sums_cuda(counts, w, 500.0, 33, 8)
    want = sampling.fused_bootstrap_sums(counts, w, 500.0, 33, 8)
    assert torch.equal(got, want)
    assert cuda_kernels.LAUNCHES["cascade_bootstrap"] == 0
    assert not any(cuda_kernels.LAUNCHES_BY_W.values())


def test_wrapper_refuses_other_devices():
    counts = torch.ones(2, 4, device="meta")
    with pytest.raises(ValueError, match="device"):
        cuda_kernels.fused_bootstrap_sums_cuda(
            counts, torch.ones(2, 4, 1, device="meta"), 4.0, 8, 0)


def _pair_tile(rng, t, u, n):
    """Rows shaped like a joint pair compression: a few large zero-zero
    bins first, then hundreds of bins with counts below 8 (the table
    branch), so the absorbing last bin is a small one."""
    counts = np.zeros((t, u), np.float32)
    for i in range(t):
        k = rng.integers(u // 2, u)
        small = rng.integers(1, 8, size=k - 4).astype(np.float32)
        counts[i, 4:k] = small
        counts[i, :4] = (n - small.sum()) / 4
    return counts


@pytest.mark.parametrize("w_dim", [1, 2, 5])
def test_kernel_matches_plain_on_card(rng, cuda_device, w_dim):
    """The kernel against its plain version on the card: exact conservation
    and the same law, including rows longer than 256 bins.  W = 1 and 2 get
    the 1D shape (one large bin, counts up to 40); W = 5 gets the 2D shape,
    dominated by counts below 8."""
    if w_dim == 5:
        counts = np.concatenate([_pair_tile(rng, t=6, u=600, n=20000),
                                 _pair_tile(rng, t=6, u=600, n=7000)])
        assert ((counts > 0) & (counts < 8)).sum() > 0.9 * (counts > 0).sum()
    else:
        counts = np.concatenate([_tile(rng, t=6, u=300, n=20000),
                                 _tile(rng, t=6, u=300, n=7000)])
    n_rows = torch.tensor(counts.sum(1), device=cuda_device)
    c = torch.tensor(counts, device=cuda_device)
    w = torch.rand(*counts.shape, w_dim, device=cuda_device)
    w[..., 0] = 1.0
    cuda_kernels.reset_launches()
    k = cuda_kernels.fused_bootstrap_sums_cuda(c, w, n_rows, 2000, 1)
    assert cuda_kernels.LAUNCHES["cascade_bootstrap"] == 1
    assert cuda_kernels.LAUNCHES_BY_W == {
        w_: int(w_ == w_dim) for w_ in cuda_kernels.SUPPORTED_W}
    p = sampling.fused_bootstrap_sums(c, w, n_rows, 2000, 2)
    k, p = k.cpu().numpy(), p.cpu().numpy()
    n = n_rows.cpu().numpy()[:, None]
    np.testing.assert_allclose(k[:, 0], np.broadcast_to(n, k[:, 0].shape),
                               rtol=1e-5)
    _assert_same_law(p, k)


def test_kernel_checks_its_inputs_on_card(cuda_device):
    c = torch.ones(3, 8, device=cuda_device)
    with pytest.raises(ValueError, match="W=3"):
        cuda_kernels.fused_bootstrap_sums_cuda(
            c, torch.ones(3, 8, 3, device=cuda_device), 8.0, 16, 0)
    with pytest.raises(TypeError):
        cuda_kernels.fused_bootstrap_sums_cuda(
            c.double(), torch.ones(3, 8, 1, device=cuda_device), 8.0, 16, 0)
