"""The CUDA cascade-bootstrap kernel and its wrapper.

The wrapper runs the plain PyTorch version for CPU tensors (tested
everywhere) and launches the kernel for CUDA tensors; the kernel has no CPU
mode, so its tests skip without a card.  On the card the kernel is held
against the plain version in distribution and, on its own Philox stream
(``fused_bootstrap_sums_philox``), sum by sum.  This file imports neither
JAX nor the JAX package, so it also runs on the card's machine, which has
neither:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from memento_tpu_torch.ops import cuda_kernels, kernel_build, sampling
from memento_tpu_torch.utils import sass_count

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


def test_sass_count_sorts_a_listing_by_pipe_and_loop():
    listing = """
	Function : _Z6kernelILi5EEvPf
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   IMAD.WIDE.U32 R4, R0, R1, RZ ;
        /*0020*/                   FFMA R2, R0, R0, R1 ;
        /*0030*/                   LDS R3, [R2] ;
        /*0040*/                   MUFU.LG2 R3, R3 ;
        /*0050*/              @P0  BRA 0x20 ;
        /*0060*/                   EXIT ;
	Function : other
        /*0000*/                   EXIT ;
"""
    first, second = sass_count.count_listing(listing)
    assert first["kernel"] == "_Z6kernelILi5EEvPf" and first["count"] == 7
    assert first["by_pipe"] == {"control": 2, "constant": 1, "imad": 1,
                                "fp32": 1, "shared": 1, "special": 1}
    assert first["loops"] == [{
        "from": "0x20", "to": "0x50", "count": 4,
        "by_pipe": {"fp32": 1, "shared": 1, "special": 1, "control": 1}}]
    assert second == {"kernel": "other", "count": 1,
                      "by_pipe": {"control": 1}, "loops": []}


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


def _same_seed(counts, w, n_rows, num_boot=256, seed=21):
    """Kernel and plain version on the kernel's own Philox stream: the sums'
    relative differences, element by element."""
    k = cuda_kernels.fused_bootstrap_sums_cuda(counts, w, n_rows, num_boot,
                                               seed)
    p = sampling.fused_bootstrap_sums_philox(counts, w, n_rows, num_boot,
                                             seed)
    assert k.shape == p.shape and bool(torch.isfinite(k).all())
    return ((k - p).abs() / p.abs().clamp_min(1e-6)).cpu().numpy()


@pytest.mark.parametrize("w_dim", [1, 2, 5])
def test_kernel_replays_its_philox_stream_on_card(rng, cuda_device, w_dim):
    """Same seed, draw by draw: float32 rounding and a few flipped roundings
    of Gaussian draws (each 1/N of a sum, 5e-5 to 1.4e-4 here) are all that
    may differ; a word used twice or skipped would move most sums by
    ~1/sqrt(N), about 1e-2."""
    counts = np.concatenate([_tile(rng, t=5, u=300, n=20000),
                             _pair_tile(rng, t=5, u=600, n=7000)[:, :300],
                             _pair_tile(rng, t=6, u=300, n=9000)])
    assert len(set((counts > 0).sum(1) % 4)) > 1  # ragged row ends
    n_rows = torch.tensor(counts.sum(1), device=cuda_device)
    c = torch.tensor(counts, device=cuda_device)
    w = torch.rand(*counts.shape, w_dim, device=cuda_device) + 0.5
    rel = _same_seed(c, w, n_rows)
    assert np.median(rel) <= 1e-5
    assert (rel <= 5e-4).mean() >= 0.99


@pytest.mark.parametrize("case", [
    "one_bin", "empty_row", "end_1", "end_2", "end_3", "end_65",
    "table_bin_in_last_group", "interior_gaps", "45_chunks", "all_gaussian",
])
def test_kernel_row_tails_on_card(rng, cuda_device, case):
    """Rows that end inside a group of four or a chunk of 64, a row with one
    occupied bin (absorbing at u = 0), an empty row, gaps, and 2,880 bins:
    exact conservation, zeros for the empty row, and the plain version's
    sums on the same Philox stream."""
    u = 2880 if case == "45_chunks" else 192
    counts = np.zeros((4, u), np.float32)
    if case == "one_bin":
        counts[:, 0] = [7.0, 500.0, 1.0, 30000.0]
    elif case == "empty_row":
        counts[0, :5] = [400, 30, 5, 2, 1]
        counts[2, :70] = rng.integers(1, 30, 70)
        counts[3, :3] = [9, 9, 9]  # row 1 stays empty
    elif case.startswith("end_"):
        k = int(case.split("_")[1])
        counts[:, :k] = rng.integers(1, 40, (4, k))
        counts[:, 0] += 3000
    elif case == "table_bin_in_last_group":
        counts[:, :9] = [900, 40, 12, 9, 8, 3, 2, 1, 1]
        counts[1, :66] = np.r_[2000, rng.integers(1, 7, 65)]
    elif case == "interior_gaps":
        counts[:, 0:120:3] = rng.integers(1, 50, (4, 40))
        counts[:, 0] += 5000
        counts[2, 4:8] = 0  # a whole group of four empty
    elif case == "45_chunks":
        counts[:, :2880] = rng.integers(1, 12, (4, 2880))
        counts[:, :6] += 4000
        counts[1, 2817:] = 0  # ends one bin into the last chunk
    elif case == "all_gaussian":
        counts[:, :37] = rng.integers(8, 400, (4, 37))
    c = torch.tensor(counts, device=cuda_device)
    n_rows = c.sum(1)
    w = torch.rand(4, u, 2, device=cuda_device) + 0.5
    w[..., 0] = 1.0
    k = cuda_kernels.fused_bootstrap_sums_cuda(c, w, n_rows, 300, 3)
    tol = 1e-5 if u < 2000 else 3 * np.finfo(np.float32).eps * np.sqrt(u)
    np.testing.assert_allclose(
        k[:, 0].cpu().numpy(),
        np.broadcast_to(n_rows.cpu().numpy()[:, None], (4, 300)), rtol=tol)
    if case == "empty_row":
        assert float(k[1].abs().max()) == 0.0
    if case == "one_bin":  # absorbing at u = 0: every sum is w * N exactly
        np.testing.assert_allclose(
            k[:, 1].cpu().numpy(),
            np.broadcast_to((w[:, 0, 1] * n_rows).cpu().numpy()[:, None],
                            (4, 300)), rtol=1e-6)
    rel = _same_seed(c, w, n_rows, num_boot=300, seed=3)
    assert np.median(rel) <= 1e-5
    assert (rel <= 5e-4).mean() >= 0.99


def test_kernel_is_a_function_of_its_seed_on_card(rng, cuda_device):
    counts = _pair_tile(rng, t=8, u=300, n=9000)
    c = torch.tensor(counts, device=cuda_device)
    w = torch.rand(8, 300, 5, device=cuda_device)
    n_rows = c.sum(1)
    a = cuda_kernels.fused_bootstrap_sums_cuda(c, w, n_rows, 1000, 5)
    assert torch.equal(
        a, cuda_kernels.fused_bootstrap_sums_cuda(c, w, n_rows, 1000, 5))
    b2 = cuda_kernels.fused_bootstrap_sums_cuda(c, w, n_rows, 2000, 5)
    assert torch.equal(a, b2[..., :1000])
    assert not torch.equal(
        a, cuda_kernels.fused_bootstrap_sums_cuda(c, w, n_rows, 1000, 6))
    # the rows' order of execution does not change a row's result
    by_index = cuda_kernels.launch_cascade(
        c, w, n_rows, cuda_kernels.cascade_inputs(c, longest_first=False),
        1000, 5)
    assert torch.equal(a, by_index)


# Fills the whole of every SM's shared memory with one bit pattern, as an
# earlier kernel of another program might leave it.
_POISON_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
extern __shared__ uint32_t words[];
__global__ void poison(int n_words, uint32_t pattern) {
  volatile uint32_t* w = words;
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) w[i] = pattern;
}
extern "C" int poison_shared(int blocks, unsigned pattern) {
  int dev = 0, bytes = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(
        poison, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return rc;
  poison<<<blocks, 256, bytes>>>(bytes / 4, pattern);
  rc = cudaGetLastError();
  return rc != cudaSuccess ? rc : cudaDeviceSynchronize();
}
"""


@pytest.fixture(scope="module")
def poison_shared(tmp_path_factory):
    """``poison_shared(pattern)``: every SM's shared memory set to a 32-bit
    pattern (one block per SM takes all of it; eight blocks per SM go)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    build = tmp_path_factory.mktemp("poison")
    (build / "poison.cu").write_text(_POISON_SOURCE)
    flags = [f for f in kernel_build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([kernel_build.nvcc_path(), *flags, "-o",
                    str(build / "libpoison.so"), str(build / "poison.cu")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(build / "libpoison.so")).poison_shared
    fn.argtypes = [ctypes.c_int, ctypes.c_uint]
    fn.restype = ctypes.c_int
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def run(pattern):
        torch.cuda.synchronize()
        assert fn(8 * n_sm, pattern) == 0

    return run


@pytest.mark.parametrize("pattern", [0xFFFFFFFF, 0xFF800000],
                         ids=["nan", "minus_inf"])
@pytest.mark.parametrize("end", [1, 2, 3, 66])
def test_kernel_ignores_stale_shared_memory_on_card(
        rng, cuda_device, poison_shared, end, pattern):
    """Rows that end inside a group of four, launched on shared memory that
    holds NaN or -inf bit patterns: the bins between the row's end and the
    end of its group draw 0, and 0 times a stale weight must not reach the
    sums.  Enough short rows that every SM takes some; the inputs are made
    before the poison so that no other kernel runs in between."""
    t_dim = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    counts = np.zeros((t_dim, 128), np.float32)
    counts[:, :end] = rng.integers(1, 40, (t_dim, end))
    counts[:, 0] += 3000
    c = torch.tensor(counts, device=cuda_device)
    n_rows = c.sum(1)
    w = torch.rand(t_dim, 128, 2, device=cuda_device) + 0.5
    w[..., 0] = 1.0
    inputs = cuda_kernels.cascade_inputs(c)
    want = sampling.fused_bootstrap_sums_philox(c, w, n_rows, 256, 9)
    poison_shared(pattern)
    k = cuda_kernels.launch_cascade(c, w, n_rows, inputs, 256, 9)
    assert bool(torch.isfinite(k).all())
    np.testing.assert_allclose(
        k[:, 0].cpu().numpy(),
        np.broadcast_to(n_rows.cpu().numpy()[:, None], (t_dim, 256)),
        rtol=1e-5)
    rel = ((k - want).abs() / want.abs().clamp_min(1e-6)).cpu().numpy()
    assert np.median(rel) <= 1e-5
    assert (rel <= 5e-4).mean() >= 0.99
