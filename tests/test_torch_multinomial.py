"""The exact multinomial sampler: its CUDA kernel, the kernel's plain
version, and the ``torch.binomial`` chain it replaces on the card.

On the CPU: the plain version on the kernel's Philox stream
(``sampling.fused_multinomial_sums_philox``) is held to the exact law
(chi-square against Binomial(N, p) in the inversion and the BTRS regimes
and at p > 0.5, absorbing and empty bins, conservation, independence of the
replicate count), and ``sampler="multinomial"`` on CPU tensors is pinned to
the chain's outputs bit for bit.  On the card (skipped without one): the
kernel against its plain version draw by draw, against the chain in
distribution, bit for bit with itself, and its input checks.  This file
imports neither JAX nor the JAX package, so it also runs on the card's
machine:

    python -m pytest --noconftest -p no:cacheprovider -s tests/test_torch_multinomial.py
"""

import hashlib

import numpy as np
import pytest
import torch
from scipy import stats

from memento_tpu_torch.device import generator
from memento_tpu_torch.drivers._data import multinomial_counts
from memento_tpu_torch.inference import ht
from memento_tpu_torch.ops import bootstrap, cuda_kernels, estimators
from memento_tpu_torch.ops import sampling
from memento_tpu_torch.utils import profiling

# tier-1 runs several pytest workers at once: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

# share of replicates whose kernel sums may differ from the plain version's
# beyond float32 rounding: a rejection or waiting-time decision flipped by
# the last bit of a logarithm (logf / log1pf on the card, the host's on the
# CPU) changes that replicate's chain from there on
FLIP_SHARE = 1e-3


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    """The card, or a skip: kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


def _gene_tile(rng, t, n):
    """1D rows of one group of ``n`` cells (``_data.multinomial_counts``)."""
    return multinomial_counts(rng, t, n, pair=False)


def _pair_tile(rng, t, n):
    """2D rows of one group of ``n`` cells."""
    return multinomial_counts(rng, t, n, pair=True)


def _sums(fn, counts, weights, num_boot, seed, device="cpu"):
    c = torch.as_tensor(counts, device=device)
    w = torch.as_tensor(weights, device=device).contiguous()
    return fn(c, w, c.sum(1), num_boot, seed)


# --- the plain version on the kernel's stream: the exact law (CPU) --------

@pytest.mark.parametrize("counts, n, p, read", [
    ([3, 27], 30, 0.1, 0),  # inversion (N q < 10)
    ([300, 700], 1000, 0.3, 0),  # BTRS
    ([36, 4], 40, 0.9, 0),  # p > 0.5: N minus an inversion draw at q = 0.1
    ([3500, 1500], 5000, 0.7, 0),  # p > 0.5: N minus a BTRS draw
    ([20, 30, 50], 100, 0.3, 1),  # a later bin's marginal, through the chain
], ids=["inversion", "btrs", "inversion_flip", "btrs_flip", "second_bin"])
def test_philox_sums_have_the_binomial_marginal(counts, n, p, read):
    """A one-hot weight column reads one bin's draws: Binomial(N, p) by a
    chi-square over the cells with 5 or more expected draws."""
    num_boot = 20_000
    counts = np.array([counts], np.float32)
    weights = np.zeros((1, counts.shape[1], 1), np.float32)
    weights[0, read, 0] = 1.0
    got = _sums(sampling.fused_multinomial_sums_philox, counts, weights,
                num_boot, 12345)[0, 0].numpy()
    assert np.array_equal(got, np.round(got)) and got.min() >= 0
    k = np.arange(n + 1)
    expected = stats.binom.pmf(k, n, p) * num_boot
    observed = np.bincount(got.astype(int), minlength=n + 1)
    keep = expected >= 5
    # the cells below 5 expected draws pooled into one
    obs = np.r_[observed[keep], observed[~keep].sum()]
    exp = np.r_[expected[keep], expected[~keep].sum()]
    pval = stats.chisquare(obs, exp * obs.sum() / exp.sum()).pvalue
    assert pval > 1e-3, pval


def test_philox_sums_absorb_and_skip_bins():
    """An empty interior bin draws 0; a bin with ratio >= 1 - 1e-6 takes
    every remaining trial, so the bins after it draw 0."""
    counts = np.array([[40, 0, 25, 35, 0],
                       [3, 4_000_000, 1, 0, 0]], np.float32)
    weights = np.broadcast_to(np.eye(5, dtype=np.float32),
                              (2, 5, 5)).copy()
    got = _sums(sampling.fused_multinomial_sums_philox, counts, weights,
                3000, 4).numpy()
    n = counts.sum(1)
    assert (got[0, 1] == 0).all() and (got[0, 4] == 0).all()
    assert (got[1, 2] == 0).all() and (got[1, 3] == 0).all()
    np.testing.assert_array_equal(got[1, 1], n[1] - got[1, 0])
    np.testing.assert_array_equal(got.sum(1), np.broadcast_to(
        n[:, None], (2, 3000)))
    # the three occupied bins of row 0 keep their shares
    np.testing.assert_allclose(got[0, [0, 2, 3]].mean(1), [40, 25, 35],
                               rtol=0.03)


@pytest.mark.parametrize("w_dim", [1, 2, 5])
def test_philox_sums_conserve_every_total(rng, w_dim):
    """A column of ones gives exactly N in every replicate."""
    counts = np.concatenate([_gene_tile(rng, 6, 900)[:, :12],
                             _pair_tile(rng, 2, 300)[:, :12]])
    counts[:, 0] += 1  # no empty row
    weights = rng.random((8, 12, w_dim)).astype(np.float32)
    weights[..., 0] = 1.0
    got = _sums(sampling.fused_multinomial_sums_philox, counts, weights,
                500, 9).numpy()
    np.testing.assert_array_equal(
        got[:, 0], np.broadcast_to(counts.sum(1)[:, None], (8, 500)))


def test_philox_sums_are_a_function_of_row_bin_replicate_and_seed(rng):
    """The first B replicates do not depend on ``num_boot``; another seed
    gives other draws; a draw is the same alone as in a batch."""
    counts = _gene_tile(rng, 5, 400)
    weights = rng.random((*counts.shape, 2)).astype(np.float32)
    fn = sampling.fused_multinomial_sums_philox
    a = _sums(fn, counts, weights, 300, 77)
    assert torch.equal(a, _sums(fn, counts, weights, 700, 77)[..., :300])
    assert not torch.equal(a, _sums(fn, counts, weights, 300, 78))
    n, p = torch.tensor([50.0, 900.0, 12.0]), torch.tensor([0.2, 0.6, 0.97])
    ids = [torch.tensor(x) for x in ([0, 3, 1], [4, 0, 2], [7, 7, 9])]
    batch = sampling.philox_binomial(n, p, *ids, 5)
    for i in range(3):
        alone = sampling.philox_binomial(n[i:i + 1], p[i:i + 1],
                                         *(x[i:i + 1] for x in ids), 5)
        assert float(alone) == float(batch[i])


def test_philox_sums_match_the_chain_in_distribution(rng):
    """The plain version on the kernel's stream against the torch.binomial
    chain, on a 1D tile: per row and weight, means within 0.1 sd and sds
    within 10%."""
    counts = _gene_tile(rng, 8, 2000)
    weights = rng.random((*counts.shape, 2)).astype(np.float32) + 0.5
    a = _sums(sampling.fused_multinomial_sums_philox, counts, weights,
              3000, 3).numpy()
    c = torch.as_tensor(counts)
    b = sampling._multinomial_sums(c, torch.as_tensor(weights), c.sum(1),
                                   3000, generator(3, c.device)).numpy()
    sd = b.std(-1)
    assert (np.abs(a.mean(-1) - b.mean(-1)) <= 0.1 * sd + 1e-6).all()
    varies = sd > 0
    assert (np.abs(a.std(-1)[varies] / sd[varies] - 1) < 0.1).all()


def test_wrapper_takes_plain_version_for_cpu_tensors(rng):
    """On CPU tensors the wrapper is the program's CPU path, the
    torch.binomial chain: bit for bit what ``bootstrap._moment_sums`` gives
    for ``multinomial``; no launch counted."""
    counts = _gene_tile(rng, 4, 300)
    weights = rng.random((*counts.shape, 2)).astype(np.float32)
    cuda_kernels.reset_launches()
    got = _sums(cuda_kernels.fused_multinomial_sums_cuda, counts, weights,
                64, 8)
    c, w = torch.as_tensor(counts), torch.as_tensor(weights)
    n = c.sum(1)
    want = sampling.fused_bootstrap_sums(c, w, n, 64, 8,
                                         sampler="multinomial")
    assert torch.equal(got, want)
    assert torch.equal(got / n[:, None, None], bootstrap._moment_sums(
        c, w, n, 64, 8, "multinomial"))
    assert cuda_kernels.LAUNCHES == {cuda_kernels.CASCADE: 0,
                                     cuda_kernels.MULTINOMIAL: 0,
                                     cuda_kernels.GEV: 0}


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="device"):
        cuda_kernels.fused_multinomial_sums_cuda(
            torch.ones(2, 4, device="meta"),
            torch.ones(2, 4, 1, device="meta"), 4.0, 8, 0)


# --- sampler="multinomial" on CPU tensors: the chain, bit for bit ---------

def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _tile_1d(rng, r=3, t=6, u=9, n=60):
    """``ht_1d_tile``'s inputs: ``r`` groups of ``t`` genes, ``u`` bins."""
    counts = np.zeros((r, t, u), np.float32)
    values = np.zeros((r, t, u), np.float32)
    for g in range(r):
        for i in range(t):
            k = rng.integers(2, u + 1)
            counts[g, i, :k] = rng.multinomial(n - k, np.ones(k) / k) + 1
            values[g, i, :k] = np.arange(k)
    inv_sf = rng.uniform(0.8, 1.25, (r, t, u)).astype(np.float32)
    mean = (counts * values).sum(-1) / n
    return (values, counts, inv_sf, inv_sf * inv_sf,
            (counts > 0).sum(-1).astype(np.float32), mean,
            np.full((r, t), 1.2, np.float32),
            np.tile(np.array([0.1, 1.0, 0.0], np.float32), (r, 1)),
            np.full(r, 0.1, np.float32), np.full(r, float(n), np.float32),
            np.ones((r, 1), np.float32),
            np.tile(np.arange(r, dtype=np.float32)[None, :, None] % 2,
                    (t, 1, 1)))


def _tile_2d(rng, r=3, p=5, u=9, n=60):
    """``ht_2d_tile``'s inputs: ``r`` groups of ``p`` gene pairs."""
    values, counts, inv_sf, inv_sf_sq = _tile_1d(rng, r, p, u, n)[:4]
    values_2 = np.where(counts > 0, rng.integers(0, 4, counts.shape),
                        0).astype(np.float32)
    return (values, values_2, counts, inv_sf, inv_sf_sq,
            rng.uniform(-0.3, 0.3, (r, p)).astype(np.float32),
            np.full(r, 0.1, np.float32), np.full(r, float(n), np.float32),
            np.ones((r, 1), np.float32),
            np.tile(np.arange(r, dtype=np.float32)[None, :, None] % 2,
                    (p, 1, 1)))


# sha256 (first 16 hex digits) of the outputs before the kernel existed
PARENT_DIGESTS = {
    "sums_1d": "12ee7c3d78cb1bda",
    "sums_2d": "c5946fb8ac6bcd18",
    "tile_1d": "c358df434239199b",
    "tile_2d": "9a814472c108f8f2",
}


@pytest.mark.parametrize("case", ["sums_1d", "sums_2d", "tile_1d", "tile_2d"])
def test_cpu_multinomial_is_the_chain_bit_for_bit(case):
    """``sampler="multinomial"`` on CPU tensors runs the torch.binomial
    chain exactly as before the kernel: the same bits for the fused sums
    (W = 2 and 5, batched rows) and for whole 1D and 2D tiles in chunks of
    replicates, and one ``multinomial.chain`` count per group and chunk."""
    rng = np.random.default_rng(5)
    profiling.reset_timings()
    cuda_kernels.reset_launches()
    if case.startswith("sums"):
        w_dim = 2 if case == "sums_1d" else 5
        counts = torch.as_tensor(_tile_1d(rng)[1])  # [R, T, U]
        weights = torch.as_tensor(
            rng.random((*counts.shape, w_dim)).astype(np.float32))
        out = (sampling.fused_bootstrap_sums(counts, weights, 60.0, 250,
                                             2**40 + 3,
                                             sampler="multinomial"),)
        calls = 1
    elif case == "tile_1d":
        res = ht.ht_1d_tile(2**33 + 9, *_tile_1d(rng), num_boot=250,
                            model=estimators.HYPER_RELATIVE,
                            sampler="multinomial", boot_chunk=100,
                            device="cpu")
        out = tuple(res[k] for k in sorted(res))
        calls = 3 * 3  # groups x chunks
    else:
        res = ht.ht_2d_tile(2**33 + 9, *_tile_2d(rng), num_boot=250,
                            model=estimators.HYPER_RELATIVE,
                            sampler="multinomial", boot_chunk=100,
                            device="cpu")
        out = tuple(res[k] for k in sorted(res))
        calls = 3 * 3
    assert _digest(*out) == PARENT_DIGESTS[case]
    assert profiling.counters().get("multinomial.chain") == calls
    assert cuda_kernels.LAUNCHES[cuda_kernels.MULTINOMIAL] == 0


# --- the kernel on the card -----------------------------------------------

def _same_seed(counts, weights, num_boot, seed, dev):
    """Kernel and plain version on one seed: the share of replicates
    (row, b) whose sums differ beyond float32 rounding."""
    k = _sums(cuda_kernels.fused_multinomial_sums_cuda, counts, weights,
              num_boot, seed, dev)
    p = _sums(sampling.fused_multinomial_sums_philox, counts, weights,
              num_boot, seed, dev)
    assert k.shape == p.shape and bool(torch.isfinite(k).all())
    rel = ((k - p).abs() / p.abs().clamp_min(1e-6)).amax(1)  # [T, B]
    return float((rel > 1e-4).float().mean())


@pytest.mark.parametrize("w_dim", [1, 2, 5])
def test_kernel_replays_its_philox_stream_on_card(rng, cuda_device, w_dim):
    """Same seed, draw by draw, on 1D-shaped and 2D-shaped rows."""
    counts = _gene_tile(rng, 24, 2000) if w_dim < 5 else \
        _pair_tile(rng, 24, 500)
    weights = rng.random((*counts.shape, w_dim)).astype(np.float32) + 0.5
    share = _same_seed(counts, weights, 512, 2**41 + 17, cuda_device)
    print(f"\nW={w_dim}: share of replicates off the plain version {share}")
    assert share <= FLIP_SHARE


@pytest.mark.parametrize("case", [
    "one_bin", "empty_row", "interior_gaps", "absorb_early", "130_bins",
    "all_btrs",
])
def test_kernel_row_tails_on_card(rng, cuda_device, case):
    """Rows of one bin, an empty row, gaps, an early absorbing bin, rows
    over two chunks of 64 bins, rows drawn by BTRS only: exact conservation,
    zeros for the empty row, the plain version's draws."""
    u = 130 if case == "130_bins" else 12
    counts = np.zeros((4, u), np.float32)
    if case == "one_bin":
        counts[:, 0] = [7.0, 500.0, 1.0, 30000.0]
    elif case == "empty_row":
        counts[0, :5] = [400, 30, 5, 2, 1]
        counts[2, :3] = [9, 9, 9]  # rows 1 and 3 stay empty
    elif case == "interior_gaps":
        counts[:, 0:12:3] = rng.integers(1, 50, (4, 4))
    elif case == "absorb_early":
        counts[:, :3] = [3, 4_000_000, 1]
    elif case == "130_bins":
        counts[:, :130] = rng.integers(1, 12, (4, 130))
        counts[1, 66:] = 0  # ends two bins into the second chunk
    else:
        counts[:, :6] = rng.integers(200, 2000, (4, 6))
    weights = rng.random((4, u, 2)).astype(np.float32) + 0.5
    weights[..., 0] = 1.0
    k = _sums(cuda_kernels.fused_multinomial_sums_cuda, counts, weights,
              300, 3, cuda_device).cpu().numpy()
    np.testing.assert_allclose(
        k[:, 0], np.broadcast_to(counts.sum(1)[:, None], (4, 300)),
        rtol=1e-6)
    if case == "empty_row":
        assert float(np.abs(k[[1, 3]]).max()) == 0.0
    assert _same_seed(counts, weights, 300, 3, cuda_device) <= FLIP_SHARE


def test_kernel_is_a_function_of_its_seed_on_card(rng, cuda_device):
    """Same seed: the same bits; the first B replicates whatever
    ``num_boot``; another seed, other sums; the blocks' row order does not
    matter."""
    counts = torch.as_tensor(_pair_tile(rng, 16, 500), device=cuda_device)
    w = torch.rand(*counts.shape, 5, device=cuda_device)
    n = counts.sum(1)
    fn = cuda_kernels.fused_multinomial_sums_cuda
    a = fn(counts, w, n, 1000, 5)
    assert torch.equal(a, fn(counts, w, n, 1000, 5))
    assert torch.equal(a, fn(counts, w, n, 2000, 5)[..., :1000])
    assert not torch.equal(a, fn(counts, w, n, 1000, 6))
    by_index = cuda_kernels.launch_multinomial(
        w, n, cuda_kernels.cascade_inputs(counts, longest_first=False),
        1000, 5)
    assert torch.equal(a, by_index)


@pytest.mark.parametrize("shape", ["gene", "pair"])
def test_kernel_matches_the_chain_in_distribution_on_card(rng, cuda_device,
                                                          shape):
    """The tiles' exact sums on the card (``bootstrap._moment_sums``: one
    launch of the kernel) against the torch.binomial chain
    (``fused_bootstrap_sums``, plain on every device) on a 1D tile (9,500
    cells a group, W = 2) and a 2D tile (475 cells a group, W = 5): per row
    and weight, means within 0.1 sd and sds within 10%."""
    if shape == "gene":
        counts, w_dim = _gene_tile(rng, 48, 9500), 2
    else:
        counts, w_dim = _pair_tile(rng, 48, 475), 5
    c = torch.as_tensor(counts, device=cuda_device)
    w = torch.rand(*c.shape, w_dim, device=cuda_device) + 0.5
    n = c.sum(1)
    profiling.reset_timings()
    cuda_kernels.reset_launches()
    k = bootstrap._moment_sums(c, w, n, 4000, 11, "multinomial")
    assert cuda_kernels.LAUNCHES[cuda_kernels.MULTINOMIAL] == 1
    assert profiling.counters() == {}
    b = sampling.fused_bootstrap_sums(c, w, n, 4000, 11,
                                      sampler="multinomial")
    assert cuda_kernels.LAUNCHES[cuda_kernels.MULTINOMIAL] == 1
    assert profiling.counters() == {"multinomial.chain": 1}
    # both as _moment_sums gives them: sums over each row's trial count
    k, b = k.cpu().numpy(), (b / n[:, None, None]).cpu().numpy()
    sd = b.std(-1)
    atol = 1e-3 / n.cpu().numpy()[:, None]  # 1e-3 of a sum
    assert (np.abs(k.mean(-1) - b.mean(-1)) <= 0.1 * sd + atol).all()
    varies = sd > 0
    assert (np.abs(k.std(-1)[varies] / sd[varies] - 1) < 0.1).all()


def test_kernel_checks_its_inputs_on_card(cuda_device):
    c = torch.ones(3, 8, device=cuda_device)
    fn = cuda_kernels.fused_multinomial_sums_cuda
    with pytest.raises(ValueError, match="W=3"):
        fn(c, torch.ones(3, 8, 3, device=cuda_device), 8.0, 16, 0)
    with pytest.raises(TypeError):
        fn(c.double(), torch.ones(3, 8, 1, device=cuda_device), 8.0, 16, 0)
    with pytest.raises(ValueError, match="contiguous"):
        fn(c, torch.ones(3, 2, 8, device=cuda_device).transpose(1, 2), 8.0,
           16, 0)
    with pytest.raises(ValueError, match="expected counts"):
        fn(c[None], torch.ones(1, 3, 8, 1, device=cuda_device), 8.0, 16, 0)


def test_kernel_builds_without_spills_on_card(cuda_device):
    usage = cuda_kernels.ptxas(cuda_kernels.MULTINOMIAL)
    assert sorted(usage) == list(cuda_kernels.SUPPORTED_W), usage
    print("\nptxas:", usage)
    for w_dim in cuda_kernels.SUPPORTED_W:
        print(f"W={w_dim}:", cuda_kernels.resources(cuda_kernels.MULTINOMIAL,
                                                    w_dim))
    assert all(u["spill_store_bytes"] == 0 for u in usage.values()), usage
