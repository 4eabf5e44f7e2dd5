"""Philox4x32-10 in torch, the cascade kernel's allocation of its words, and
the plain cascade fed from that stream.

``memento_tpu_torch/ops/philox.py`` mirrors what ``csrc/cascade_bootstrap.cu``
does with its random bits, so these tests pin the generator (Random123's
known answers), the allocation (no variate serves two draws) and the replayed
cascade (conservation, the law of ``fused_bootstrap_sums``, independence of
the replicate count) on the CPU.  The kernel itself is held against this
replay on the card (``tests/test_torch_kernels.py``, ``chip_smoke.py``).
This file imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from memento_tpu_torch.ops import cuda_kernels, philox, sampling

# tier-1 runs several pytest workers at once: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _words(*hexes):
    return torch.tensor([int(h, 16) for h in hexes], dtype=torch.int64)


@pytest.mark.parametrize("counter, key, want", [
    (("0", "0", "0", "0"), ("0", "0"),
     ("6627e8d5", "e169c58d", "bc57ac4c", "9b00dbd8")),
    (("ffffffff",) * 4, ("ffffffff", "ffffffff"),
     ("408f276d", "41c83b0e", "a20bc7c6", "6d5451fd")),
    (("243f6a88", "85a308d3", "13198a2e", "03707344"),
     ("a4093822", "299f31d0"),
     ("d16cfe09", "94fdcceb", "5001e420", "24126ea1")),
])
def test_philox_known_answers(counter, key, want):
    """Random123's kat_vectors for philox4x32-10."""
    got = philox.philox4x32_10(_words(*counter),
                               tuple(int(k, 16) for k in key))
    assert got.tolist() == _words(*want).tolist()


@pytest.mark.parametrize("a", [0xD2511F53, 0xCD9E8D57, 0xFFFFFFFF, 1])
def test_mulhilo_is_the_64_bit_product(a, rng):
    b = np.concatenate([rng.integers(0, 1 << 32, 200, dtype=np.uint64),
                        [0, 1, 0xFFFF, 0x10000, 0xFFFFFFFF]]).astype(np.int64)
    hi, lo = philox._mulhilo(a, torch.tensor(b))
    want = [a * int(x) for x in b]
    assert hi.tolist() == [w >> 32 for w in want]
    assert lo.tolist() == [w & 0xFFFFFFFF for w in want]


def test_philox_batches_like_single_calls(rng):
    ctr = torch.tensor(rng.integers(0, 1 << 32, (6, 5, 4), dtype=np.uint64)
                       .astype(np.int64))
    got = philox.philox4x32_10(ctr, (7, 9))
    assert got.shape == (6, 5, 4)
    assert got[3, 2].tolist() == philox.philox4x32_10(ctr[3, 2],
                                                      (7, 9)).tolist()
    assert int(got.min()) >= 0 and int(got.max()) < 1 << 32


@pytest.mark.parametrize("seed, key", [
    (0, (0, 0)), (5, (5, 0)), ((3 << 32) | 9, (9, 3)),
    ((1 << 64) - 1, (0xFFFFFFFF, 0xFFFFFFFF)), (-1, (0xFFFFFFFF, 0xFFFFFFFF)),
])
def test_seed_key_is_low_then_high_word(seed, key):
    assert philox.seed_key(seed) == key


@pytest.mark.parametrize("bits, want", [
    (0, 1e-7), (255, 1e-7), (256, 1e-7), (512, 2.0 ** -23),
    (0xFFFFFFFF, 1 - 2.0 ** -24),
    (0x80000000, 0.5),
])
def test_uniform24_takes_the_top_24_bits(bits, want):
    got = philox.uniform24(torch.tensor([bits], dtype=torch.int64))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-7)
    assert 1e-7 <= float(got) < 1.0


def test_uniforms_lie_in_the_unit_interval():
    u = philox.group_uniforms(torch.arange(40)[:, None, None],
                              torch.arange(25)[None, :, None],
                              torch.arange(50)[None, None, :], 3)
    assert u.shape == (40, 25, 50, 4)
    assert float(u.min()) >= 1e-7 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.003
    assert abs(float(u.var()) - 1 / 12) < 0.002


@pytest.mark.parametrize("row, u, rep, seed", [
    (0, 0, 0, 0), (2, 9, 3, 11), (5, 7, 1, (8 << 32) | 1), (1, 2878, 255, 4),
])
def test_draws_take_the_allocated_words(row, u, rep, seed):
    """Table uniform: word ``u % 4`` of counter (rep, u // 4, row, 0);
    normal: pair ``(u % 4) // 2`` of counter (rep, u // 4, row, 1), cosine
    for even bins and sine for odd."""
    key = philox.seed_key(seed)
    w0 = philox.philox4x32_10(
        torch.tensor([rep, u // 4, row, 0], dtype=torch.int64), key)
    w1 = philox.philox4x32_10(
        torch.tensor([rep, u // 4, row, 1], dtype=torch.int64), key)
    j = u % 4
    assert float(philox.bin_uniform(row, u, rep, seed)) == \
        float(philox.uniform24(w0[j]))
    u1, u2 = (float(philox.uniform24(w1[2 * (j // 2) + i])) for i in (0, 1))
    rad = np.sqrt(-2.0 * np.log(u1))
    theta = 2 * np.pi * u2 - np.pi
    want = rad * (np.cos(theta) if j % 2 == 0 else np.sin(theta))
    assert float(philox.bin_normal(row, u, rep, seed)) == \
        pytest.approx(want, abs=2e-5)


@pytest.mark.parametrize("j", range(4))
def test_bin_draws_index_the_group_draws(j):
    rows = torch.arange(3)[:, None]
    reps = torch.arange(7)[None, :]
    u = 4 * 5 + j
    assert torch.equal(philox.bin_uniform(rows, u, reps, 2),
                       philox.group_uniforms(rows, 5, reps, 2)[..., j])
    assert torch.equal(philox.bin_normal(rows, u, reps, 2),
                       philox.group_normals(rows, 5, reps, 2)[..., j])


def test_no_variate_serves_two_draws(rng):
    """Over a grid of draws with mixed branches: every slot is used once,
    the Gaussian pairs of different slots share no word, and the table and
    Gaussian calls never share a counter."""
    n_rows, n_bins, n_reps = 3, 13, 5
    gaussian = rng.random((n_rows, n_bins)) < 0.5
    slots, table_words, pair_words = set(), set(), {}
    for t in range(n_rows):
        for u in range(n_bins):
            for b in range(n_reps):
                counter, words, role = philox.draw_slot(t, u, b,
                                                        gaussian[t, u])
                assert (counter, words, role) not in slots
                slots.add((counter, words, role))
                if role == "uniform":
                    assert (counter, words[0]) not in table_words
                    table_words.add((counter, words[0]))
                else:
                    pair_words.setdefault((counter, words), set()).add(role)
    assert len(slots) == n_rows * n_bins * n_reps
    assert all(roles <= {"cos", "sin"} for roles in pair_words.values())
    pair_slots = {(c, w) for c, ws in pair_words for w in ws}
    assert len(pair_slots) == 2 * len(pair_words)  # pairs are disjoint
    assert not pair_slots & table_words


@pytest.mark.parametrize("pair", [0, 1])
def test_normals_of_a_pair_are_standard_and_uncorrelated(pair):
    z = philox.group_normals(0, torch.arange(2000)[:, None],
                             torch.arange(100)[None, :], 17)
    a = z[..., 2 * pair].flatten().double().numpy()
    b = z[..., 2 * pair + 1].flatten().double().numpy()
    assert a.size == 200_000
    for x in (a, b):
        assert abs(x.mean()) < 0.01
        assert abs(x.std() - 1.0) < 0.01
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.01
    assert abs(np.corrcoef(a * a, b * b)[0, 1]) < 0.01


def test_normals_across_pairs_and_groups_are_uncorrelated():
    z = philox.group_normals(torch.arange(4)[:, None, None],
                             torch.arange(500)[None, :, None],
                             torch.arange(100)[None, None, :], 1)
    flat = z.reshape(-1, 4).double().numpy()
    corr = np.corrcoef(flat.T)
    assert np.abs(corr - np.eye(4)).max() < 0.01
    # neighbouring groups and neighbouring replicates
    g = z[..., 0].double().numpy()
    assert abs(np.corrcoef(g[:, :-1].ravel(), g[:, 1:].ravel())[0, 1]) < 0.01
    assert abs(np.corrcoef(g[..., :-1].ravel(),
                           g[..., 1:].ravel())[0, 1]) < 0.01


def _tile(rng, t, u, n):
    """Rows with one large bin and many small ones."""
    counts = np.zeros((t, u), np.float32)
    for i in range(t):
        k = rng.integers(10, u)
        small = rng.integers(1, 40, size=k - 1).astype(np.float32)
        counts[i, 1:k] = small
        counts[i, 0] = n - small.sum()
    return counts


def _pair_tile(rng, t, u, n):
    """A few large bins first, then many bins below 8 (the table branch)."""
    counts = np.zeros((t, u), np.float32)
    for i in range(t):
        k = rng.integers(u // 2, u)
        small = rng.integers(1, 8, size=k - 4).astype(np.float32)
        counts[i, 4:k] = small
        counts[i, :4] = (n - small.sum()) / 4
    return counts


def _assert_same_law(a, b, tol=0.15):
    """Per row and weight: mean within ``tol`` sd, sd ratio within tol (the
    limits of ``tests/test_torch_kernels.py``)."""
    for i in range(a.shape[0]):
        for wi in range(a.shape[1]):
            sd = a[i, wi].std()
            assert abs(a[i, wi].mean() - b[i, wi].mean()) < tol * sd + 1e-6
            assert abs(b[i, wi].std() / sd - 1) < tol


@pytest.mark.parametrize("w_dim", [1, 2, 5])
def test_philox_cascade_conserves_every_total(rng, w_dim):
    counts = np.concatenate([_tile(rng, 4, 30, 1000),
                             _pair_tile(rng, 4, 30, 3000)])
    n_rows = counts.sum(1)
    w = np.ones((8, 30, w_dim), np.float32)
    sums = sampling.fused_bootstrap_sums_philox(
        torch.tensor(counts), torch.tensor(w), torch.tensor(n_rows), 80,
        5).numpy()
    assert sums.shape == (8, w_dim, 80)
    np.testing.assert_allclose(sums, np.broadcast_to(
        n_rows[:, None, None], sums.shape), rtol=1e-5)


@pytest.mark.parametrize("shape", ["gene", "pair"])
def test_philox_cascade_has_the_plain_law(rng, shape):
    make = _tile if shape == "gene" else _pair_tile
    counts = make(rng, 6, 40, 20000)
    w = rng.random((6, 40, 2)).astype(np.float32)
    args = (torch.tensor(counts), torch.tensor(w), 20000.0, 2000)
    plain = sampling.fused_bootstrap_sums(*args, 1).numpy()
    replay = sampling.fused_bootstrap_sums_philox(*args, 2).numpy()
    _assert_same_law(plain, replay)


def test_philox_cascade_matches_exact_multinomial(rng):
    n, num_boot = 5000, 2000
    counts = _tile(rng, 4, 24, n)
    w = rng.random((4, 24, 2)).astype(np.float32)
    probs = counts.astype(np.float64) / n
    exact = np.stack([
        np.einsum("bu,uw->wb", rng.multinomial(n, probs[i], size=num_boot),
                  w[i]) for i in range(4)])
    got = sampling.fused_bootstrap_sums_philox(
        torch.tensor(counts), torch.tensor(w), float(n), num_boot, 3).numpy()
    _assert_same_law(exact, got)


@pytest.mark.parametrize("w_dim", [1, 2, 5])
def test_first_replicates_do_not_depend_on_their_number(rng, w_dim):
    counts = torch.tensor(_tile(rng, 5, 21, 4000))
    w = torch.tensor(rng.random((5, 21, w_dim)).astype(np.float32))
    b1 = sampling.fused_bootstrap_sums_philox(counts, w, 4000.0, 48, 6)
    b2 = sampling.fused_bootstrap_sums_philox(counts, w, 4000.0, 96, 6)
    assert torch.equal(b1, b2[..., :48])
    assert not torch.equal(b1, b2[..., 48:])


def test_replay_is_a_function_of_the_seed(rng):
    counts = torch.tensor(_tile(rng, 3, 16, 900))
    w = torch.tensor(rng.random((3, 16, 2)).astype(np.float32))
    a = sampling.fused_bootstrap_sums_philox(counts, w, 900.0, 32, 4)
    assert torch.equal(
        a, sampling.fused_bootstrap_sums_philox(counts, w, 900.0, 32, 4))
    assert not torch.equal(
        a, sampling.fused_bootstrap_sums_philox(counts, w, 900.0, 32, 5))
    assert not torch.equal(
        a, sampling.fused_bootstrap_sums_philox(counts, w, 900.0, 32,
                                                4 | (1 << 32)))


def test_table_only_group_draws_the_same_beside_a_gaussian_row(rng):
    """Whether a group's Gaussian call is made for some other row does not
    change a table-only row's draws."""
    small = rng.integers(1, 8, size=(1, 12)).astype(np.float32)
    other_small = rng.integers(1, 8, size=(1, 12)).astype(np.float32)
    other_large = other_small + 20
    w = torch.tensor(rng.random((2, 12, 2)).astype(np.float32))
    n_obs = 60.0
    alone = sampling.fused_bootstrap_sums_philox(
        torch.tensor(np.concatenate([small, other_small])), w, n_obs, 64, 9)
    beside = sampling.fused_bootstrap_sums_philox(
        torch.tensor(np.concatenate([small, other_large])), w, n_obs, 64, 9)
    assert torch.equal(alone[0], beside[0])
    assert not torch.equal(alone[1], beside[1])


def test_replay_refuses_other_shapes():
    with pytest.raises(ValueError, match=r"\[T, U\]"):
        sampling.fused_bootstrap_sums_philox(
            torch.ones(2, 3, 4), torch.ones(2, 3, 4, 1), 4.0, 8, 0)


@pytest.mark.parametrize("lam", [0.3, 1.0, 2.0, 4.5, 7.0, 7.9])
def test_block_cdf_recurrence_equals_the_plain_table(lam):
    """The kernel's staging builds a bin's table with one thread: the pmf by
    ``p * lam / k`` and a running float32 sum, which is the arithmetic of
    ``poisson_cdf_table`` (entry 31 is never read by the kernel's search)."""
    f32 = np.float32
    pmf = np.exp(-f32(lam), dtype=f32)
    c = pmf
    table = [c]
    for k in range(1, sampling.CASCADE_K):
        pmf = f32(f32(pmf * f32(lam)) / f32(k))
        c = f32(c + pmf)
        table.append(c)
    want = sampling.poisson_cdf_table(torch.tensor(lam)).numpy()
    np.testing.assert_allclose(np.array(table, f32), want, rtol=2e-7, atol=0)
    assert np.all(np.diff(want) >= 0)  # the search needs a sorted table


@pytest.mark.parametrize("lam", [1.0, 3.0, 7.5])
def test_lower_bound_search_is_the_plain_inverse_cdf(lam, rng):
    """The kernel's five-step branchless lower bound over entries 0..30
    counts the table entries below u, which is ``searchsorted``."""
    cdf = sampling.poisson_cdf_table(torch.tensor(lam))
    u = torch.tensor(rng.random(4000).astype(np.float32)).clamp(1e-7,
                                                                1 - 2e-7)
    pos = torch.where(cdf[15] < u, 16, 0)
    for step in (8, 4, 2, 1):
        pos = pos + torch.where(cdf[pos + step - 1] < u, step, 0)
    assert torch.equal(pos, torch.searchsorted(cdf, u))


def test_last_cdf_entry_is_short_of_one_by_a_few_uniforms_at_most():
    """Where the kernel and ``searchsorted`` differ: the kernel's search
    never counts entry 31, the float32 sum of the whole truncated pmf.  Over
    rates in (0, 8) that sum lies below at most 4 of the 2^24 uniforms (a
    count of 32 where the kernel gives 31), below none for most rates, and
    below a share of 1e-8 at most on average."""
    lam = torch.linspace(0.01, 7.99, 20001)
    last = sampling.poisson_cdf_table(lam)[:, -1].double()
    above = torch.clamp(torch.ceil((1.0 - last) * 2.0 ** 24) - 1.0, min=0.0)
    assert float(above.max()) <= 4
    assert float((above > 0).double().mean()) < 0.10
    assert float(above.mean()) / 2.0 ** 24 < 1e-8


@pytest.mark.parametrize("longest_first", [True, False])
def test_cascade_inputs_give_row_ends_and_order(longest_first):
    counts = torch.zeros(5, 12)
    counts[0, :3] = torch.tensor([5.0, 0.0, 2.0])  # interior gap
    counts[2, :12] = 1.0  # full row
    counts[3, 0] = 9.0  # one occupied bin
    counts[4, :7] = 2.0
    ratio, ctail, u_end, order = cuda_kernels.cascade_inputs(
        counts, longest_first=longest_first)
    assert u_end.dtype == torch.int32 and order.dtype == torch.int32
    assert u_end.tolist() == [3, 0, 12, 1, 7]
    want_ctail, want_ratio = sampling.conditional_ratios(counts)
    assert torch.equal(ratio, want_ratio) and torch.equal(ctail, want_ctail)
    assert float(ratio[3, 0]) == 1.0  # absorbing at u = 0
    if longest_first:
        assert u_end[order.long()].tolist() == [12, 7, 3, 1, 0]
    else:
        assert order.tolist() == [0, 1, 2, 3, 4]
    assert sorted(order.tolist()) == [0, 1, 2, 3, 4]
