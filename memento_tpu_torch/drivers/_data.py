"""The drivers' data: plain numpy generators.

Each function is the port's own copy of a generator of the JAX package's
drivers and returns the same arrays, bit for bit, for the same seed:

- ``north_star_simulate``: ``examples/north_star.py::simulate``, the
  full-transcriptome counts that ``north_star_2d``, ``corr_north_star`` and
  ``eqtl_north_star`` share (through ``load_or_simulate`` and ``NS_CACHE``);
- ``bench_simulate``, ``bench_pairs``: ``bench.py``'s counts and its 2D
  configuration's pairs;
- ``top_expressed_pairs``: ``examples/north_star_2d.py``'s pairs among the
  most expressed genes;
- ``eqtl_design``: the per-gene SNP treatments of
  ``examples/eqtl_north_star.py`` and of ``bench.py``'s eQTL configuration;
- ``kernel_counts``: ``examples/kernel_bench.py``'s kernel tiles.

``multinomial_counts`` (the port's own) shapes the exact sampler's group
calls for ``kernel_bench``.

``north_star_device`` draws ``north_star_simulate``'s law (not its numbers)
on a torch device, chunk by chunk, for runs that cannot wait for the
sequential numpy generator.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import scipy.sparse as sparse


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def north_star_simulate(n_cells: int, n_genes: int, q: float = 0.1,
                        seed: int = 0, verbose: bool = True):
    """Full-transcriptome-shaped counts ``[n_cells, n_genes]`` CSR float32:
    log-uniform base means in [0.05, 3], a Gamma(2, base / 2) expression
    per cell and gene, Poisson capture at ``q``, drawn in chunks of 10,000
    cells from one ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    base = np.exp(rng.uniform(np.log(0.05), np.log(3.0), n_genes))
    blocks = []
    chunk = 10_000
    for start in range(0, n_cells, chunk):
        m = min(chunk, n_cells - start)
        lam = rng.gamma(2.0, base / 2.0, size=(m, n_genes)).astype(np.float32)
        blocks.append(sparse.csr_matrix(
            rng.poisson(lam * q).astype(np.float32)))
        if verbose:
            log(f"  simulated {start + m}/{n_cells} cells")
    return sparse.vstack(blocks).tocsr()


def load_or_simulate(cache: str, n_cells: int, n_genes: int,
                     draw: str = "numpy", device=None):
    """``north_star_simulate(n_cells, n_genes)`` (``draw="numpy"``, the JAX
    scripts' numbers) or ``north_star_device`` on ``device``
    (``draw="device"``, the same law), read from the ``.npz`` at ``cache``
    when it exists and written there when ``cache`` is set but absent
    (``NS_CACHE``); ``""`` neither reads nor writes."""
    if draw not in ("numpy", "device"):
        raise ValueError(f"draw must be 'numpy' or 'device', not {draw!r}")
    if cache and os.path.exists(cache):
        X = sparse.load_npz(cache).tocsr()
        if X.shape != (n_cells, n_genes):
            raise ValueError(f"{cache} holds {X.shape}, not "
                             f"{(n_cells, n_genes)}")
        log(f"loaded cached counts from {cache}")
        return X
    X = north_star_simulate(n_cells, n_genes) if draw == "numpy" else \
        north_star_device(n_cells, n_genes, device=device)
    if cache:
        os.makedirs(os.path.dirname(os.path.abspath(cache)), exist_ok=True)
        sparse.save_npz(cache, X)
    return X


def north_star_device(n_cells: int, n_genes: int, q: float = 0.1,
                      seed: int = 0, device="cuda", chunk: int = 10_000):
    """``north_star_simulate``'s law drawn on ``device``: the same base
    means (the same numpy stream), then per chunk of ``chunk`` cells a
    Gamma(2) expression as the sum of two unit exponentials times base / 2,
    cast to float32, and Poisson counts at ``q``, from a ``torch.Generator``
    seeded ``fold_seed(seed, chunk index)``.  Other numbers than the numpy
    generator's, the same distribution.  Returns CSR float32 with int32
    indices."""
    import torch

    from ..device import fold_seed, generator, resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    base = np.exp(rng.uniform(np.log(0.05), np.log(3.0), n_genes))
    half_base = torch.as_tensor(base / 2.0, dtype=torch.float64, device=dev)
    data, indices, row_nnz = [], [], []
    for ci, start in enumerate(range(0, n_cells, chunk)):
        m = min(chunk, n_cells - start)
        gen = generator(fold_seed(seed, ci), dev)
        e = torch.empty((m, n_genes), dtype=torch.float64, device=dev)
        lam = e.exponential_(generator=gen).clone()
        lam += e.exponential_(generator=gen)
        lam = (lam * half_base).to(torch.float32)
        counts = torch.poisson(lam.to(torch.float64) * q, generator=gen)
        del e, lam
        nz = counts != 0
        row_nnz.append(nz.sum(1).cpu().numpy())
        # both in row-major order
        indices.append(nz.nonzero()[:, 1].to(torch.int32).cpu().numpy())
        data.append(counts[nz].to(torch.float32).cpu().numpy())
        del counts, nz
    indptr = np.zeros(n_cells + 1, np.int64)
    np.cumsum(np.concatenate(row_nnz), out=indptr[1:])
    if indptr[-1] < 2**31:
        indptr = indptr.astype(np.int32)
    return sparse.csr_matrix(
        (np.concatenate(data), np.concatenate(indices), indptr),
        shape=(n_cells, n_genes))


def bench_simulate(n_cells: int, n_genes: int, seed: int = 0):
    """``bench.py``'s counts: log-uniform base means, Gamma(2, base / 2),
    Poisson at 0.1, chunks of 20,000 cells."""
    rng = np.random.default_rng(seed)
    base = np.exp(rng.uniform(np.log(0.05), np.log(3.0), n_genes))
    blocks = []
    chunk = 20_000
    for start in range(0, n_cells, chunk):
        m = min(chunk, n_cells - start)
        lam = rng.gamma(2.0, base / 2.0, size=(m, n_genes))
        blocks.append(sparse.csr_matrix(
            rng.poisson(lam * 0.1).astype(np.float32)))
    return sparse.vstack(blocks).tocsr()


def bench_pairs(n_genes: int, n_pairs: int, seed: int = 7):
    """``bench.py``'s 2D pairs ``(idx1, idx2)``: uniform, no self-pair."""
    rng = np.random.default_rng(seed)
    idx1 = rng.integers(0, n_genes, n_pairs)
    idx2 = (idx1 + 1 + rng.integers(0, n_genes - 1, n_pairs)) % n_genes
    return idx1, idx2


def top_expressed_pairs(X, n_pairs: int, n_top: int = 4000, seed: int = 7):
    """``north_star_2d``'s pairs ``(idx1, idx2)`` among the ``n_top`` genes
    with the largest total count of ``X`` (correlation tests on barely
    expressed genes are NaN)."""
    expr = np.asarray(X.sum(axis=0)).ravel()
    top = np.argsort(expr)[::-1][:n_top]
    rng = np.random.default_rng(seed)
    p1 = rng.integers(0, len(top), n_pairs)
    p2 = (p1 + 1 + rng.integers(0, len(top) - 1, n_pairs)) % len(top)
    return top[p1], top[p2]


def eqtl_design(n_genes: int, kt: int, seed: int = 11):
    """Per-gene SNP treatments for two groups: ``(nt [G], treatment
    [G, 2, kt])``, gene i testing ``nt[i]`` dosage columns in {0, 1, 2}
    (1 to ``kt``), the other columns zero (padding)."""
    rng = np.random.default_rng(seed)
    nt = rng.integers(1, kt + 1, n_genes)
    tens = np.zeros((n_genes, 2, kt))
    for i in range(n_genes):
        tens[i, :, : nt[i]] = rng.integers(0, 3, (2, nt[i]))
    return nt, tens


def kernel_counts(rng, t_dim: int, u_dim: int, ragged: bool,
                  n: int = 50_000):
    """``kernel_bench.py``'s bin multiplicities ``[t_dim, u_dim]`` float32,
    each row summing to ``n``: dense (1 to 39 per bin, the rest in bin 0),
    or ragged (occupied bins per row drawn like a compression's output,
    zero padding beyond)."""
    if not ragged:
        counts = rng.integers(1, 40, size=(t_dim, u_dim)).astype(np.float32)
        counts[:, 0] += n - counts.sum(1)
        return counts
    occ = np.clip((rng.gamma(2.0, 0.2, t_dim) * u_dim).astype(int), 8, u_dim)
    counts = np.zeros((t_dim, u_dim), np.float32)
    for i, o in enumerate(occ):
        c = rng.integers(1, 12, size=o).astype(np.float32)
        c[0] += n - c.sum()
        counts[i, :o] = c
    return counts


def multinomial_counts(rng, t_dim: int, n_cells: int, pair: bool):
    """Rows as one cell group's compression gives them, ``[t_dim, U]``
    float32, each summing to ``n_cells``: the multiplicities of each gene's
    distinct counts (Poisson-gamma, means log-uniform in [0.01, 30]; zero
    first), or (``pair``) of each gene pair's distinct joint counts (means
    in [0.3, 30], the two genes sharing a gamma factor), padded to one U."""
    if pair:
        mu = np.exp(rng.uniform(np.log(0.3), np.log(30.0), (t_dim, 2)))
        g = rng.gamma(2.0, 0.5, (t_dim, n_cells))
        x = rng.poisson(mu[:, 0, None] * g) * 100_000 \
            + rng.poisson(mu[:, 1, None] * g)
    else:
        mu = np.exp(rng.uniform(np.log(0.01), np.log(30.0), t_dim))
        x = rng.poisson(rng.gamma(2.0, mu[:, None] / 2.0, (t_dim, n_cells)))
    rows = [np.unique(r, return_counts=True)[1] for r in x]
    counts = np.zeros((t_dim, max(len(r) for r in rows)), np.float32)
    for i, r in enumerate(rows):
        counts[i, :len(r)] = r
    return counts
