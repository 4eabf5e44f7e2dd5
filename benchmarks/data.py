"""The benchmark's frozen data generator, in plain torch.

The law is ``examples/north_star.py::simulate``'s, as the port's drivers
draw it on the card (``memento_tpu_torch/drivers/_data.py::
north_star_device``, copied at commit dd20120): per gene a base mean,
log-uniform in [0.05, 3]; per cell and gene a Gamma(2, mean / 2)
expression, as the sum of two unit exponentials times mean / 2; Poisson
counts at capture ``q``; drawn on the device in chunks of 10,000 cells from
a ``torch.Generator`` seeded per chunk.  What a real design has is added on
top of the mean:

- a cell type for each cell, with a per-type gene factor, lognormal(0,
  ``type_sd``);
- a donor factor per donor and gene, lognormal(0, ``donor_sd``);
- the stimulated condition multiplies the mean of ``effect_share`` of the
  genes by ``effect``.

Every size is fixed by the configuration, never by the seed: the cells of
each type are ``round(share * n_cells)``, assigned to the (condition, donor)
groups in turn.  The seed draws the numbers only.  Each cell type comes out
as its own CSR matrix (float32 counts, int32 indices), cells in order.

This module imports neither the program nor JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sparse
import torch

CHUNK = 10_000


def derive(seed: int, *coords: int) -> int:
    """A 63-bit seed from ``seed`` and integer coordinates (numpy's
    ``SeedSequence``, so any whole number, negative or past 64 bits,
    is taken)."""
    entropy = [abs(int(seed)), 1 if int(seed) < 0 else 0,
               *(int(c) for c in coords)]
    return int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def type_sizes(n_cells: int, shares) -> list:
    """Cells of each type: ``round(share * n_cells)``, the largest type
    taking what rounding leaves, so that they sum to ``n_cells``."""
    shares = np.asarray(shares, np.float64)
    sizes = np.rint(shares / shares.sum() * n_cells).astype(np.int64)
    sizes[int(np.argmax(shares))] += n_cells - int(sizes.sum())
    return [int(s) for s in sizes]


@dataclass
class CellType:
    """One cell type's counts and the labels of its cells."""

    name: str
    X: sparse.csr_matrix  # [cells, genes] float32 counts
    condition: np.ndarray  # [cells] int64, 0 control, 1 stimulated
    donor: np.ndarray  # [cells] int64

    @property
    def n_cells(self) -> int:
        return self.X.shape[0]


@dataclass
class Dataset:
    genes: np.ndarray  # [G] gene names
    types: list  # [CellType], in the configuration's order
    q: float
    planted: np.ndarray  # [G] bool, the genes with the stimulated effect
    nnz: int


def gene_laws(cfg: dict, seed: int):
    """Host parameters of the law: base means ``[G]``, type factors
    ``[T, G]``, donor factors ``[D, G]`` and the planted genes ``[G]``."""
    g = int(cfg["n_genes"])
    rng = np.random.default_rng(derive(seed, 0))
    base = np.exp(rng.uniform(np.log(cfg["base_mean_low"]),
                              np.log(cfg["base_mean_high"]), g))
    type_fac = np.exp(rng.normal(0.0, cfg["type_sd"],
                                 (len(cfg["celltype_shares"]), g)))
    donor_fac = np.exp(rng.normal(0.0, cfg["donor_sd"],
                                  (int(cfg["n_donors"]), g)))
    planted = np.zeros(g, bool)
    planted[rng.choice(g, int(round(cfg["effect_share"] * g)),
                       replace=False)] = True
    return base, type_fac, donor_fac, planted


def draw(cfg: dict, seed: int, device) -> Dataset:
    """The configuration's counts for ``seed``, drawn on ``device``."""
    device = torch.device(device)
    g = int(cfg["n_genes"])
    q = float(cfg["capture_q"])
    n_donors = int(cfg["n_donors"])
    n_groups = 2 * n_donors
    base, type_fac, donor_fac, planted = gene_laws(cfg, seed)
    effect = np.where(planted, float(cfg["effect"]), 1.0)
    sizes = type_sizes(int(cfg["n_cells"]), cfg["celltype_shares"])
    # [group, G] factors of each (condition, donor) group: group k is
    # condition k // n_donors, donor k % n_donors
    group_fac = np.stack([donor_fac[k % n_donors]
                          * (effect if k // n_donors else 1.0)
                          for k in range(n_groups)])
    types, nnz = [], 0
    for t, n_t in enumerate(sizes):
        mean_t = torch.as_tensor(base * type_fac[t] / 2.0 * group_fac,
                                 dtype=torch.float32, device=device)
        group = np.arange(n_t) % n_groups
        data, indices, row_nnz = [], [], []
        for ci, start in enumerate(range(0, n_t, CHUNK)):
            m = min(CHUNK, n_t - start)
            gen = torch.Generator(device=device)
            gen.manual_seed(derive(seed, 1, t, ci))
            rows = torch.as_tensor(group[start:start + m], device=device)
            e = torch.empty((m, g), dtype=torch.float32, device=device)
            lam = e.exponential_(generator=gen).clone()
            lam += e.exponential_(generator=gen)
            lam *= mean_t[rows]
            counts = torch.poisson(lam * q, generator=gen)
            del e, lam
            nz = counts != 0
            row_nnz.append(nz.sum(1).cpu().numpy())
            indices.append(nz.nonzero()[:, 1].to(torch.int32).cpu().numpy())
            data.append(counts[nz].cpu().numpy())
            del counts, nz
        indptr = np.zeros(n_t + 1, np.int64)
        np.cumsum(np.concatenate(row_nnz), out=indptr[1:])
        if indptr[-1] < 2**31:
            indptr = indptr.astype(np.int32)
        X = sparse.csr_matrix((np.concatenate(data), np.concatenate(indices),
                               indptr), shape=(n_t, g))
        nnz += X.nnz
        types.append(CellType(name=f"type{t}", X=X,
                              condition=(group // n_donors).astype(np.int64),
                              donor=(group % n_donors).astype(np.int64)))
    genes = np.array([f"g{j}" for j in range(g)])
    return Dataset(genes=genes, types=types, q=q, planted=planted, nnz=nnz)


__all__ = ["CHUNK", "derive", "type_sizes", "CellType", "Dataset",
           "gene_laws", "draw"]
