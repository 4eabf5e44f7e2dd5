"""Unique-value compression of count data for the bootstrap (host).

Counterpart of ``memento_tpu/ops/compress.py`` (its numpy path): each gene's
N cells collapse into U unique (expression value, size-factor bin) combos
with exact integer codes and one ``np.unique`` over the whole gene axis;
the ragged per-gene combo lists are scatter-packed into padded ``[G, U]``
tiles.  Bins with ``count == 0`` are inert padding: they get probability 0
in the resampling and weight 0 in the moment contraction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sparse

from .size_factor import factorize_approx_sf


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class CompressedGroup:
    """Padded unique-value tiles for one cell group.

    Attributes (G = genes, U = padded max combos per gene):
      values:     [G, U] float32, unique expression values.
      counts:     [G, U] float32, cell multiplicity of each combo (0 = pad).
      inv_sf:     [G, U] float32, 1 / approx size factor of the combo.
      inv_sf_sq:  [G, U] float32, 1 / approx size factor^2.
      n_obs:      number of cells in the group.
      n_unique:   [G] int32, true combo count per gene before padding.
      sf_bin:     optional [G, U] uint8 size-factor bin id per combo; with
        ``bin_inv_sf`` ([NB] float32, ``bin_inv_sf[sf_bin] == inv_sf``) the
        compact transport form (1 byte per slot), rebuilt on the device.
    """

    values: np.ndarray
    counts: np.ndarray
    inv_sf: np.ndarray
    inv_sf_sq: np.ndarray
    n_obs: int
    n_unique: np.ndarray
    sf_bin: np.ndarray = None
    bin_inv_sf: np.ndarray = None

    @property
    def num_genes(self) -> int:
        return self.values.shape[0]

    @property
    def padded_u(self) -> int:
        return self.values.shape[1]


def compress_group(X, approx_sf, pad_multiple: int = 8, min_u: int = 8,
                   cols=None) -> CompressedGroup:
    """Compress a group's ``[N, G]`` cell x gene matrix (sparse or dense)
    into padded unique-value tiles; ``cols=(start, stop)`` compresses only
    that gene range."""
    if cols is not None:
        X = X.tocsc()[:, cols[0]:cols[1]] if sparse.issparse(X) \
            else np.asarray(X)[:, cols[0]:cols[1]]
    if sparse.issparse(X):
        coo = X.tocoo()
        rows, gcols, vals = coo.row, coo.col, coo.data
    else:
        X = np.asarray(X)
        rows, gcols = np.nonzero(X)
        vals = X[rows, gcols]
    n_cells, n_genes = X.shape

    bin_values, bin_ids = factorize_approx_sf(approx_sf)
    nbins = len(bin_values)
    bin_total = np.bincount(bin_ids, minlength=nbins)

    vals_i = np.round(np.asarray(vals)).astype(np.int64)
    vmax = int(vals_i.max()) + 1 if vals_i.size else 1
    stride = vmax * nbins
    if n_genes * stride >= np.iinfo(np.int64).max:
        raise OverflowError("code space overflow; shard the gene axis")

    b = bin_ids[rows].astype(np.int64)
    code = gcols.astype(np.int64) * stride + vals_i * nbins + b

    uniq, ucount = np.unique(code, return_counts=True)
    ug = (uniq // stride).astype(np.int64)
    rem = uniq % stride
    uval = rem // nbins
    ubin = rem % nbins

    # zero-expression multiplicity per (gene, bin)
    nz_gene_bin = np.bincount(gcols.astype(np.int64) * nbins + b,
                              minlength=n_genes * nbins).reshape(n_genes, nbins)
    zcount = bin_total[None, :] - nz_gene_bin  # [G, nbins]

    n_nz = np.bincount(ug, minlength=n_genes)
    n_z = (zcount > 0).sum(axis=1)
    n_unique = (n_nz + n_z).astype(np.int32)
    u_max = max(min_u, _round_up(int(n_unique.max()) if n_genes else min_u,
                                 pad_multiple))

    values = np.zeros((n_genes, u_max), dtype=np.float32)
    counts = np.zeros((n_genes, u_max), dtype=np.float32)
    sf = np.ones((n_genes, u_max), dtype=np.float64)
    # compact-transport bin ids: 0 = padding (inv 1.0), 1+b = sf bin b
    sf_bin = np.zeros((n_genes, u_max), dtype=np.uint8)

    # zero combos at slots [0, n_z)
    zg, zb = np.nonzero(zcount > 0)
    zstart = np.concatenate([[0], np.cumsum(n_z)])
    zpos = np.arange(len(zg)) - zstart[zg]
    counts[zg, zpos] = zcount[zg, zb]
    sf[zg, zpos] = bin_values[zb]
    sf_bin[zg, zpos] = (zb + 1).astype(np.uint8)

    # nonzero combos at slots [n_z, n_z + n_nz)
    nstart = np.concatenate([[0], np.cumsum(n_nz)])
    npos = np.arange(len(ug)) - nstart[ug] + n_z[ug]
    values[ug, npos] = uval.astype(np.float32)
    counts[ug, npos] = ucount.astype(np.float32)
    sf[ug, npos] = bin_values[ubin]
    sf_bin[ug, npos] = (ubin + 1).astype(np.uint8)

    inv_sf = (1.0 / sf).astype(np.float32)
    if nbins + 1 <= 255:  # uint8 id space (0 reserved for padding)
        bin_inv_sf = np.concatenate([[1.0], 1.0 / bin_values]).astype(np.float32)
    else:
        sf_bin = bin_inv_sf = None
    return CompressedGroup(
        values=values,
        counts=counts,
        inv_sf=inv_sf,
        inv_sf_sq=(inv_sf * inv_sf).astype(np.float32),
        n_obs=n_cells,
        n_unique=n_unique,
        sf_bin=sf_bin,
        bin_inv_sf=bin_inv_sf,
    )


__all__ = ["CompressedGroup", "compress_group"]
