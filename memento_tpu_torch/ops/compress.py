"""Unique-value compression of count data for the bootstrap (host).

Counterpart of ``memento_tpu/ops/compress.py``.  Each gene's N cells collapse
into U unique (expression value, size-factor bin) combos, packed into padded
``[G, U]`` tiles; ``compress_pairs`` does the same for the joint (x1, x2,
size-factor bin) combos of gene pairs.  The default backend is the native
C++ packer (``native/compress.cpp``, ``native/pairs.cpp``: one histogram
pass per gene or pair, OpenMP); the numpy packers (exact integer codes and
one ``np.unique`` over the whole gene axis) are the oracle of its tests and
run where the native packer refuses the input (``memento_tpu_torch.native``
lists when).  Bins with ``count == 0`` are inert padding: they get
probability 0 in the resampling and weight 0 in the moment contraction.  In
every row the zero-expression combos come first (one per occupied
size-factor bin, the large counts) and the nonzero combos after them: in
code order from the numpy packers and the pair packer, in first-seen order
from the native group packer (the same combos per gene as a set).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sparse

from .. import native
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


def _sf_fields(sf, sf_bin, bin_values) -> dict:
    """The size-factor fields of a compressed tile from its per-slot size
    factors ``sf`` (float64, 1 on padding) and bin ids ``sf_bin`` (0 =
    padding, 1 + b = bin b).  The compact form needs the ids to fit uint8."""
    inv_sf = (1.0 / sf).astype(np.float32)
    if len(bin_values) + 1 <= 255:  # uint8 id space (0 reserved for padding)
        bin_inv_sf = np.concatenate([[1.0], 1.0 / bin_values]).astype(np.float32)
    else:
        sf_bin = bin_inv_sf = None
    return dict(inv_sf=inv_sf, inv_sf_sq=(inv_sf * inv_sf).astype(np.float32),
                sf_bin=sf_bin, bin_inv_sf=bin_inv_sf)


BACKENDS = ("auto", "numpy", "native")


def compress_group(X, approx_sf, pad_multiple: int = 8, min_u: int = 8,
                   backend: str = "auto", cols=None) -> CompressedGroup:
    """Compress a group's ``[N, G]`` cell x gene matrix (sparse or dense)
    into padded unique-value tiles; ``cols=(start, stop)`` compresses only
    that gene range.

    ``backend``: ``'auto'`` (default) is the native packer, giving way to
    numpy only for an input it refuses; ``'native'`` raises ``ValueError``
    there instead; ``'numpy'`` is the numpy packer.  On a CSC matrix the
    native packer reads the matrix's own index and data buffers, for any
    ``cols`` range, with no copy (the tile loop calls it once per tile).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: {BACKENDS}")
    if backend != "numpy":
        out = _compress_group_native(X, approx_sf, pad_multiple, min_u, cols)
        if out is not None:
            return out
        if backend == "native":
            raise ValueError("the native packer does not take this input "
                             "(see memento_tpu_torch.native)")
    if cols is not None:
        X = X.tocsc()[:, cols[0]:cols[1]] if sparse.issparse(X) \
            else np.asarray(X)[:, cols[0]:cols[1]]
    return _compress_group_numpy(X, approx_sf, pad_multiple, min_u)


def _compress_group_native(X, approx_sf, pad_multiple, min_u, cols):
    """The zero-copy range packer on a CSC matrix, else the rounding packer
    on a CSC copy of the (sliced) matrix; ``None`` where both refuse."""
    if sparse.issparse(X) and X.format == "csc":
        start, stop = (0, X.shape[1]) if cols is None else cols
        out = native.compress_group_range_native(X, approx_sf, start, stop,
                                                 pad_multiple, min_u)
        if out is not None:
            return out
    if cols is not None:
        X = (X.tocsc() if sparse.issparse(X) else sparse.csc_matrix(X))[
            :, cols[0]:cols[1]]
    return native.compress_group_native(X, approx_sf, pad_multiple, min_u)


def _compress_group_numpy(X, approx_sf, pad_multiple,
                          min_u) -> CompressedGroup:
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

    return CompressedGroup(values=values, counts=counts, n_obs=n_cells,
                           n_unique=n_unique,
                           **_sf_fields(sf, sf_bin, bin_values))


@dataclass
class CompressedPairGroup:
    """Padded joint unique-value tiles for gene pairs in one group.

    Attributes (P = pairs, U = padded max joint combos):
      values_1 / values_2: [P, U] float32 expression values of each gene.
      counts:              [P, U] float32 multiplicities (0 = pad).
      inv_sf / inv_sf_sq:  [P, U] float32.
      n_obs: cells in the group.
      n_unique: [P] int32.
      sf_bin / bin_inv_sf: the compact transport form, as in
        ``CompressedGroup``.
    """

    values_1: np.ndarray
    values_2: np.ndarray
    counts: np.ndarray
    inv_sf: np.ndarray
    inv_sf_sq: np.ndarray
    n_obs: int
    n_unique: np.ndarray
    sf_bin: np.ndarray = None
    bin_inv_sf: np.ndarray = None

    @property
    def padded_u(self) -> int:
        return self.counts.shape[1]


PAIR_BACKENDS = ("auto", "numpy", "loop", "native")


def compress_pairs(X_csc, approx_sf, idx1, idx2, pad_multiple: int = 8,
                   min_u: int = 8, backend: str = "auto") -> CompressedPairGroup:
    """Joint (x1, x2, sf-bin) compression for gene pairs (the 2D bootstrap).

    ``backend='native'`` is the C++ per-pair merge packer
    (``native/pairs.cpp``, OpenMP over pairs; ``ValueError`` for an input it
    refuses); ``'numpy'`` packs all pairs with one lexsort, giving way to
    the loop when the joint integer code space overflows int64; ``'loop'``
    is the simple per-pair version; ``'auto'`` (default) is native, then
    numpy, then the loop.  All of them give the same tiles, slot for slot.

    Args:
      X_csc: ``[N, G]`` CSC matrix of the group.
      idx1, idx2: ``[P]`` integer gene indices of each pair.
    """
    if backend not in PAIR_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: "
                         f"{PAIR_BACKENDS}")
    if backend in ("auto", "native"):
        out = native.compress_pairs_native(X_csc, approx_sf, idx1, idx2,
                                           pad_multiple, min_u)
        if out is not None:
            return out
        if backend == "native":
            raise ValueError("the native pair packer does not take this "
                             "input (see memento_tpu_torch.native)")
    if backend in ("auto", "numpy"):
        try:
            return _compress_pairs_vectorized(X_csc, approx_sf, idx1, idx2,
                                              pad_multiple, min_u)
        except OverflowError:
            pass  # the joint code space overflows int64: take the loop
    return _compress_pairs_loop(X_csc, approx_sf, idx1, idx2, pad_multiple,
                                min_u)


def _ranges(starts, lens):
    """Concatenated [s, s+l) ranges (vectorized)."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    offs = np.repeat(np.cumsum(lens) - lens, lens)
    return np.arange(total, dtype=np.int64) - offs + np.repeat(starts, lens)


def _compress_pairs_vectorized(X_csc, approx_sf, idx1, idx2, pad_multiple,
                               min_u) -> CompressedPairGroup:
    """One-lexsort joint compression of every pair at once."""
    X_csc = X_csc.tocsc() if sparse.issparse(X_csc) else sparse.csc_matrix(X_csc)
    n_cells = X_csc.shape[0]
    bin_values, bin_ids = factorize_approx_sf(approx_sf)
    nbins = len(bin_values)
    bin_total = np.bincount(bin_ids, minlength=nbins)

    idx1 = np.asarray(idx1, dtype=np.int64)
    idx2 = np.asarray(idx2, dtype=np.int64)
    n_pairs = len(idx1)
    indptr = X_csc.indptr.astype(np.int64)
    indices = X_csc.indices.astype(np.int64)
    data = np.round(X_csc.data).astype(np.int64)

    lens1 = indptr[idx1 + 1] - indptr[idx1]
    lens2 = indptr[idx2 + 1] - indptr[idx2]
    d1 = _ranges(indptr[idx1], lens1)  # positions into indices/data
    d2 = _ranges(indptr[idx2], lens2)

    p_all = np.concatenate([np.repeat(np.arange(n_pairs), lens1),
                            np.repeat(np.arange(n_pairs), lens2)])
    r_all = np.concatenate([indices[d1], indices[d2]])
    v1_all = np.concatenate([data[d1], np.zeros(len(d2), np.int64)])
    v2_all = np.concatenate([np.zeros(len(d1), np.int64), data[d2]])

    order = np.lexsort((r_all, p_all))
    p_s, r_s = p_all[order], r_all[order]
    v1_s, v2_s = v1_all[order], v2_all[order]

    # one row per (pair, cell) that expresses either gene
    cellkey = p_s * n_cells + r_s
    newcell = np.ones(len(cellkey), dtype=bool)
    newcell[1:] = cellkey[1:] != cellkey[:-1]
    starts = np.nonzero(newcell)[0]
    x1 = np.add.reduceat(v1_s, starts) if len(starts) else np.zeros(0, np.int64)
    x2 = np.add.reduceat(v2_s, starts) if len(starts) else np.zeros(0, np.int64)
    pp = p_s[starts]
    bb = bin_ids[r_s[starts]].astype(np.int64)

    v1max = int(x1.max()) + 1 if len(x1) else 1
    v2max = int(x2.max()) + 1 if len(x2) else 1
    stride = v1max * v2max * nbins
    if n_pairs * stride >= np.iinfo(np.int64).max:
        raise OverflowError("pair code space overflow")

    code = pp * stride + (x1 * v2max + x2) * nbins + bb
    uniq, ucnt = np.unique(code, return_counts=True)
    up = uniq // stride
    rem = uniq % stride
    uv1 = rem // (v2max * nbins)
    uv2 = (rem // nbins) % v2max
    ub = rem % nbins

    # zero-zero combos per (pair, bin): bin occupancy minus the union rows
    union_pb = np.bincount(pp * nbins + bb, minlength=n_pairs * nbins).reshape(
        n_pairs, nbins)
    zcount = bin_total[None, :] - union_pb

    n_nz = np.bincount(up, minlength=n_pairs)
    n_z = (zcount > 0).sum(axis=1)
    n_unique = (n_nz + n_z).astype(np.int32)
    u_max = max(min_u, _round_up(int(n_unique.max()) if n_pairs else min_u,
                                 pad_multiple))

    values_1 = np.zeros((n_pairs, u_max), dtype=np.float32)
    values_2 = np.zeros((n_pairs, u_max), dtype=np.float32)
    counts = np.zeros((n_pairs, u_max), dtype=np.float32)
    sf = np.ones((n_pairs, u_max), dtype=np.float64)
    sf_bin = np.zeros((n_pairs, u_max), dtype=np.uint8)

    zg, zb = np.nonzero(zcount > 0)
    zstart = np.concatenate([[0], np.cumsum(n_z)])
    zpos = np.arange(len(zg)) - zstart[zg]
    counts[zg, zpos] = zcount[zg, zb]
    sf[zg, zpos] = bin_values[zb]
    sf_bin[zg, zpos] = (zb + 1).astype(np.uint8)

    nstart = np.concatenate([[0], np.cumsum(n_nz)])
    npos = np.arange(len(up)) - nstart[up] + n_z[up]
    values_1[up, npos] = uv1.astype(np.float32)
    values_2[up, npos] = uv2.astype(np.float32)
    counts[up, npos] = ucnt.astype(np.float32)
    sf[up, npos] = bin_values[ub]
    sf_bin[up, npos] = (ub + 1).astype(np.uint8)

    return CompressedPairGroup(values_1=values_1, values_2=values_2,
                               counts=counts, n_obs=n_cells,
                               n_unique=n_unique,
                               **_sf_fields(sf, sf_bin, bin_values))


def _compress_pairs_loop(X_csc, approx_sf, idx1, idx2, pad_multiple,
                         min_u) -> CompressedPairGroup:
    """Per-pair version (what the vectorized path is tested against)."""
    X_csc = X_csc.tocsc() if sparse.issparse(X_csc) else sparse.csc_matrix(X_csc)
    n_cells = X_csc.shape[0]
    bin_values, bin_ids = factorize_approx_sf(approx_sf)
    nbins = len(bin_values)
    bin_total = np.bincount(bin_ids, minlength=nbins)

    idx1 = np.asarray(idx1)
    idx2 = np.asarray(idx2)
    n_pairs = len(idx1)

    v1_list, v2_list, cnt_list, bin_list = [], [], [], []
    nuniq = np.zeros(n_pairs, np.int32)
    indptr, indices, data = X_csc.indptr, X_csc.indices, X_csc.data

    for p in range(n_pairs):
        j, k = int(idx1[p]), int(idx2[p])
        r1 = indices[indptr[j]:indptr[j + 1]]
        d1 = data[indptr[j]:indptr[j + 1]]
        r2 = indices[indptr[k]:indptr[k + 1]]
        d2 = data[indptr[k]:indptr[k + 1]]
        rows = np.union1d(r1, r2)
        x1 = np.zeros(len(rows))
        x1[np.searchsorted(rows, r1)] = d1
        x2 = np.zeros(len(rows))
        x2[np.searchsorted(rows, r2)] = d2
        x1 = np.round(x1).astype(np.int64)
        x2 = np.round(x2).astype(np.int64)
        b = bin_ids[rows].astype(np.int64)
        vmax = max(int(x2.max()) + 1 if len(x2) else 1, 1)
        code = (x1 * vmax + x2) * nbins + b
        uniq, ucnt = np.unique(code, return_counts=True)
        uv1 = uniq // (vmax * nbins)
        uv2 = (uniq // nbins) % vmax
        ub = uniq % nbins
        # zero-zero combos per bin
        zz = bin_total - np.bincount(b, minlength=nbins)
        zb = np.nonzero(zz > 0)[0]
        v1_list.append(np.concatenate([np.zeros(len(zb)), uv1]))
        v2_list.append(np.concatenate([np.zeros(len(zb)), uv2]))
        cnt_list.append(np.concatenate([zz[zb], ucnt]))
        bin_list.append(np.concatenate([zb, ub]))
        nuniq[p] = len(zb) + len(uniq)

    u_max = max(min_u, _round_up(int(nuniq.max()) if n_pairs else min_u,
                                 pad_multiple))
    values_1 = np.zeros((n_pairs, u_max), dtype=np.float32)
    values_2 = np.zeros((n_pairs, u_max), dtype=np.float32)
    counts = np.zeros((n_pairs, u_max), dtype=np.float32)
    sf = np.ones((n_pairs, u_max), dtype=np.float64)
    sf_bin = np.zeros((n_pairs, u_max), dtype=np.uint8)
    for p in range(n_pairs):
        u = nuniq[p]
        values_1[p, :u] = v1_list[p]
        values_2[p, :u] = v2_list[p]
        counts[p, :u] = cnt_list[p]
        sf[p, :u] = bin_values[bin_list[p]]
        sf_bin[p, :u] = (np.asarray(bin_list[p]) + 1).astype(np.uint8)
    return CompressedPairGroup(values_1=values_1, values_2=values_2,
                               counts=counts, n_obs=n_cells, n_unique=nuniq,
                               **_sf_fields(sf, sf_bin, bin_values))


__all__ = ["CompressedGroup", "CompressedPairGroup", "compress_group",
           "compress_pairs", "BACKENDS", "PAIR_BACKENDS"]
