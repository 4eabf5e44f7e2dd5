"""The native (C++, OpenMP) host layer: unique-value packers, sufficient
statistics and pair products.

Counterpart of ``memento_tpu/native/`` with its own copies of the C++
sources (``compress.cpp``, ``suffstats.cpp``, ``pairs.cpp``), built by
``g++`` at first use into ``_build/`` (see ``build.py``) and called through
ctypes, which releases the interpreter lock for the length of each call.

Each wrapper returns ``None`` for an input the C++ does not take, and its
caller in ``ops/`` or ``api.py`` then takes its numpy/scipy version, where
the JAX package does the same:

- a matrix in the wrong sparse format (CSR for the row passes, CSC for the
  column passes) or an unsupported index/data dtype;
- float64 data that is not exact in float32 (the sums read float32);
- an indexed axis longer than 2^31 - 1 (the sums read int32 indices);
- for the packers' zero-copy paths (``compress_group_range_native`` and the
  v2 pair path), data that is not integral and non-negative: the packers
  then round the data first, as the numpy packer does.  That verdict is
  cached on the matrix, and the C++ checks every nonzero it reads against
  it: after an in-place edit of ``X.data`` the packer refuses the call, and
  the wrapper checks the matrix afresh and packs again;
- beyond the JAX package, data the C++ would mishandle: negative counts
  (out-of-bounds histogram writes) and values past ``MAX_HIST`` histogram
  slots per gene or 2^31 - 1 in a pair (an int32 cast).

A library that does not build or load raises ``RuntimeError``; there is no
silent numpy path.  ``CALLS`` counts the calls into the library by entry
point, so a run can show that its main path went through it.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import scipy.sparse as sparse

from .. import build

CALLS = {name: 0 for name in (
    "compress_group", "compress_group_range", "compress_pairs",
    "suffstats_csr", "suffstats_csc", "row_sums_csr", "col_sums_csr",
    "pair_prods_csc")}
# histogram slots ((max value + 1) x bins) the 1D packer may allocate per
# gene and thread: 256 MiB of int64 counters
MAX_HIST = 1 << 25
MAX_INT32 = 2**31 - 1

_I64, _I32, _P = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p
_SIGNATURES = {
    "compress_group_compact": [_I64, _I64, _I32] + [_P] * 11,
    "compress_group_compact_range":
        [_I64, _I64, _I32, _P, _P, _I32, _P, _I32] + [_P] * 3 + [_I64]
        + [_P] * 6,
    "compress_pairs_compact_v2":
        [_I64, _I64, _I64, _I32, _P, _P, _I32, _P, _I32] + [_P] * 2 + [_I64]
        + [_P] * 9,
    "suffstats_csr": [_I64, _I64] + [_P] * 7,
    "suffstats_csc": [_I64] + [_P] * 7,
    "row_sums_csr": [_I64] + [_P] * 6,
    "col_sums_csr": [_I64, _I64] + [_P] * 5,
    "pair_prods_csc": [_I64] + [_P] * 7,
}
# entries that return a status: 0, or 1 for a nonzero outside the verdict
# (a count in [0, vmax]; integral for the range packer) that the caller
# passed
_STATUS = ("compress_group_compact_range", "compress_pairs_compact_v2")
# the pair packer's codes for the data dtypes it reads as stored
_PAIR_DATA = {np.dtype(np.float64): 0, np.dtype(np.float32): 1,
              np.dtype(np.int64): 2, np.dtype(np.int32): 3}
_COUNT_LOCK = threading.Lock()


def reset_calls() -> None:
    with _COUNT_LOCK:
        for name in CALLS:
            CALLS[name] = 0


def _call(entry: str, counter: str, *args):
    """Call ``entry`` of the library (built on first use) and count it;
    returns the entry's status (``None`` for an entry without one)."""
    lib = build.load("native")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[entry]
        fn.restype = ctypes.c_int32 if entry in _STATUS else None
    with _COUNT_LOCK:
        CALLS[counter] += 1
    return fn(*args)


def _ptr(a, dtype):
    """The data pointer of a C-contiguous array of ``dtype`` (``None``, the
    null pointer, for ``None``)."""
    if a is None:
        return None
    if a.dtype != dtype or not a.flags.c_contiguous:
        raise TypeError(f"native call: need a contiguous {np.dtype(dtype)} "
                        f"array, got {a.dtype} (contiguous: "
                        f"{a.flags.c_contiguous})")
    return a.ctypes.data


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _counts_stats(d):
    """``(ok, max value)`` of count data: ``ok`` when it is finite, integral
    and non-negative: the JAX package's ``np.mod(x, 1) == 0`` test, by a
    rounding (far cheaper than ``fmod``).  Chunked, so no nnz-sized
    temporary is made."""
    vmax, step = 0, 1 << 24
    buf = np.empty(min(d.size, step), dtype=d.dtype)
    for s in range(0, d.size, step):
        c = d[s:s + step]
        lo, hi = float(c.min()), float(c.max())
        r = np.rint(c, out=buf[:c.size])
        if not (lo >= 0 and np.isfinite(hi) and np.array_equal(r, c)):
            return False, 0
        vmax = max(vmax, int(hi))
    return True, vmax


def _compress_range_prep(X, approx_sf, fresh: bool = False):
    """Per-(matrix, size-factor) prep of the zero-copy packers, cached on the
    matrix: int64 indptr, int32 bin ids, float64 bin values, global bin
    occupancy and the largest value, or ``None`` when the data is not
    integral and non-negative (the C++ truncates ``x + 0.5``, exact only for
    such data).  Computed once, so each tile's call touches only the tile's
    nonzeros; ``fresh`` recomputes it (the C++ refused a nonzero that the
    cached verdict no longer covers).  The entry holds the size-factor array
    itself and is checked with ``is``: a key by ``id()`` could match a new
    array allocated where a freed one was."""
    from ..ops.size_factor import factorize_approx_sf

    prep = getattr(X, "_memento_torch_range_prep", None)
    if not fresh and prep is not None and prep[0] is approx_sf \
            and prep[1] == X.nnz:
        return prep[2]
    bin_values, bin_ids = factorize_approx_sf(approx_sf)
    ok, vmax = _counts_stats(X.data)
    out = None
    if ok:
        bins = np.ascontiguousarray(bin_ids, dtype=np.int32)
        out = (np.ascontiguousarray(X.indptr, dtype=np.int64), bins,
               np.ascontiguousarray(bin_values, dtype=np.float64),
               np.bincount(bins, minlength=len(bin_values)).astype(np.int64),
               vmax)
    try:
        X._memento_torch_range_prep = (approx_sf, X.nnz, out)
    except AttributeError:  # matrix subclasses without __dict__
        pass
    return out


def _native_buffers(X):
    """X's index and data buffers as stored, when the zero-copy C++ paths
    read their dtypes; else ``None``."""
    if X.indices.dtype not in (np.int32, np.int64) \
            or X.data.dtype not in (np.float32, np.float64):
        return None
    return np.ascontiguousarray(X.indices), np.ascontiguousarray(X.data)


def _pad_runs(runs, cap_off, n_unique, pad_multiple, min_u):
    """Scatter compact per-row runs (row i's ``n_unique[i]`` slots start at
    ``cap_off[i]``) into padded ``[rows, U]`` tiles; ``runs`` maps a field
    name to ``(compact array, fill value)``."""
    rows = len(n_unique)
    u_max = max(min_u, _round_up(int(n_unique.max()) if rows else min_u,
                                 pad_multiple))
    out = {name: np.full((rows, u_max), fill, dtype=arr.dtype)
           for name, (arr, fill) in runs.items() if arr is not None}
    if rows and n_unique.any():
        r = np.repeat(np.arange(rows), n_unique)
        starts = np.concatenate(([0], np.cumsum(n_unique)[:-1]))
        c = np.arange(int(n_unique.sum()), dtype=np.int64) - np.repeat(
            starts, n_unique)
        src = np.repeat(cap_off[:-1], n_unique) + c
        for name, tile in out.items():
            tile[r, c] = runs[name][0][src]
    return out


def _compact_buffers(total_cap, n_rows, with_bins, value_fields):
    """Uninitialized compact outputs of a packer call."""
    bufs = {f: np.empty(total_cap, np.float32) for f in value_fields}
    bufs["counts"] = np.empty(total_cap, np.float32)
    bufs["inv_sf"] = np.empty(total_cap, np.float32)
    bufs["sf_bin"] = np.empty(total_cap, np.uint8) if with_bins else None
    return bufs, np.zeros(n_rows, dtype=np.int32)


def _sf_tail(inv_sf, sf_bin, binvals, with_bins) -> dict:
    return dict(inv_sf=inv_sf, inv_sf_sq=(inv_sf * inv_sf).astype(np.float32),
                sf_bin=sf_bin,
                bin_inv_sf=np.concatenate([[1.0], 1.0 / binvals]).astype(
                    np.float32) if with_bins else None)


def _group_result(bufs, cap_off, n_unique, binvals, n_obs, pad_multiple,
                  min_u):
    from ..ops.compress import CompressedGroup

    with_bins = bufs["sf_bin"] is not None
    t = _pad_runs({"values": (bufs["values"], 0.0),
                   "counts": (bufs["counts"], 0.0),
                   "inv_sf": (bufs["inv_sf"], 1.0),
                   "sf_bin": (bufs["sf_bin"], 0)},
                  cap_off, n_unique, pad_multiple, min_u)
    return CompressedGroup(values=t["values"], counts=t["counts"],
                           n_obs=n_obs, n_unique=n_unique,
                           **_sf_tail(t["inv_sf"], t.get("sf_bin"), binvals,
                                      with_bins))


def compress_group_native(X, approx_sf, pad_multiple=8, min_u=8):
    """The C++ group packer (``compress_group_compact``) on any matrix: one
    histogram pass per gene, data rounded first as the numpy packer rounds
    it.  ``None`` for negative counts or a histogram past ``MAX_HIST``.

    The JAX wrapper's two-call ``count_unique`` / ``pack_unique*`` branch,
    taken there only where the library lacks ``compress_group_compact``, is
    left out: this library always has it (the C++ keeps both entries)."""
    from ..ops.size_factor import factorize_approx_sf

    X = X.tocsc() if sparse.issparse(X) else sparse.csc_matrix(X)
    n_cells, n_genes = X.shape
    bin_values, bin_ids = factorize_approx_sf(approx_sf)
    nbins = len(bin_values)
    data = np.round(X.data).astype(np.int64)
    if data.size and (int(data.min()) < 0
                      or (int(data.max()) + 1) * nbins > MAX_HIST):
        return None
    indptr = np.ascontiguousarray(X.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(X.indices, dtype=np.int64)
    bins = np.ascontiguousarray(bin_ids, dtype=np.int32)
    binvals = np.ascontiguousarray(bin_values, dtype=np.float64)

    # single pass: compact runs at worst-case offsets, then a numpy scatter
    cap_off = np.zeros(n_genes + 1, dtype=np.int64)
    np.cumsum(nbins + np.diff(indptr), out=cap_off[1:])
    bufs, n_unique = _compact_buffers(int(cap_off[-1]), n_genes,
                                      nbins + 1 <= 255, ("values",))
    if n_genes:
        _call("compress_group_compact", "compress_group",
              n_cells, n_genes, nbins, _ptr(indptr, np.int64),
              _ptr(indices, np.int64), _ptr(data, np.int64),
              _ptr(bins, np.int32), _ptr(binvals, np.float64),
              _ptr(cap_off, np.int64), _ptr(bufs["values"], np.float32),
              _ptr(bufs["counts"], np.float32),
              _ptr(bufs["inv_sf"], np.float32),
              _ptr(bufs["sf_bin"], np.uint8), _ptr(n_unique, np.int32))
    return _group_result(bufs, cap_off, n_unique, binvals, n_cells,
                         pad_multiple, min_u)


def compress_group_range_native(X, approx_sf, col_start, col_stop,
                                pad_multiple=8, min_u=8):
    """The zero-copy C++ packer of genes ``[col_start, col_stop)`` of a CSC
    matrix, straight from ``X.indices`` / ``X.data`` as stored (int32/int64,
    float32/float64): no slice, no int64 conversion, no rounding pass.
    ``None`` for another format or dtype, for data that is not integral and
    non-negative, or for a histogram past ``MAX_HIST``."""
    if not sparse.issparse(X) or X.format != "csc":
        return None
    buffers = _native_buffers(X)
    if buffers is None:
        return None
    indices, data = buffers
    col_start, col_stop, _ = slice(col_start, col_stop).indices(X.shape[1])
    ncols = max(0, col_stop - col_start)
    # the second pass re-checks a matrix edited in place since its prep
    for fresh in (False, True):
        prep = _compress_range_prep(X, approx_sf, fresh)
        if prep is None:
            return None
        indptr, bins, binvals, bin_total, vmax = prep
        nbins = len(binvals)
        if (vmax + 1) * nbins > MAX_HIST:
            return None
        cap_off = np.zeros(ncols + 1, dtype=np.int64)
        np.cumsum(nbins + np.diff(indptr[col_start:col_start + ncols + 1]),
                  out=cap_off[1:])
        bufs, n_unique = _compact_buffers(int(cap_off[-1]), ncols,
                                          nbins + 1 <= 255, ("values",))
        if not ncols or _call(
                "compress_group_compact_range", "compress_group_range",
                col_start, col_start + ncols, nbins, _ptr(indptr, np.int64),
                _ptr(indices, indices.dtype), int(indices.dtype == np.int64),
                _ptr(data, data.dtype), int(data.dtype == np.float32),
                _ptr(bins, np.int32), _ptr(bin_total, np.int64),
                _ptr(binvals, np.float64), vmax, _ptr(cap_off, np.int64),
                _ptr(bufs["values"], np.float32),
                _ptr(bufs["counts"], np.float32),
                _ptr(bufs["inv_sf"], np.float32),
                _ptr(bufs["sf_bin"], np.uint8),
                _ptr(n_unique, np.int32)) == 0:
            return _group_result(bufs, cap_off, n_unique, binvals,
                                 X.shape[0], pad_multiple, min_u)
    raise RuntimeError("the matrix's data changed while it was being packed")


def _pair_indices(idx1, idx2, n_genes):
    i1 = np.ascontiguousarray(np.asarray(idx1, dtype=np.int64))
    i2 = np.ascontiguousarray(np.asarray(idx2, dtype=np.int64))
    if i1.shape != i2.shape or i1.ndim != 1:
        raise ValueError(f"pair index shapes {i1.shape} and {i2.shape}")
    if i1.size and (min(i1.min(), i2.min()) < 0
                    or max(i1.max(), i2.max()) >= n_genes):
        raise IndexError(f"pair gene index outside [0, {n_genes})")
    return i1, i2


def _sorted_csc(X):
    """X as CSC with sorted row indices (the pair merges need them; a CSC
    input is sorted in place, as scipy's own operations do)."""
    X = X.tocsc() if sparse.issparse(X) else sparse.csc_matrix(X)
    if not bool(X.has_sorted_indices):
        X.sort_indices()
    return X


def _rounded_stats(d):
    """``(ok, largest value)`` of count data rounded half to even, as the
    pair packer reads it: ``ok`` when every value is finite and rounds to
    a count >= 0.  Chunked, so no nnz-sized temporary is made."""
    if d.dtype.kind in "iu":
        return (not d.size or int(d.min()) >= 0), \
            (int(d.max()) if d.size else 0)
    vmax, step = 0, 1 << 24
    buf = np.empty(min(d.size, step), dtype=d.dtype)
    for s in range(0, d.size, step):
        r = np.rint(d[s:s + step], out=buf[:min(step, d.size - s)])
        lo, hi = float(r.min()), float(r.max())
        if not (lo >= 0 and np.isfinite(hi)):
            return False, 0
        vmax = max(vmax, int(hi))
    return True, vmax


def _pairs_prep(X, approx_sf, fresh: bool = False):
    """The pair packer's per-(matrix, size-factor) prep: int64 indptr,
    int32 bin ids, float64 bin values and the largest count, or ``None``
    for negative or non-finite counts.  Integral float data shares the
    range packers' prep; other data gets the same verdict for its values
    rounded half to even (the C++ rounds as it reads), cached on the matrix
    in the same way.  ``fresh`` recomputes both."""
    from ..ops.size_factor import factorize_approx_sf

    if _native_buffers(X) is not None:
        prep = _compress_range_prep(X, approx_sf, fresh)
        if prep is not None:
            indptr, bins, binvals, _, vmax = prep
            return indptr, bins, binvals, vmax
    cached = getattr(X, "_memento_torch_pairs_prep", None)
    if not fresh and cached is not None and cached[0] is approx_sf \
            and cached[1] == X.nnz:
        return cached[2]
    ok, vmax = _rounded_stats(X.data)
    out = None
    if ok:
        bin_values, bin_ids = factorize_approx_sf(approx_sf)
        out = (np.ascontiguousarray(X.indptr, dtype=np.int64),
               np.ascontiguousarray(bin_ids, dtype=np.int32),
               np.ascontiguousarray(bin_values, dtype=np.float64), vmax)
    try:
        X._memento_torch_pairs_prep = (approx_sf, X.nnz, out)
    except AttributeError:  # matrix subclasses without __dict__
        pass
    return out


def compress_pairs_native(X, approx_sf, idx1, idx2, pad_multiple=8,
                          min_u=8):
    """The C++ joint pair packer: one merge-plus-histogram pass per pair
    (OpenMP over pairs) writes compact runs at worst-case offsets
    (nbins + nnz(a) + nnz(b) slots per pair), then a ~U-sized numpy scatter
    fills the padded ``[P, U]`` tiles.  The data is read as scipy stores it
    (``compress_pairs_compact_v2``), float values rounded half to even as
    they are read, so no tile copies the matrix.  ``None`` for negative
    counts or values past 2^31 - 1."""
    from ..ops.compress import CompressedPairGroup

    X = _sorted_csc(X)
    n_cells, n_genes = X.shape
    i1, i2 = _pair_indices(idx1, idx2, n_genes)
    n_pairs = len(i1)
    indices = np.ascontiguousarray(X.indices)
    data = np.ascontiguousarray(X.data)
    if data.dtype not in _PAIR_DATA:  # a dtype the C++ does not read
        data = data.astype(np.float64)
    # the second pass re-checks a matrix edited in place since its prep
    for fresh in (False, True):
        prep = _pairs_prep(X, approx_sf, fresh)
        if prep is None:
            return None
        indptr, bins, binvals, vmax = prep
        if vmax > MAX_INT32:
            return None
        nbins = len(binvals)

        nnz_col = np.diff(indptr)
        cap_off = np.zeros(n_pairs + 1, dtype=np.int64)
        np.cumsum(nbins + nnz_col[i1] + nnz_col[i2], out=cap_off[1:])
        with_bins = nbins + 1 <= 255
        bufs, n_unique = _compact_buffers(int(cap_off[-1]), n_pairs,
                                          with_bins, ("values_1", "values_2"))
        if not n_pairs or _call(
                "compress_pairs_compact_v2", "compress_pairs",
                n_cells, n_genes, n_pairs, nbins, _ptr(indptr, np.int64),
                _ptr(indices, indices.dtype), int(indices.dtype == np.int64),
                _ptr(data, data.dtype), _PAIR_DATA[data.dtype],
                _ptr(bins, np.int32), _ptr(binvals, np.float64), vmax,
                _ptr(i1, np.int64), _ptr(i2, np.int64),
                _ptr(cap_off, np.int64), _ptr(bufs["values_1"], np.float32),
                _ptr(bufs["values_2"], np.float32),
                _ptr(bufs["counts"], np.float32),
                _ptr(bufs["inv_sf"], np.float32),
                _ptr(bufs["sf_bin"], np.uint8),
                _ptr(n_unique, np.int32)) == 0:
            break
    else:
        raise RuntimeError(
            "the matrix's data changed while it was being packed")
    t = _pad_runs({f: (bufs[f], fill) for f, fill in (
        ("values_1", 0.0), ("values_2", 0.0), ("counts", 0.0),
        ("inv_sf", 1.0), ("sf_bin", 0))}, cap_off, n_unique, pad_multiple,
        min_u)
    return CompressedPairGroup(values_1=t["values_1"], values_2=t["values_2"],
                               counts=t["counts"], n_obs=n_cells,
                               n_unique=n_unique,
                               **_sf_tail(t["inv_sf"], t.get("sf_bin"),
                                          binvals, with_bins))


def _f32_exact(data) -> bool:
    """True when casting ``data`` to float32 is lossless (the sums read
    float32; for other float64 data the scipy version would differ)."""
    if data.dtype != np.float64:
        return True
    return bool(np.array_equal(data.astype(np.float32).astype(np.float64),
                               data))


def _sum_arrays(X, fmt, index_limit):
    """Contiguous (indptr int64, indices int32, data float32) of a scipy
    matrix in format ``fmt``, or ``None`` when it is in another format, its
    indices would overflow int32 (``index_limit`` is the axis they index)
    or its float64 data is not exact in float32."""
    if not sparse.issparse(X) or X.format != fmt or index_limit > MAX_INT32:
        return None
    if not _f32_exact(X.data):
        return None
    return (np.ascontiguousarray(X.indptr, dtype=np.int64),
            np.ascontiguousarray(X.indices, dtype=np.int32),
            np.ascontiguousarray(X.data, dtype=np.float32))


def _check_zero_sf(size_factor, row_nnz):
    """A zero size factor is valid only for an all-zero cell (sf = total
    counts): its inf reciprocal is then never read by the sparse pass.  A
    zero factor on a non-empty cell would fill the sums with inf/nan, so it
    is refused.  ``row_nnz`` is a thunk, evaluated only when some factor is
    zero."""
    sf = np.asarray(size_factor, np.float64)
    zero = sf == 0
    if zero.any() and (np.asarray(row_nnz())[zero] > 0).any():
        raise ValueError(
            "size_factor contains 0 for a cell with nonzero counts; zero "
            "size factors are only valid for all-zero cells")
    return sf


def _inv(sf):
    with np.errstate(divide="ignore"):
        return np.ascontiguousarray(1.0 / sf)


def suffstats_csr_native(X, size_factor):
    """One fused CSR pass -> ``(s1, s2, s1sq)`` float64 per gene, or
    ``None``: in place of scipy's CSC conversion and ``X.power(2)``
    temporary (multi-GB at atlas scale)."""
    arrs = _sum_arrays(X, "csr", X.shape[1])
    if arrs is None:
        return None
    indptr, indices, data = arrs
    n, g = X.shape
    inv_sf = _inv(_check_zero_sf(size_factor, lambda: np.diff(indptr)))
    s1, s2, s1sq = (np.empty(g, np.float64) for _ in range(3))
    _call("suffstats_csr", "suffstats_csr", n, g, _ptr(indptr, np.int64),
          _ptr(indices, np.int32), _ptr(data, np.float32),
          _ptr(inv_sf, np.float64), _ptr(s1, np.float64),
          _ptr(s2, np.float64), _ptr(s1sq, np.float64))
    return s1, s2, s1sq


def suffstats_csc_native(X, size_factor):
    """CSC analogue of ``suffstats_csr_native`` (one gene per iteration)."""
    arrs = _sum_arrays(X, "csc", X.shape[0])
    if arrs is None:
        return None
    indptr, indices, data = arrs
    g = X.shape[1]
    inv_sf = _inv(_check_zero_sf(
        size_factor, lambda: np.bincount(indices, minlength=X.shape[0])))
    s1, s2, s1sq = (np.empty(g, np.float64) for _ in range(3))
    _call("suffstats_csc", "suffstats_csc", g, _ptr(indptr, np.int64),
          _ptr(indices, np.int32), _ptr(data, np.float32),
          _ptr(inv_sf, np.float64), _ptr(s1, np.float64),
          _ptr(s2, np.float64), _ptr(s1sq, np.float64))
    return s1, s2, s1sq


def pair_prods_csc_native(X, inv_sf_sq, idx1, idx2):
    """Per-pair ``sum_c x1 x2 / sf^2`` from a CSC matrix by a sorted-index
    intersection of the two columns (OpenMP over pairs), or ``None``: in
    place of scipy's column gathers.  Sorts X's indices in place if needed."""
    if sparse.issparse(X) and X.format == "csc" \
            and not bool(X.has_sorted_indices):
        X.sort_indices()
    arrs = _sum_arrays(X, "csc", X.shape[0])
    if arrs is None:
        return None
    indptr, indices, data = arrs
    i1, i2 = _pair_indices(idx1, idx2, X.shape[1])
    w2 = np.ascontiguousarray(np.asarray(inv_sf_sq, np.float64))
    prod = np.empty(len(i1), np.float64)
    _call("pair_prods_csc", "pair_prods_csc", len(i1), _ptr(indptr, np.int64),
          _ptr(indices, np.int32), _ptr(data, np.float32),
          _ptr(w2, np.float64), _ptr(i1, np.int64), _ptr(i2, np.int64),
          _ptr(prod, np.float64))
    return prod


def row_sums_csr_native(X, mask=None):
    """One CSR pass -> ``(row totals, masked row totals or None)`` float64,
    or ``None``: in place of ``X.sum(axis=1)`` and ``X.multiply(mask)``'s
    nnz-sized temporary."""
    arrs = _sum_arrays(X, "csr", X.shape[1])
    if arrs is None:
        return None
    indptr, indices, data = arrs
    n = X.shape[0]
    row_tot = np.empty(n, np.float64)
    mask_u8 = masked = None
    if mask is not None:
        mask_u8 = np.ascontiguousarray(np.asarray(mask, bool), np.uint8)
        if mask_u8.shape != (X.shape[1],):
            raise ValueError(f"mask shape {mask_u8.shape}, expected "
                             f"({X.shape[1]},)")
        masked = np.empty(n, np.float64)
    _call("row_sums_csr", "row_sums_csr", n, _ptr(indptr, np.int64),
          _ptr(indices, np.int32), _ptr(data, np.float32),
          _ptr(mask_u8, np.uint8), _ptr(row_tot, np.float64),
          _ptr(masked, np.float64))
    return row_tot, masked


def col_sums_csr_native(X):
    """One CSR pass -> ``(column sums float64, column nnz int64)``, or
    ``None``."""
    arrs = _sum_arrays(X, "csr", X.shape[1])
    if arrs is None:
        return None
    indptr, indices, data = arrs
    n, g = X.shape
    col_sum = np.empty(g, np.float64)
    col_nnz = np.empty(g, np.int64)
    _call("col_sums_csr", "col_sums_csr", n, g, _ptr(indptr, np.int64),
          _ptr(indices, np.int32), _ptr(data, np.float32),
          _ptr(col_sum, np.float64), _ptr(col_nnz, np.int64))
    return col_sum, col_nnz


def omp_threads() -> int:
    """OpenMP's thread count in the library's parallel regions."""
    fn = build.load("native").omp_get_max_threads  # libgomp, through it
    fn.restype = ctypes.c_int
    return int(fn())


__all__ = [
    "CALLS", "reset_calls", "MAX_HIST", "omp_threads",
    "compress_group_native", "compress_group_range_native",
    "compress_pairs_native", "suffstats_csr_native", "suffstats_csc_native",
    "pair_prods_csc_native", "row_sums_csr_native", "col_sums_csr_native",
]
