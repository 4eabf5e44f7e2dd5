"""A minimal ``.h5ad`` reader and writer (the AnnData HDF5 format) on h5py,
without pandas.

Counterpart of ``memento_tpu/io/h5ad.py``, over the port's ``ColumnTable``
in place of DataFrames: CSR, CSC or dense ``X``; ``obs`` / ``var`` tables
with numeric, string, boolean and categorical columns; a nested ``uns`` of
scalars, arrays, string lists, tables (the ``1d_ht`` / ``2d_ht`` results)
and sparse matrices.  Files written by either package read in the other.

Format (the anndata >= 0.8 on-disk spec):
- sparse ``X``: a group of ``data`` / ``indices`` / ``indptr`` with attrs
  ``encoding-type`` (``'csr_matrix'`` / ``'csc_matrix'``) and ``shape``;
- tables: a group with attrs ``encoding-type='dataframe'``, ``_index``
  naming the index dataset, and ``column-order``;
- categoricals: a subgroup of ``categories`` and ``codes`` with attrs
  ``encoding-type='categorical'`` and ``ordered``.

Without pandas a column has no categorical dtype, so categoricals map to
plain arrays both ways: read, a categorical becomes the array of its values
(``categories[codes]``; a missing code, -1, reads as ``''``); written, a
string column of ``obs`` / ``var`` is stored as a categorical (sorted
categories and int32 codes), as anndata stores string columns.  The index
stays a string array.

h5py is imported inside the functions, so the package imports where h5py is
absent.  Entries that cannot be represented (callables, objects) are dropped
with a warning.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sparse

from ..containers import AnnData, ColumnTable


def _decode(x):
    return x.decode() if isinstance(x, bytes) else x


def _strings(values) -> np.ndarray:
    return np.array([str(v).encode() for v in values], dtype="S")


def _read_series(node):
    import h5py

    if isinstance(node, h5py.Group):  # categorical: codes + categories
        cats = np.array([_decode(c) for c in node["categories"][...]] + [""])
        codes = np.asarray(node["codes"][...], np.int64)
        return cats[np.where(codes < 0, len(cats) - 1, codes)]
    arr = node[...]
    if arr.dtype.kind in ("S", "O"):
        return np.array([_decode(v) for v in arr])
    return arr


def _read_table(group) -> ColumnTable:
    index_name = _decode(group.attrs.get("_index", "_index"))
    index = _read_series(group[index_name])
    order = group.attrs.get("column-order", None)
    cols = ([_decode(c) for c in order] if order is not None
            else [k for k in group.keys() if k != index_name])
    return ColumnTable({c: _read_series(group[c]) for c in cols
                        if c != index_name},
                       index=np.asarray(index).astype(str))


def _read_x(node):
    import h5py

    if isinstance(node, h5py.Group):
        enc = _decode(node.attrs.get("encoding-type", "csr_matrix"))
        shape = tuple(node.attrs["shape"])
        mat_cls = sparse.csr_matrix if "csr" in enc else sparse.csc_matrix
        return mat_cls((node["data"][...], node["indices"][...],
                        node["indptr"][...]), shape=shape)
    return node[...]


def _read_uns(group) -> dict:
    import h5py

    out = {}
    for k, v in group.items():
        if isinstance(v, h5py.Group):
            enc = _decode(v.attrs.get("encoding-type", ""))
            if enc in ("csr_matrix", "csc_matrix"):
                out[k] = _read_x(v)
            elif enc == "dataframe":
                out[k] = _read_table(v)
            elif enc == "categorical":
                out[k] = _read_series(v)
            else:
                out[k] = _read_uns(v)
        else:
            val = v[...]
            if val.ndim == 0:
                val = _decode(val.item())
            elif val.dtype.kind in ("S", "O") and val.ndim == 1:
                val = [_decode(x) for x in val]
            elif val.dtype.kind in ("S", "O"):
                val = np.char.decode(val.astype("S"), "utf-8")
            out[k] = val
    return out


def read_h5ad(path) -> AnnData:
    """Read an ``.h5ad`` file into the port's ``AnnData``."""
    import h5py

    with h5py.File(path, "r") as f:
        X = _read_x(f["X"])
        obs = _read_table(f["obs"]) if "obs" in f else None
        var = _read_table(f["var"]) if "var" in f else None
        uns = _read_uns(f["uns"]) if "uns" in f else {}
    return AnnData(X, obs=obs, var=var, uns=uns)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _write_categorical(group, name, values: np.ndarray):
    cats, codes = np.unique(values.astype(str), return_inverse=True)
    g = group.create_group(name)
    g.attrs["encoding-type"] = "categorical"
    g.attrs["encoding-version"] = "0.2.0"
    g.attrs["ordered"] = False
    g.create_dataset("categories", data=_strings(cats))
    g.create_dataset("codes", data=codes.astype(np.int32))


def _write_series(group, name, values, categorical: bool):
    values = np.asarray(values)
    if values.dtype.kind in ("O", "U", "S"):
        if categorical:
            _write_categorical(group, name, values)
            return
        ds = group.create_dataset(name, data=_strings(values))
        ds.attrs["encoding-type"] = "string-array"
    else:
        group.create_dataset(name, data=values)


def _write_table(f, name, table, categorical: bool):
    """A ``ColumnTable`` (or any table with ``.columns`` / ``.index``) as a
    dataframe group; string columns as categoricals where asked."""
    table = ColumnTable(table)
    g = f.create_group(name)
    g.attrs["encoding-type"] = "dataframe"
    g.attrs["encoding-version"] = "0.2.0"
    g.attrs["_index"] = "_index"
    g.attrs["column-order"] = _strings(table.columns)
    _write_series(g, "_index", np.asarray(table.index).astype(str), False)
    for c in table.columns:
        _write_series(g, str(c), table[c], categorical)


def _write_sparse(f, name, X):
    X = X if X.format == "csc" else X.tocsr()
    g = f.create_group(name)
    g.attrs["encoding-type"] = f"{X.format}_matrix"
    g.attrs["encoding-version"] = "0.1.0"
    g.attrs["shape"] = np.array(X.shape)
    g.create_dataset("data", data=X.data)
    g.create_dataset("indices", data=X.indices)
    g.create_dataset("indptr", data=X.indptr)


def _is_table(v) -> bool:
    return hasattr(v, "columns") and hasattr(v, "index")


def _write_uns(f, name, d, path=""):
    g = f.create_group(name)
    for k, v in d.items():
        key = str(k)
        kpath = f"{path}/{key}"
        if not isinstance(k, str):
            # e.g. the frozenset keys of treatment_for_gene in 2D eQTL mode
            warnings.warn(f"uns entry {kpath!r}: non-string key {k!r} "
                          "stringified", stacklevel=2)
        if isinstance(v, dict):
            _write_uns(g, key, v, kpath)
        elif _is_table(v):
            _write_table(g, key, v, categorical=False)
        elif sparse.issparse(v):
            _write_sparse(g, key, v)
        elif isinstance(v, str):
            g.create_dataset(key, data=np.bytes_(v))
        elif isinstance(v, (list, tuple)) and all(isinstance(x, str)
                                                   for x in v):
            g.create_dataset(key, data=_strings(v))
        elif isinstance(v, (bool, np.bool_)):
            g.create_dataset(key, data=bool(v))
        elif np.isscalar(v):
            g.create_dataset(key, data=v)
        else:
            arr = None
            try:
                arr = np.asarray(v)
            except (ValueError, TypeError):
                pass
            if arr is not None and arr.dtype.kind in "ifub":
                g.create_dataset(key, data=arr)
            elif arr is not None and arr.dtype.kind in ("U", "S"):
                g.create_dataset(key, data=_strings(arr.ravel()).reshape(
                    arr.shape))
            else:
                warnings.warn(
                    f"uns entry {kpath!r} of type {type(v).__name__} cannot "
                    "be written to h5ad and was dropped (run "
                    "prepare_to_save / strip transient state first)",
                    stacklevel=2)


def write_h5ad(path, adata: AnnData, include_uns: bool = True):
    """Write the port's ``AnnData`` to ``.h5ad`` (the spec subset above).

    String columns of ``obs`` / ``var`` are stored as categoricals; tables
    in ``uns`` (the ``1d_ht`` / ``2d_ht`` results), sparse matrices, numeric
    / string / bool arrays and nested dicts round-trip; other ``uns``
    entries are dropped with a warning.
    """
    import h5py

    with h5py.File(path, "w") as f:
        X = adata.X
        if sparse.issparse(X):
            _write_sparse(f, "X", X.tocsr())
        else:
            ds = f.create_dataset("X", data=np.asarray(X))
            ds.attrs["encoding-type"] = "array"
        _write_table(f, "obs", adata.obs, categorical=True)
        _write_table(f, "var", adata.var, categorical=True)
        if include_uns:
            _write_uns(f, "uns", adata.uns)


__all__ = ["read_h5ad", "write_h5ad"]
