"""A pandas-free AnnData-lite container.

Counterpart of ``memento_tpu/containers.py`` without pandas: ``obs`` and
``var`` are ``ColumnTable``s, a small table of named 1-D numpy columns plus
an index array.  A pandas DataFrame (or anything with ``.columns`` and
``.index`` whose columns convert with ``np.asarray``) is accepted wherever a
table is expected, by duck typing; pandas is never imported.

- ``X``            : cell x gene count matrix (scipy.sparse CSR or ndarray)
- ``obs`` / ``var``: ``ColumnTable`` indexed by cell / gene names
- ``uns``          : side-car dict; the pipeline state lives in
                     ``uns['memento']`` as in the JAX package
"""

from __future__ import annotations

import copy as _copy

import numpy as np
import scipy.sparse as sparse


class ColumnTable:
    """Named 1-D numpy columns of equal length, plus an ``index`` array.

    ``table[name]`` returns a column, ``table[name] = values`` sets one,
    ``table.columns`` lists the names in order, ``table.values`` stacks the
    columns into a 2-D array.
    """

    def __init__(self, data=None, index=None):
        """``data``: a dict of name -> 1-D array, or a table-like object
        (``.columns``, ``.index``, columns by ``data[name]``)."""
        cols = {}
        if data is None:
            pass
        elif hasattr(data, "columns") and hasattr(data, "index"):
            for name in list(data.columns):
                cols[name] = np.asarray(data[name])
            if index is None:
                index = np.asarray(data.index)
        else:
            cols = {k: np.asarray(v) for k, v in dict(data).items()}
        lengths = {len(v) for v in cols.values()}
        if index is not None:
            lengths.add(len(index))
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal length: {sorted(lengths)}")
        n = lengths.pop() if lengths else 0
        self._cols = cols
        self.index = np.arange(n) if index is None else np.asarray(index)

    @property
    def columns(self) -> list:
        return list(self._cols)

    @property
    def shape(self):
        return (len(self.index), len(self._cols))

    @property
    def values(self) -> np.ndarray:
        if not self._cols:
            return np.empty((len(self.index), 0))
        return np.column_stack([self._cols[c] for c in self._cols])

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, name) -> np.ndarray:
        return self._cols[name]

    def __setitem__(self, name, values) -> None:
        values = np.asarray(values)
        if values.ndim == 0:
            values = np.full(len(self.index), values)
        if len(values) != len(self.index):
            raise ValueError(
                f"column {name!r} has {len(values)} rows, table has "
                f"{len(self.index)}")
        self._cols[name] = values

    def take(self, idx) -> "ColumnTable":
        """Rows ``idx`` (integer positions or a boolean mask)."""
        idx = np.asarray(idx)
        if idx.dtype == bool:
            idx = np.nonzero(idx)[0]
        return ColumnTable({k: v[idx] for k, v in self._cols.items()},
                           index=self.index[idx])

    def copy(self) -> "ColumnTable":
        return ColumnTable({k: v.copy() for k, v in self._cols.items()},
                           index=self.index.copy())

    def __repr__(self) -> str:
        return f"ColumnTable({self.shape[0]} rows x columns {self.columns})"


def _as_table(obj, n_rows: int, prefix: str) -> ColumnTable:
    """``obj`` as a ColumnTable; ``None`` -> an empty table indexed by
    ``prefix_0 .. prefix_{n-1}``."""
    if obj is None:
        return ColumnTable(
            index=np.array([f"{prefix}_{i}" for i in range(n_rows)]))
    return obj if isinstance(obj, ColumnTable) else ColumnTable(obj)


class AnnData:
    """Minimal AnnData stand-in (see module docstring)."""

    def __init__(self, X, obs=None, var=None, uns=None):
        if sparse.issparse(X):
            X = X.tocsr()
        self.X = X
        n_obs, n_var = X.shape
        self.obs = _as_table(obs, n_obs, "cell")
        self.var = _as_table(var, n_var, "gene")
        if len(self.obs) != n_obs:
            raise ValueError(f"obs has {len(self.obs)} rows, X has {n_obs}")
        if len(self.var) != n_var:
            raise ValueError(f"var has {len(self.var)} rows, X has {n_var}")
        self.uns = {} if uns is None else uns

    @property
    def shape(self):
        return self.X.shape

    @property
    def n_obs(self):
        return self.X.shape[0]

    @property
    def n_vars(self):
        return self.X.shape[1]

    def copy(self) -> "AnnData":
        return AnnData(self.X.copy(), obs=self.obs.copy(), var=self.var.copy(),
                       uns=_copy.deepcopy(self.uns))

    def _inplace_subset_var(self, mask) -> None:
        """Keep the genes in ``mask`` (boolean or integer positions)."""
        mask = np.asarray(mask)
        idx = np.nonzero(mask)[0] if mask.dtype == bool else mask
        self.X = self.X[:, idx]
        self.var = self.var.take(idx)

    def __repr__(self) -> str:
        return f"AnnData(lite) n_obs x n_vars = {self.n_obs} x {self.n_vars}"


__all__ = ["AnnData", "ColumnTable"]
