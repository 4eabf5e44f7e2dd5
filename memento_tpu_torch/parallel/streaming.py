"""Observed moments by streaming cell blocks through a mesh.

Counterpart of ``memento_tpu/parallel/streaming.py``.  The host path
computes a group's sufficient statistics in one float64 pass over the
sparse matrix (``ops.estimators.suffstats_sparse``).  Here dense cell blocks
stream through the mesh instead: each block's cells are split into slabs,
one per device (``sharded.dp_partials``), each device reduces its slab, and
the partials of every block and device add up on the host in float64.
Moments are plain sums, so the stream changes nothing but the order of
addition.

Numerics: the ``m2 - m1^2`` cancellation downstream amplifies any error in
the sums.  Two precisions:

- ``precision='high'`` (default): float64 partials on the device,
  accumulated in host float64: the host path's sums up to their order of
  addition.
- ``precision='fast'``: float32 partials (half the transfer and compute),
  still accumulated across blocks in host float64.

Every step has one block shape (the last block is zero-padded with zero
weights).  Blocks ship in the compact integer transport dtype
(``ops/transport.py``: the cast back on the device is exact).  Launches are
queued without waiting: the host pulls the partials only after the last
block is enqueued.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sparse

from ..ops.estimators import NoiseModel, mean_var_from_suffstats
from ..ops.transport import compact_transport_dtype
from .mesh import as_mesh
from .sharded import dp_partials


def stream_suffstats(mesh, X, size_factor, block: int = 8192,
                     precision: str = "high"):
    """Exact per-gene sufficient statistics by cell-block streaming.

    Args:
      mesh: a tuple of devices (cells of each block split over them).
      X: ``[N, G]`` scipy sparse or dense counts on the host (see
        ``distributed.stream_suffstats_multihost`` for a process's row
        range).
      size_factor: ``[N]`` per-cell size factors.
      block: cells per step (rounded down to a multiple of the mesh size,
        at least the mesh size).
      precision: ``'high'`` (float64 device partials) or ``'fast'``
        (float32); both accumulate across blocks in host float64.

    Returns:
      (s1, s2, s1sq): ``[G]`` float64 numpy arrays.
    """
    if precision not in ("high", "fast"):
        raise ValueError("precision must be 'high' or 'fast'")
    mesh = as_mesh(mesh)
    n, g = X.shape
    n_dev = len(mesh)
    block = max(n_dev, (block // n_dev) * n_dev)

    sf = np.asarray(size_factor, dtype=np.float64)
    issp = sparse.issparse(X)
    Xr = X.tocsr() if issp else np.asarray(X)
    dtype = np.float64 if precision == "high" else np.float32
    tdtype = compact_transport_dtype(Xr) or dtype

    partials = []
    for start in range(0, n, block):
        stop = min(start + block, n)
        xb = Xr[start:stop]
        xb = np.asarray(xb.toarray() if issp else xb, tdtype)
        w = 1.0 / sf[start:stop]
        w2 = w * w
        if stop - start < block:  # zero-pad the last block (zero weights)
            pad = block - (stop - start)
            xb = np.pad(xb, ((0, pad), (0, 0)))
            w = np.pad(w, (0, pad))
            w2 = np.pad(w2, (0, pad))
        partials += dp_partials(mesh, xb, w.astype(dtype), w2.astype(dtype))

    sums = [np.zeros(g, np.float64) for _ in range(3)]
    for part in partials:
        for acc, p in zip(sums, part):
            acc += p.cpu().numpy().astype(np.float64)
    return tuple(sums)


def stream_mean_var(mesh, X, size_factor, q, model: NoiseModel,
                    block: int = 8192, precision: str = "high"):
    """Observed per-gene ``(mean, var)`` float64 arrays by the streaming
    pipeline: in place of ``ops.estimators.mean_var_sparse`` where a mesh is
    given.  The moment transform runs on the host float64 sums."""
    n_obs = X.shape[0]
    if not model.relative:
        size_factor = np.ones(n_obs)
    s1, s2, s1sq = stream_suffstats(mesh, X, size_factor, block, precision)
    m, v = mean_var_from_suffstats(s1, s2, s1sq, n_obs, q, model)
    return np.asarray(m), np.asarray(v)


__all__ = ["stream_suffstats", "stream_mean_var"]
