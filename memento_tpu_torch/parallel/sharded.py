"""Work split over the devices of a mesh.

Counterpart of ``memento_tpu/parallel/sharded.py``.  A mesh is a tuple of
``torch.device``s (``parallel/mesh.py``); each function here splits its
work over them by hand, where the JAX package leaves it to GSPMD:

- ``dp_suffstats``: a dense cell block split into slabs, one per device;
  each device reduces its slab and the partials add up (the ``psum``).
  The sufficient statistics are plain sums, so the split changes nothing
  but the order of addition.
- ``sharded_ht_1d_tile`` / ``sharded_ht_2d_tile``: one tile's gene (pair)
  axis split into pieces, one per device, each device running the tile
  program (and, on a card, the cascade kernel) on its piece.
- ``corr_matrix_sharded``: the G x G correlation matrix with its output
  columns split over the devices.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sparse
import torch

from ..device import fold_seed
from ..inference.ht import ht_1d_tile, ht_2d_tile
from ..ops.estimators import (NoiseModel, full_float32_matmul,
                              mean_var_from_suffstats, suffstats_dense)
from .mesh import as_mesh, split_range


def dp_partials(mesh, x_block, inv_sf, inv_sf_sq):
    """Per-device partial ``(s1, s2, s1sq)`` of a dense ``[N, G]`` cell
    block: rows split into contiguous slabs, one per mesh device, each
    reduced on its device (``suffstats_dense``) in the dtype of ``inv_sf``.
    The launches are queued and nothing is pulled to the host: a list of
    tensor triples, one per device with a non-empty slab."""
    mesh = as_mesh(mesh)
    out = []
    for dev, (lo, hi) in zip(mesh, split_range(x_block.shape[0], len(mesh))):
        if hi > lo:
            out.append(suffstats_dense(
                *(torch.as_tensor(a[lo:hi], device=dev)
                  for a in (x_block, inv_sf, inv_sf_sq))))
    return out


def dp_suffstats(mesh, x_block, inv_sf, inv_sf_sq):
    """Exact per-gene sufficient statistics of a dense cell block, with its
    cells split over the mesh.

    Args:
      mesh: a tuple of devices.
      x_block: ``[N, G]`` counts (numpy or tensor; padding rows zero).
      inv_sf / inv_sf_sq: ``[N]`` reciprocal size factors (0 on padding),
        whose dtype (float64 or float32) the sums take.

    Returns:
      (s1, s2, s1sq): ``[G]`` tensors on the mesh's first device, the sums
      of the devices' partials.
    """
    home = as_mesh(mesh)[0]
    parts = dp_partials(mesh, x_block, inv_sf, inv_sf_sq)
    return tuple(sum(p[i].to(home) for p in parts) for i in range(3))


def dp_mean_var(mesh, x_block, inv_sf, inv_sf_sq, n_obs, q,
                model: NoiseModel):
    """``dp_suffstats`` and the closed-form moment transform: per-gene
    ``(mean, var)`` tensors on the mesh's first device."""
    s1, s2, s1sq = dp_suffstats(mesh, x_block, inv_sf, inv_sf_sq)
    return mean_var_from_suffstats(s1, s2, s1sq, n_obs, q, model)


# Gene-carrying axes of ht_1d_tile's positional args:
#   seed, values[R,T,U], counts, inv_sf, inv_sf_sq, n_unique[R,T],
#   true_mean[R,T], true_res_var[R,T], mv_coeffs, q, n_obs, covariate,
#   treatment[T,R,Kt]
# With sf_binned, inv_sf_sq (4) is the [R, NB] bin table and is not split.
HT1D_GENE_AXES = {1: 1, 2: 1, 3: 1, 4: 1, 5: 1, 6: 1, 7: 1, 12: 0}

# Pair-carrying axes of ht_2d_tile's positional args:
#   seed, values_1[R,P,U], values_2[R,P,U], counts, inv_sf, inv_sf_sq,
#   true_corr[R,P], q, n_obs, covariate, treatment[P,R,Kt]
# With sf_binned, inv_sf_sq (5) is the [R, NB] bin table and is not split.
HT2D_PAIR_AXES = {1: 1, 2: 1, 3: 1, 4: 1, 5: 1, 6: 1, 10: 0}


def shard_ht_inputs(mesh, args, gene_axis_of: dict):
    """Split a tile's positional args over the mesh along their gene axes.

    Args:
      args: positional args of ``ht_1d_tile`` / ``ht_2d_tile`` (numpy arrays
        or tensors; position 0, the seed, is passed through).
      gene_axis_of: arg position -> the axis carrying genes (absent: every
        piece gets the whole arg).

    Returns:
      ``[(device, offset, piece_args), ...]``: one entry per device with a
      non-empty piece, ``offset`` its first gene within the tile.
    """
    mesh = as_mesh(mesh)
    first = min(gene_axis_of)
    n = args[first].shape[gene_axis_of[first]]
    pieces = []
    for dev, (lo, hi) in zip(mesh, split_range(n, len(mesh))):
        if hi == lo:
            continue
        piece = tuple(
            a[(slice(None),) * gene_axis_of[i] + (slice(lo, hi),)]
            if i in gene_axis_of else a for i, a in enumerate(args))
        pieces.append((dev, lo, piece))
    return pieces


def _sharded_tile(tile_fn, axes, table_pos, mesh, seed, args, start,
                  static):
    if static.get("sf_binned"):  # inv_sf_sq is the [R, NB] bin table
        axes = {i: a for i, a in axes.items() if i != table_pos}
    pieces = shard_ht_inputs(mesh, (seed,) + tuple(args), axes)
    home = pieces[0][0]
    results = [tile_fn(fold_seed(seed, start + off), *piece[1:], device=dev,
                       **static) for dev, off, piece in pieces]
    return {k: torch.cat([r[k].to(home) for r in results])
            for k in results[0]}


def sharded_ht_1d_tile(mesh, seed: int, *args, start: int = 0, **static):
    """``ht_1d_tile`` with the tile's gene axis split over the mesh.

    ``seed`` is the run's seed and ``start`` the tile's first gene, as in
    ``run_ht_1d``.  The T genes go to the devices in contiguous pieces
    (``split_range``), and each piece is a tile of its own, seeded as the
    tile loop seeds a tile: the piece at gene offset ``o`` of the tile runs
    ``ht_1d_tile(fold_seed(seed, start + o), <piece>, device=<its
    device>)``.  The result, the pieces' results concatenated on the first
    device, therefore equals bit for bit those unsplit tiles at those
    offsets.  (The JAX version equals its unsplit tile, since GSPMD splits
    one program over shared keys; here the kernel's Philox counter holds the
    row index within the tile, so pieces launched with one seed would repeat
    each other's draws.  A split tile equals the unsplit one in
    distribution, per PARITY.md's contract.)  ``static`` are
    ``ht_1d_tile``'s keyword options.
    """
    return _sharded_tile(ht_1d_tile, HT1D_GENE_AXES, 4, mesh, seed, args,
                         start, static)


def sharded_ht_2d_tile(mesh, seed: int, *args, start: int = 0, **static):
    """``ht_2d_tile`` with the tile's pair axis split over the mesh, seeded
    piece by piece as ``sharded_ht_1d_tile`` seeds its pieces (the tile
    then folds in the 2D path constant itself)."""
    return _sharded_tile(ht_2d_tile, HT2D_PAIR_AXES, 5, mesh, seed, args,
                         start, static)


def corr_matrix_sharded(mesh, X, size_factor, q, var, model,
                        block: int = 4096, row_block: int = 4096,
                        out_dtype=None):
    """All-by-all ``[G, G]`` correlation matrix with the Gram matrix's
    output columns split over the mesh.

    Each device holds ``S[:, cols_d]`` and the per-gene sums of its columns
    with their Kahan compensations, and accumulates every streamed cell
    block into them (``ops.corr._gram_update``: a float32 ``torch.matmul``
    with TF32 off, as the JAX package leaves this product to ``jnp.dot``
    outside any Pallas kernel).  Device memory per device is ``G x |cols_d|``
    twice.  The float64 finish runs on the host in ``[row_block, G]`` row
    slices gathered from the devices (``finish_corr_rows``): beyond the
    output, the host never holds more than one such slice.

    Args:
      mesh: a tuple of devices.
      X: ``[N, G]`` sparse or dense counts of one group.
      size_factor: ``[N]`` size factors; q: capture efficiency.
      var: ``[G]`` per-gene variances for the denominator.
      block: cells per streamed block.
      out_dtype: output dtype (default float64).

    Returns:
      ``[G, G]`` numpy array, as ``ops.corr.corr_matrix_device``.
    """
    from ..ops.corr import _gram_update, finish_corr_rows
    from ..ops.transport import compact_transport_dtype

    mesh = as_mesh(mesh)
    n, g = X.shape
    spans = [(dev, lo, hi) for dev, (lo, hi)
             in zip(mesh, split_range(g, len(mesh))) if hi > lo]
    state = [
        [torch.zeros((g, hi - lo), dtype=torch.float32, device=dev)
         if k in (0, 3) else
         torch.zeros(hi - lo, dtype=torch.float32, device=dev)
         for k in range(6)]
        for dev, lo, hi in spans]
    sf = np.asarray(size_factor, dtype=np.float64)
    issp = sparse.issparse(X)
    Xc = X.tocsr() if issp else np.asarray(X)
    tdtype = compact_transport_dtype(Xc) or np.float32

    with full_float32_matmul():
        for start in range(0, n, block):
            stop = min(start + block, n)
            xb = Xc[start:stop]
            xb = np.ascontiguousarray(xb.toarray() if issp else xb, tdtype)
            w = (1.0 / sf[start:stop]).astype(np.float32)
            w2 = (1.0 / sf[start:stop] ** 2).astype(np.float32)
            shipped = {}  # one copy per distinct device
            for d, (dev, lo, hi) in enumerate(spans):
                if dev not in shipped:
                    shipped[dev] = tuple(torch.as_tensor(a, device=dev)
                                         for a in (xb, w, w2))
                S, s1, sdiag, cS, cs1, csdiag = state[d]
                state[d] = list(_gram_update(
                    *shipped[dev], S, s1, sdiag, cS, cs1, csdiag,
                    cols=slice(lo, hi)))

    c = float(np.asarray(model.var_correction(q)))
    s1_h = np.concatenate([st[1].cpu().numpy() for st in state])
    sdiag_h = np.concatenate([st[2].cpu().numpy() for st in state])
    out = np.empty((g, g), dtype=out_dtype or np.float64)
    for r0 in range(0, g, row_block):
        r1 = min(r0 + row_block, g)
        s_rows = np.concatenate([st[0][r0:r1].cpu().numpy() for st in state],
                                axis=1)
        out[r0:r1] = finish_corr_rows(s_rows, r0, s1_h, sdiag_h, var, n, c)
    return out


__all__ = [
    "dp_partials",
    "dp_suffstats",
    "dp_mean_var",
    "sharded_ht_1d_tile",
    "sharded_ht_2d_tile",
    "shard_ht_inputs",
    "HT1D_GENE_AXES",
    "HT2D_PAIR_AXES",
    "corr_matrix_sharded",
]
