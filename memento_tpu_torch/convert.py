"""Carry the JAX package's state across to the port.

The system has no weights.  What crosses between the two packages is data:
the fields of the JAX package's ``CompressedGroup``s and
``CompressedPairGroup``s and the arrays of its ``uns['memento']`` (size
factors, quantized size factors, observed 1D and 2D moments, mean-variance
regressors).  ``from_jax_outputs`` turns them into the port's structures as
numpy arrays, so ``run_ht_1d`` / ``run_ht_2d`` and their tiles can be fed
exactly the inputs the JAX side saw.  It reads attributes and dict
keys only and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from .ops.compress import CompressedGroup, CompressedPairGroup

_UNS_ARRAYS = ("size_factor", "approx_size_factor", "1d_moments",
               "mv_regressor")


def _optional(x, dtype):
    return None if x is None else np.array(x, dtype=dtype)


def compressed_group(c) -> CompressedGroup:
    """A port ``CompressedGroup`` from any object with the same fields."""
    return CompressedGroup(
        values=np.array(c.values, dtype=np.float32),
        counts=np.array(c.counts, dtype=np.float32),
        inv_sf=np.array(c.inv_sf, dtype=np.float32),
        inv_sf_sq=np.array(c.inv_sf_sq, dtype=np.float32),
        n_obs=int(c.n_obs),
        n_unique=np.array(c.n_unique, dtype=np.int32),
        sf_bin=_optional(getattr(c, "sf_bin", None), np.uint8),
        bin_inv_sf=_optional(getattr(c, "bin_inv_sf", None), np.float32),
    )


def compressed_pair_group(c) -> CompressedPairGroup:
    """A port ``CompressedPairGroup`` from any object with the same fields."""
    return CompressedPairGroup(
        values_1=np.array(c.values_1, dtype=np.float32),
        values_2=np.array(c.values_2, dtype=np.float32),
        counts=np.array(c.counts, dtype=np.float32),
        inv_sf=np.array(c.inv_sf, dtype=np.float32),
        inv_sf_sq=np.array(c.inv_sf_sq, dtype=np.float32),
        n_obs=int(c.n_obs),
        n_unique=np.array(c.n_unique, dtype=np.int32),
        sf_bin=_optional(getattr(c, "sf_bin", None), np.uint8),
        bin_inv_sf=_optional(getattr(c, "bin_inv_sf", None), np.float32),
    )


def _moments_2d(src) -> dict:
    """``uns['memento']['2d_moments']``: per group a dict of float64 ``cov,
    corr, var_1, var_2``; the pair index arrays as int64; the rest as is."""
    out = {}
    for key, val in src.items():
        if isinstance(val, dict):
            out[key] = {k: np.array(v, dtype=np.float64)
                        for k, v in val.items()}
        elif key in ("gene_idx_1", "gene_idx_2"):
            out[key] = np.array(val, dtype=np.int64)
        else:
            out[key] = val
    return out


def from_jax_outputs(compressed=None, memento_uns=None,
                     compressed_pairs=None) -> dict:
    """Port-side copies of JAX-side outputs.

    Args:
      compressed: sequence of JAX ``CompressedGroup``s (one per group).
      memento_uns: the JAX side's ``adata.uns['memento']`` dict.
      compressed_pairs: sequence of JAX ``CompressedPairGroup``s.

    Returns:
      dict with ``'compressed'`` (list of port ``CompressedGroup``),
      ``'compressed_pairs'`` (list of port ``CompressedPairGroup``) and, per
      key of ``uns['memento']`` carried (``size_factor``,
      ``approx_size_factor``, ``1d_moments``, ``mv_regressor``), a dict of
      group -> float64 array (``1d_moments``: list of arrays), plus
      ``2d_moments`` (per group ``cov, corr, var_1, var_2``, and
      ``gene_idx_1/2``).
    """
    out = {}
    if compressed is not None:
        out["compressed"] = [compressed_group(c) for c in compressed]
    if compressed_pairs is not None:
        out["compressed_pairs"] = [compressed_pair_group(c)
                                   for c in compressed_pairs]
    if memento_uns is not None:
        if "2d_moments" in memento_uns:
            out["2d_moments"] = _moments_2d(memento_uns["2d_moments"])
        for key in _UNS_ARRAYS:
            if key not in memento_uns:
                continue
            src = memento_uns[key]
            if key == "1d_moments":
                out[key] = {g: [np.array(m, dtype=np.float64) for m in v]
                            for g, v in src.items()}
            else:
                out[key] = {g: np.array(v, dtype=np.float64)
                            for g, v in src.items()}
    return out


__all__ = ["from_jax_outputs", "compressed_group", "compressed_pair_group"]
