"""Carry the JAX package's state across to the port.

The system has no weights.  What crosses between the two packages is data:
the fields of the JAX package's ``CompressedGroup``s and the arrays of its
``uns['memento']`` (size factors, quantized size factors, observed 1D
moments, mean-variance regressors).  ``from_jax_outputs`` turns them into
the port's structures as numpy arrays, so ``run_ht_1d`` / ``ht_1d_tile`` can
be fed exactly the inputs the JAX side saw.  It reads attributes and dict
keys only and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from .ops.compress import CompressedGroup

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


def from_jax_outputs(compressed=None, memento_uns=None) -> dict:
    """Port-side copies of JAX-side outputs.

    Args:
      compressed: sequence of JAX ``CompressedGroup``s (one per group).
      memento_uns: the JAX side's ``adata.uns['memento']`` dict.

    Returns:
      dict with ``'compressed'`` (list of port ``CompressedGroup``) and, per
      key of ``uns['memento']`` carried (``size_factor``,
      ``approx_size_factor``, ``1d_moments``, ``mv_regressor``), a dict of
      group -> float64 array (``1d_moments``: list of arrays).
    """
    out = {}
    if compressed is not None:
        out["compressed"] = [compressed_group(c) for c in compressed]
    if memento_uns is not None:
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


__all__ = ["from_jax_outputs", "compressed_group"]
