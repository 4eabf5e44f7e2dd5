"""The ``memento.util`` names of the reference's analysis scripts.

Counterpart of ``memento_tpu/util.py``: the statistics helpers of
``utils.stats`` under the names the scripts use (``_fdrcorrect``, ...), and
the two private slicing helpers, without pandas.
"""

from __future__ import annotations

import numpy as np

from .utils.stats import (  # noqa: F401  (re-exports)
    concordance,
    density_scatterplot,
    fdrcorrect as _fdrcorrect,
    fdrcorrection,
    lambda_gc,
    robust_correlation,
    robust_hist,
    robust_linregress,
)


def _select_cells(adata, group):
    """The cells of one group (``obs['memento_group'] == group``) as CSC."""
    cell_selector = np.asarray(adata.obs["memento_group"]) == group
    return adata.X[cell_selector, :].tocsc()


def _get_gene_idx(adata, gene_list):
    """The position of each named gene in ``adata.var.index``."""
    index = np.asarray(adata.var.index)
    return np.array([np.where(index == gene)[0][0] for gene in gene_list])


__all__ = [
    "_select_cells",
    "_get_gene_idx",
    "_fdrcorrect",
    "fdrcorrection",
    "density_scatterplot",
    "robust_correlation",
    "robust_linregress",
    "robust_hist",
    "lambda_gc",
    "concordance",
]
