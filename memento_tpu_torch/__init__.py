"""memento_tpu_torch: the PyTorch/CUDA port of memento_tpu (1D slice).

Method-of-moments estimation of mean and residual variance of scRNA-seq
expression under a hypergeometric capture-noise model, with differential
mean (DE) and differential variability (DV) tests by a unique-value-
compressed multinomial bootstrap and weighted meta-regression.  The
bootstrap runs in a hand-written CUDA kernel (``csrc/cascade_bootstrap.cu``)
on an NVIDIA Hopper card; every other device stage is PyTorch.

Public API (1D slice):
  setup_memento, create_groups, get_groups, compute_1d_moments,
  ht_1d_moments, get_1d_moments, get_1d_ht_result
"""

from .api import (
    compute_1d_moments,
    create_groups,
    get_1d_ht_result,
    get_1d_moments,
    get_groups,
    ht_1d_moments,
    setup_memento,
)
from .containers import AnnData, ColumnTable

__version__ = "0.1.0"

__all__ = [
    "setup_memento",
    "create_groups",
    "get_groups",
    "compute_1d_moments",
    "ht_1d_moments",
    "get_1d_moments",
    "get_1d_ht_result",
    "AnnData",
    "ColumnTable",
]
