"""memento_tpu_torch: the PyTorch/CUDA port of memento_tpu.

Method-of-moments estimation of mean, residual variance and correlation of
scRNA-seq expression under a hypergeometric capture-noise model, with
differential mean (DE), variability (DV) and correlation (DC) tests by a
unique-value-compressed multinomial bootstrap and weighted meta-regression.
The bootstrap runs in a hand-written CUDA kernel
(``csrc/cascade_bootstrap.cu``) on an NVIDIA Hopper card; every other device
stage is PyTorch.

Public API (the JAX package's names):
  setup_memento, create_groups, get_groups, compute_1d_moments,
  ht_1d_moments, get_1d_moments, get_1d_ht_result (per gene);
  compute_2d_moments, ht_2d_moments, get_2d_moments, get_2d_ht_result
  (per gene pair); get_corr_matrix; prepare_to_save.  Multi-device and
  multi-process runs: ``parallel`` (a mesh of devices, ``torch.distributed``);
  the analyses' helpers: ``util``, ``simulate``, ``io.h5ad``.
"""

from .api import (
    compute_1d_moments,
    compute_2d_moments,
    create_groups,
    get_1d_ht_result,
    get_1d_moments,
    get_2d_ht_result,
    get_2d_moments,
    get_corr_matrix,
    get_groups,
    ht_1d_moments,
    ht_2d_moments,
    prepare_to_save,
    setup_memento,
)
from .containers import AnnData, ColumnTable

# the reference's submodule paths: analyses call ``memento.util.*`` and
# ``memento.simulate.*``
from . import util  # noqa: E402,F401
from .models import simulate  # noqa: E402,F401

__version__ = "0.2.0"

__all__ = [
    "setup_memento",
    "create_groups",
    "get_groups",
    "compute_1d_moments",
    "ht_1d_moments",
    "get_1d_moments",
    "get_1d_ht_result",
    "compute_2d_moments",
    "ht_2d_moments",
    "get_2d_moments",
    "get_2d_ht_result",
    "get_corr_matrix",
    "prepare_to_save",
    "AnnData",
    "ColumnTable",
]
