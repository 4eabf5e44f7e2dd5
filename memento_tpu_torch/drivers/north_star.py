"""The 1D test at full transcriptome width, through the public API.

    python -m memento_tpu_torch.drivers.north_star [--device cuda]

The counterpart of the JAX package's ``examples/north_star.py``: 200,000
cells x 20,000 genes (``_data.north_star_simulate``), two conditions split
by cell index (a null design), every gene tested (no mean filter), B =
10,000, ``hyper_relative``, bootstrap resampling with GEV tail refinement:
``setup_memento`` -> ``create_groups`` -> ``compute_1d_moments`` ->
``ht_1d_moments`` -> ``get_1d_ht_result``.  Logs the phase report to stderr
and prints one JSON line (``_report.py``).

Environment knobs: NS_CELLS, NS_GENES, NS_BOOT, NS_TILE (0: the default
tile), NS_CACHE (an ``.npz`` that keeps the simulated counts across runs;
put it in a directory that ``.gitignore`` lists), NS_DRAW (``numpy``, the
default: the JAX script's numbers, drawn on one host thread; ``device``:
the same law drawn on the run's device, ``_data.north_star_device``).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from .. import api
from ..containers import AnnData, ColumnTable
from ..utils import profiling
from . import _report
from ._data import load_or_simulate

CAPTURE_Q = 0.1


def knobs() -> dict:
    return {"cells": _report.env_int("NS_CELLS", 200_000),
            "genes": _report.env_int("NS_GENES", 20_000),
            "num_boot": _report.env_int("NS_BOOT", 10_000),
            "tile": _report.env_int("NS_TILE", 0) or None,
            "cache": os.environ.get("NS_CACHE", ""),
            "draw": os.environ.get("NS_DRAW", "numpy")}


def prepare(X, phases: dict):
    """``X`` as an AnnData with the conditions split at half the cells,
    through ``setup_memento`` (no mean filter), ``create_groups`` by
    condition and ``compute_1d_moments`` (every gene kept); fills
    ``phases['setup']`` and ``phases['moments_1d']``."""
    n = X.shape[0]
    cond = (np.arange(n) >= n // 2).astype(int)
    adata = AnnData(X, obs={"condition": cond.astype(str),
                            "capture_q": np.full(n, CAPTURE_Q)})
    t = time.perf_counter()
    api.setup_memento(adata, q_column="capture_q", filter_mean_thresh=0.0,
                      trim_percent=0.1)
    api.create_groups(adata, label_columns=["condition"])
    phases["setup"] = time.perf_counter() - t
    t = time.perf_counter()
    api.compute_1d_moments(adata, min_perc_group=0.0)
    phases["moments_1d"] = time.perf_counter() - t
    return adata


def design(adata):
    """Intercept covariate and the condition as treatment, one row a
    group."""
    groups = api.get_groups(adata)
    covariate = ColumnTable({"intercept": np.ones(len(groups))},
                            index=groups.index)
    treatment = ColumnTable({"tx": groups["condition"].astype(np.float64)},
                            index=groups.index)
    return covariate, treatment


def run_1d(adata, num_boot: int, tile, device, phases: dict, verbose=1):
    """``ht_1d_moments`` on every gene; fills ``phases['ht_1d']`` and
    returns ``(result table, steady_state)``."""
    covariate, treatment = design(adata)
    profiling.reset_timings()
    t = time.perf_counter()
    api.ht_1d_moments(adata, covariate=covariate, treatment=treatment,
                      num_boot=num_boot, resampling="bootstrap",
                      tile_size=tile, verbose=verbose, device=device)
    phases["ht_1d"] = time.perf_counter() - t
    steady = profiling.steady_state(phases["ht_1d"], "ht1d", adata.n_vars)
    return api.get_1d_ht_result(adata), steady


def record(cfg: dict, adata, result, steady: dict, phases: dict) -> dict:
    """The driver's JSON record without ``resources``."""
    g = adata.n_vars
    ht = phases["ht_1d"]
    return {
        "config": {"cells": adata.n_obs, "genes_in": cfg["genes"],
                   "genes_tested": g, "num_boot": cfg["num_boot"],
                   "tile": cfg["tile"]},
        "phases_s": dict(phases),
        "ht_genes_per_s": g / ht,
        "ms_per_gene": ht / g * 1000,
        "ht_oneoff_s": steady["oneoff_s"],
        "ht_steady_genes_per_s": steady["steady_items_per_s"],
        "steady_ms_per_gene":
            1000.0 / max(steady["steady_items_per_s"], 1e-9),
        **_report.null_calibration(result["de_pval"]),
        "dv_finite_pval_frac":
            _report.null_calibration(result["dv_pval"])["finite_pval_frac"],
    }


def main(argv=None) -> int:
    args = _report.parse_args(__doc__, argv)
    dev = _report.select_device(args.device)
    cfg = knobs()
    phases = {}
    t = time.perf_counter()
    X = load_or_simulate(cfg["cache"], cfg["cells"], cfg["genes"],
                         cfg["draw"], dev)
    phases["simulate"] = time.perf_counter() - t
    _report.log(f"nnz = {X.nnz} "
                f"({X.nnz / X.shape[0] / X.shape[1]:.4f} density)")
    _report.reset(dev)
    adata = prepare(X, phases)
    result, steady = run_1d(adata, cfg["num_boot"], cfg["tile"], dev, phases)
    profiling.report(file=sys.stderr)
    _report.emit({**record(cfg, adata, result, steady, phases),
                  "device": str(dev), **_report.resources(dev)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
