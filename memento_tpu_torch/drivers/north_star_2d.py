"""The 2D (differential correlation) test at scale, through the public API.

    python -m memento_tpu_torch.drivers.north_star_2d [--device cuda]

The counterpart of the JAX package's ``examples/north_star_2d.py``: on
``north_star``'s counts and state (200,000 cells x 20,000 genes, two
conditions split by cell index), 10,000 gene pairs among the 4,000 most
expressed genes (``_data.top_expressed_pairs``) at B = 1,000:
``compute_2d_moments`` -> ``ht_2d_moments`` -> ``get_2d_ht_result``.  Logs
the phase report to stderr and prints one JSON line (``_report.py``).

Environment knobs: NS_CELLS, NS_GENES, NS_PAIRS, NS_BOOT, NS_TILE,
NS_CACHE and NS_DRAW (shared with ``north_star``).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from .. import api
from ..utils import profiling
from . import _report
from ._data import load_or_simulate, top_expressed_pairs
from .north_star import design, prepare


def knobs() -> dict:
    return {"cells": _report.env_int("NS_CELLS", 200_000),
            "genes": _report.env_int("NS_GENES", 20_000),
            "pairs": _report.env_int("NS_PAIRS", 10_000),
            "num_boot": _report.env_int("NS_BOOT", 1_000),
            "tile": _report.env_int("NS_TILE", 0) or None,
            "cache": os.environ.get("NS_CACHE", ""),
            "draw": os.environ.get("NS_DRAW", "numpy")}


def run_2d(adata, n_pairs: int, num_boot: int, tile, device, phases: dict,
           verbose=1):
    """The pairs among the most expressed genes of ``adata`` (after
    ``north_star.prepare``), their observed moments and their test; fills
    ``phases['moments_2d']`` and ``phases['ht_2d']`` and returns ``(result
    table, steady_state)``."""
    i1, i2 = top_expressed_pairs(adata.X, n_pairs)
    names = np.asarray(adata.var.index)
    t = time.perf_counter()
    api.compute_2d_moments(adata, list(zip(names[i1], names[i2])))
    phases["moments_2d"] = time.perf_counter() - t
    covariate, treatment = design(adata)
    profiling.reset_timings()
    t = time.perf_counter()
    api.ht_2d_moments(adata, covariate=covariate, treatment=treatment,
                      num_boot=num_boot, resampling="bootstrap",
                      tile_size=tile, verbose=verbose, device=device)
    phases["ht_2d"] = time.perf_counter() - t
    steady = profiling.steady_state(phases["ht_2d"], "ht2d", n_pairs)
    return api.get_2d_ht_result(adata), steady


def record(cfg: dict, adata, result, steady: dict, phases: dict) -> dict:
    """The driver's JSON record without ``resources``."""
    n_pairs = cfg["pairs"]
    ht = phases["ht_2d"]
    return {
        "config": {"cells": adata.n_obs, "genes": cfg["genes"],
                   "pairs": n_pairs, "pairs_tested": len(result),
                   "num_boot": cfg["num_boot"], "tile": cfg["tile"]},
        "phases_s": dict(phases),
        "ht_pairs_per_s": n_pairs / ht,
        "ms_per_pair": ht / n_pairs * 1000,
        "ht_oneoff_s": steady["oneoff_s"],
        "ht_steady_pairs_per_s": steady["steady_items_per_s"],
        **_report.null_calibration(result["corr_pval"]),
    }


def main(argv=None) -> int:
    args = _report.parse_args(__doc__, argv)
    dev = _report.select_device(args.device)
    cfg = knobs()
    phases = {}
    t = time.perf_counter()
    X = load_or_simulate(cfg["cache"], cfg["cells"], cfg["genes"],
                         cfg["draw"], dev)
    phases["load"] = time.perf_counter() - t
    _report.reset(dev)
    sub = {}
    adata = prepare(X, sub)
    phases["setup+1d"] = sub["setup"] + sub["moments_1d"]
    result, steady = run_2d(adata, cfg["pairs"], cfg["num_boot"],
                            cfg["tile"], dev, phases)
    profiling.report(file=sys.stderr)
    _report.emit({**record(cfg, adata, result, steady, phases),
                  "device": str(dev), **_report.resources(dev)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
