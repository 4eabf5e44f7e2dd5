"""The eQTL production shape at scale: per-gene SNP treatments.

    python -m memento_tpu_torch.drivers.eqtl_north_star [--device cuda]

The counterpart of the JAX package's ``examples/eqtl_north_star.py``:
10,240 genes of ``north_star``'s counts (the first columns of the cached
matrix, or counts simulated at that width), two groups split by cell index,
each gene testing 1 to 8 SNP dosage columns (``_data.eqtl_design``, about
46,000 gene-SNP tests, the treatment padded to Kt = 8), B = 5,000,
bootstrap resampling with GEV refinement, tiles of 1,024 genes, through
``inference/ht.py::run_ht_1d``.  Prints one JSON line (``_report.py``);
only the real (not padded) treatment columns count as tests.

Its two groups, split by cell index, are a kernel-scale shape and not the
deployment: memento's eQTL scan takes each donor as a group, per-gene SNP
treatments after donor covariates, through ``api.ht_1d_moments(...,
treatment_for_gene=...)``.  That deployment (120 donors, 6 cell types,
B = 5,000) is the benchmark's cell ``eqtl-donors``
(``benchmarks/kinds/eqtl_sweep_1d.py``).

Environment knobs: EQTL_GENES, EQTL_BOOT, EQTL_KT, EQTL_TILE, NS_CELLS,
NS_GENES, NS_CACHE, NS_DRAW (shared with ``north_star``).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from ..api import _residual_variance_np
from ..inference.ht import run_ht_1d
from ..ops.estimators import get_noise_model, mean_var_sparse
from ..ops.mv_regression import fit_mv_regressor
from ..ops.size_factor import bin_size_factor, estimate_size_factor
from ..utils import profiling
from . import _report
from ._data import (eqtl_design, load_or_simulate, north_star_device,
                    north_star_simulate)

CAPTURE_Q = 0.1


def knobs() -> dict:
    return {"cells": _report.env_int("NS_CELLS", 200_000),
            "genes": _report.env_int("NS_GENES", 20_000),
            "eqtl_genes": _report.env_int("EQTL_GENES", 10_240),
            "num_boot": _report.env_int("EQTL_BOOT", 5_000),
            "kt": _report.env_int("EQTL_KT", 8),
            "tile": _report.env_int("EQTL_TILE", 1024),
            "cache": os.environ.get("NS_CACHE", ""),
            "draw": os.environ.get("NS_DRAW", "numpy")}


def prepare(X) -> dict:
    """The two groups (halves of the cells, CSC), their binned size
    factors and observed moments, as the JAX driver sets them up."""
    n, g = X.shape
    half = n // 2
    groups = [X[:half].tocsc(), X[half:].tocsc()]
    sf = estimate_size_factor(X, mask=np.ones(g, bool), shrinkage=0.5)
    approx_sf = bin_size_factor(sf, num_bins=30)
    offs = [0, half, n]
    tm, tv = [], []
    for r in range(2):
        m, v = mean_var_sparse(groups[r], sf[offs[r]:offs[r + 1]], CAPTURE_Q)
        tm.append(m)
        tv.append(v)
    tm, tv = np.array(tm), np.array(tv)
    mv = fit_mv_regressor(tm.ravel(), tv.ravel())
    trv = np.stack([_residual_variance_np(tm[r], tv[r], mv)
                    for r in range(2)])
    return {"groups": groups,
            "approx_sf": [approx_sf[offs[r]:offs[r + 1]] for r in range(2)],
            "true_mean": tm, "true_res_var": trv,
            "mv_coeffs": np.tile(mv, (2, 1))}


def run_eqtl(state: dict, treatment, num_boot: int, tile: int, device,
             verbose=True):
    """``run_ht_1d`` with the padded per-gene treatment ``[G, 2, Kt]``;
    returns its result dict and wall seconds."""
    profiling.reset_timings()
    t = time.perf_counter()
    res = run_ht_1d(
        0, groups=state["groups"], approx_sf=state["approx_sf"],
        true_mean=state["true_mean"], true_res_var=state["true_res_var"],
        mv_coeffs=state["mv_coeffs"], q=np.full(2, CAPTURE_Q),
        covariate=np.ones((2, 1)), treatment=treatment, num_boot=num_boot,
        model=get_noise_model("hyper_relative"), sampler="auto",
        resampling="bootstrap", approx=False, boot_chunk=num_boot,
        tile_size=tile, verbose=verbose, device=device)
    return res, time.perf_counter() - t


def record(cfg: dict, n_cells: int, nt, res, wall: float) -> dict:
    g, kt = len(nt), cfg["kt"]
    valid = np.arange(kt)[None, :] < nt[:, None]  # the real columns
    n_tests = int(nt.sum())
    steady = profiling.steady_state(wall, "ht1d", n_tests)
    return {
        "config": {"cells": n_cells, "genes": g, "tests": n_tests,
                   "num_boot": cfg["num_boot"], "kt_max": kt,
                   "tile": cfg["tile"]},
        "wall_s": wall,
        "tests_per_s": n_tests / wall,
        "oneoff_s": steady["oneoff_s"],
        "steady_tests_per_s": steady["steady_items_per_s"],
        **_report.null_calibration(res["mean_pval"][valid]),
        "var_finite_pval_frac": float(
            np.isfinite(res["var_pval"][valid]).mean()),
    }


def main(argv=None) -> int:
    args = _report.parse_args(__doc__, argv)
    dev = _report.select_device(args.device)
    cfg = knobs()
    if cfg["cache"] and os.path.exists(cfg["cache"]):
        X = load_or_simulate(cfg["cache"], cfg["cells"], cfg["genes"],
                         cfg["draw"], dev)
        X = X[:, :cfg["eqtl_genes"]].tocsr()
    elif cfg["draw"] == "device":
        X = north_star_device(cfg["cells"], cfg["eqtl_genes"], device=dev)
    else:
        X = north_star_simulate(cfg["cells"], cfg["eqtl_genes"])
    _report.log(f"{X.shape[0]} cells x {X.shape[1]} genes")
    state = prepare(X)
    nt, treatment = eqtl_design(X.shape[1], cfg["kt"])
    _report.log(f"{int(nt.sum())} gene-SNP tests (mean {nt.mean():.2f} "
                f"SNPs/gene, Kt padded to {cfg['kt']}) at "
                f"B={cfg['num_boot']}")
    _report.reset(dev)
    res, wall = run_eqtl(state, treatment, cfg["num_boot"], cfg["tile"], dev)
    profiling.report(file=sys.stderr)
    _report.emit({**record(cfg, X.shape[0], nt, res, wall),
                  "device": str(dev), **_report.resources(dev)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
