"""Hypothesis-test throughput on the reference's headline configuration.

    python -m memento_tpu_torch.drivers.bench [--device cuda]

The counterpart of the JAX package's root ``bench.py``, with its five
configurations on ``bench_simulate``'s counts (200,000 cells x 1,024 genes,
two groups split by cell index), each run once untimed at another seed and
then timed ``BENCH_REPS`` times (best and median):

  1. the headline: the 1D test on every gene, B = 1,000, permutation
     resampling with approximate p-values, tiles of 512;
  2. the 1D test on 256 genes at B = 10,000 (one tile);
  3. the 2D test on 512 pairs (``bench_pairs``), B = 1,000;
  4. the correlation matrix of one group's first 50,000 cells;
  5. the eQTL shape: 512 genes, up to 8 SNP columns each
     (``eqtl_design``), B = 5,000, bootstrap with GEV refinement.

Prints one JSON line (``_report.py``): ``metric``, ``value`` (genes/s of
the headline's best run), ``unit``, ``vs_baseline`` (against the reference
CPU memento's 0.0446 s a gene, BASELINE.md), ``median_value`` and
``extra`` with each configuration's times.

Environment knobs: BENCH_CELLS, BENCH_GENES, BENCH_BOOT, BENCH_TILE,
BENCH_REPS, BENCH_DEADLINE (seconds after which configurations are
skipped), BENCH_SKIP_EXTRA=1 (the headline only), BENCH_B10K_GENES,
BENCH_B10K_BOOT, BENCH_PAIRS, BENCH_CORR_CELLS, BENCH_CORR=0 (skip 4),
BENCH_EQTL_GENES, BENCH_EQTL_BOOT, BENCH_EQTL_KT, BENCH_EQTL=0 (skip 5).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from ..api import _corr_from_cov_np, _residual_variance_np
from ..inference.ht import run_ht_1d, run_ht_2d
from ..ops.corr import corr_matrix_device, cov_sparse_pairs
from ..ops.estimators import get_noise_model, mean_var_sparse
from ..ops.mv_regression import fit_mv_regressor
from ..ops.size_factor import bin_size_factor, estimate_size_factor
from ..utils import profiling
from . import _report
from ._data import bench_pairs, bench_simulate, eqtl_design

BASELINE_S_PER_GENE = 0.0446  # reference CPU memento, 200k cells, B=1000
Q = 0.1


def knobs() -> dict:
    env = _report.env_int
    return {
        "cells": env("BENCH_CELLS", 200_000),
        "genes": env("BENCH_GENES", 1024),
        "num_boot": env("BENCH_BOOT", 1000),
        "tile": env("BENCH_TILE", 512),
        "reps": env("BENCH_REPS", 5),
        "deadline_s": float(os.environ.get("BENCH_DEADLINE", 3000)),
        "skip_extra": os.environ.get("BENCH_SKIP_EXTRA", "") == "1",
        "b10k_genes": env("BENCH_B10K_GENES", 256),
        "b10k_boot": env("BENCH_B10K_BOOT", 10_000),
        "pairs": env("BENCH_PAIRS", 512),
        "corr_cells": env("BENCH_CORR_CELLS", 50_000),
        "skip_corr": os.environ.get("BENCH_CORR", "1") == "0",
        "eqtl_genes": env("BENCH_EQTL_GENES", 512),
        "eqtl_boot": env("BENCH_EQTL_BOOT", 5_000),
        "eqtl_kt": env("BENCH_EQTL_KT", 8),
        "skip_eqtl": os.environ.get("BENCH_EQTL", "1") == "0",
    }


def timed_reps(fn, n_reps: int, label: str, unit: str, n_units: int,
               over_deadline, dev):
    """One untimed call at seed 1, then ``n_reps`` timed calls at seed 0
    (each between two device synchronisations), fewer once past the
    deadline; ``resources`` covers them all."""
    _report.reset(dev)
    _report.log(f"[{label}] first call ...")
    t = time.perf_counter()
    fn(1)
    _report.log(f"[{label}] first call took {time.perf_counter() - t:.1f}s")
    times = []
    for rep in range(n_reps):
        t = time.perf_counter()
        fn(0)
        if dev.type == "cuda":
            import torch

            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t)
        _report.log(f"[{label}] run {rep + 1}/{n_reps}: {times[-1]:.2f}s")
        if over_deadline():
            _report.log(f"[{label}] deadline reached after {rep + 1} runs")
            break
    best, median = min(times), float(np.median(times))
    return {"reps": len(times), "times_s": times, "best_s": best,
            "median_s": median, f"best_{unit}_per_s": n_units / best,
            f"median_{unit}_per_s": n_units / median,
            "resources": _report.resources(dev, with_card=False)}


def main(argv=None) -> int:
    args = _report.parse_args(__doc__, argv)
    dev = _report.select_device(args.device)
    cfg = knobs()
    t_start = time.perf_counter()

    def over_deadline():
        return time.perf_counter() - t_start > cfg["deadline_s"]

    n_cells, n_genes = cfg["cells"], cfg["genes"]
    _report.log(f"simulating {n_cells} cells x {n_genes} genes ...")
    X = bench_simulate(n_cells, n_genes)
    model = get_noise_model("hyper_relative")
    half = n_cells // 2
    groups = [X[:half].tocsc(), X[half:].tocsc()]
    sf = estimate_size_factor(X, mask=np.ones(n_genes, bool), shrinkage=0.5)
    approx_sf = bin_size_factor(sf, num_bins=30)
    offs = [0, half, n_cells]
    asf = [approx_sf[offs[r]:offs[r + 1]] for r in range(2)]
    true_mean, true_var = (np.array(x) for x in zip(*(
        mean_var_sparse(groups[r], sf[offs[r]:offs[r + 1]], Q)
        for r in range(2))))
    mv = fit_mv_regressor(true_mean.ravel(), true_var.ravel())
    true_res_var = np.stack([_residual_variance_np(true_mean[r], true_var[r],
                                                   mv) for r in range(2)])
    covariate = np.ones((2, 1))
    treatment = np.array([[0.0], [1.0]])
    common = dict(approx_sf=asf, mv_coeffs=np.tile(mv, (2, 1)),
                  q=np.full(2, Q), covariate=covariate, model=model,
                  sampler="auto", device=dev)

    def run_1d(n_sub, seed, num_boot, tile, resampling="permutation",
               approx=True, treat=treatment):
        return run_ht_1d(
            seed, groups=[g[:, :n_sub] for g in groups],
            true_mean=true_mean[:, :n_sub],
            true_res_var=true_res_var[:, :n_sub], treatment=treat,
            num_boot=num_boot, resampling=resampling, approx=approx,
            boot_chunk=num_boot, tile_size=tile, **common)

    extra = {}
    profiling.reset_timings()
    head = timed_reps(lambda s: run_1d(n_genes, s, cfg["num_boot"],
                                       cfg["tile"]),
                      cfg["reps"], f"1d B={cfg['num_boot']}", "genes",
                      n_genes, over_deadline, dev)
    extra[f"ht_1d_B{cfg['num_boot']}"] = head
    extra["host_compress_s"] = profiling.timings().get(
        "ht1d.compress+pack", {}).get("total_s", 0.0)
    more = not cfg["skip_extra"]

    if more and not over_deadline():
        gb, bb = cfg["b10k_genes"], cfg["b10k_boot"]
        b10k = timed_reps(lambda s: run_1d(gb, s, bb, gb),
                          max(2, cfg["reps"] - 1), f"1d B={bb}", "genes", gb,
                          over_deadline, dev)
        b10k["ms_per_gene"] = b10k["best_s"] / gb * 1000
        extra[f"ht_1d_B{bb}_{gb}g"] = b10k

    if more and not over_deadline():
        n_pairs = cfg["pairs"]
        idx1, idx2 = bench_pairs(n_genes, n_pairs)
        true_corr = np.array([_corr_from_cov_np(
            cov_sparse_pairs(groups[r].tocsr(), sf[offs[r]:offs[r + 1]], Q,
                             idx1, idx2, model),
            true_var[r][idx1], true_var[r][idx2]) for r in range(2)])

        def run_2d(seed):
            return run_ht_2d(
                seed, groups=groups, idx1=idx1, idx2=idx2,
                true_corr=true_corr, treatment=treatment,
                num_boot=cfg["num_boot"], resampling="permutation",
                approx=True, boot_chunk=cfg["num_boot"], tile_size=n_pairs,
                **{k: v for k, v in common.items() if k != "mv_coeffs"})

        d2 = timed_reps(run_2d, max(2, cfg["reps"] - 1), "2d", "pairs",
                        n_pairs, over_deadline, dev)
        d2["vs_1d_baseline_floor"] = d2["best_pairs_per_s"] \
            * BASELINE_S_PER_GENE
        extra[f"ht_2d_B{cfg['num_boot']}_{n_pairs}p"] = d2

    if more and not cfg["skip_corr"] and not over_deadline():
        nc = cfg["corr_cells"]
        g0, sf0 = groups[0].tocsr()[:nc], sf[:nc]
        cm = timed_reps(lambda _s: corr_matrix_device(
            g0, sf0, Q, true_var[0], model, device=dev), 2, "corr_matrix",
            "cellgene2", g0.shape[0] * n_genes ** 2, over_deadline, dev)
        cm["config"] = [g0.shape[0], n_genes]
        cm["gene_pairs_per_s"] = n_genes ** 2 / cm["best_s"]
        extra[f"corr_matrix_{n_genes}g_{nc}c"] = cm

    if more and not cfg["skip_eqtl"] and not over_deadline():
        ge, be, kt = cfg["eqtl_genes"], cfg["eqtl_boot"], cfg["eqtl_kt"]
        nt, tens = eqtl_design(ge, kt)
        n_tests = int(nt.sum())
        eq = timed_reps(lambda s: run_1d(ge, s, be, ge, "bootstrap", False,
                                         tens),
                        2, "eqtl", "tests", n_tests, over_deadline, dev)
        eq["config"] = {"genes": ge, "num_boot": be, "kt_max": kt,
                        "tests": n_tests}
        eq["genes_per_s"] = ge / eq["best_s"]
        extra[f"eqtl_B{be}_{ge}g"] = eq

    extra["total_bench_walltime_s"] = time.perf_counter() - t_start
    baseline = 1.0 / BASELINE_S_PER_GENE
    best, median = head["best_genes_per_s"], head["median_genes_per_s"]
    _report.log(profiling.report())
    _report.emit({
        "metric": f"ht_1d_genes_per_s_{n_cells // 1000}k_cells_"
                  f"B{cfg['num_boot']}",
        "value": best, "unit": "genes/s", "vs_baseline": best / baseline,
        "median_value": median, "median_vs_baseline": median / baseline,
        "extra": extra, "device": str(dev),
        "cascade_launches": sum(v["resources"]["cascade_launches"]
                                for v in extra.values()
                                if isinstance(v, dict)),
        "peak_device_gib": max((v["resources"]["peak_device_gib"] or 0.0)
                               for v in extra.values()
                               if isinstance(v, dict))
        if dev.type == "cuda" else None,
        **{k: v for k, v in _report.resources(dev).items()
           if k in ("peak_host_rss_gib", "host_rss_gib", "card")},
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
