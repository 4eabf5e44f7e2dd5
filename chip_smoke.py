#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``memento_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU (Hopper):

    python3 chip_smoke.py [--seed 0]

Phases, one line each:

  (a) the card and the builds: the kernel (``nvcc``, from
      ``memento_tpu_torch/csrc``) and, at the same time, the native host
      library (``g++``, from ``memento_tpu_torch/native``);
  (c) the 1D main path through the public API at the published runtime scale:
      200,000 cells x 1,024 genes, 2 conditions x 2 replicates,
      ``hyper_relative``, bootstrap resampling with GEV tail refinement,
      B = 1000, a 1.6x mean effect planted on 64 genes, its host stages
      through the native layer (the call counts must show it), and its
      phase report (``profiling.report``); then the same API on a small
      slice on the card and on the CPU (plain path) for agreement;
  (e) the 2D main path (differential correlation) on the state (c) left:
      512 unordered gene pairs over the genes that passed the filter, same
      options, a correlation planted on 64 of the pairs in condition 1 only,
      and its phase report; then the same API on the small slice on the
      card and on the CPU;
  (f) ``get_corr_matrix`` for one group of 50,000 cells on the card, held
      against the pair path's host float64 correlations, and against the CPU
      on the small slice;
  (g) the native host layer against its plain numpy/scipy version at full
      scale on the card's host, both timed: the group packer on each of
      (c)'s groups (the same combos per gene), the pair packer on (e)'s pairs
      (slot for slot), the sufficient statistics (CSR and CSC), the size
      factors (total and masked), the observed mean and the pair products of
      ``cov_sparse_pairs`` (rtol 1e-12);
  (h) the tests' other options at full width on the state (c) and (e) left,
      each timed with its peak device memory: the exact multinomial sampler
      in 1D and 2D (held against (c)'s and (e)'s cascade runs: the same
      coefficients, SEs within 10%), the Poisson and Gaussian samplers in
      chunks of 256 replicates, per-gene treatments (eQTL mode), a
      checkpointed run resumed after one block file is deleted (bit for bit,
      one block recomputed) and a custom estimator tuple through the whole
      pipeline (the device path); then on (c)'s small slice, card against
      CPU: 2D with the Poisson and Gaussian samplers, with a custom tuple and
      with per-pair treatments, and a numpy-only 1D estimator (the host
      path);
  (i) multi-GPU and multi-process on the state (c), (e) and (f) left: (i1)
      the 1D and 2D tests at 4 tiles each (tile sizes 240 and 128) on
      ``make_mesh()`` (the visible cards) and on ``cuda:0`` listed twice,
      bit for bit equal to the run without a mesh, 4 launches each; (i2)
      ``stream_mean_var`` over the whole matrix in both precisions against
      the native float64 pass, and ``setup_memento`` /
      ``compute_1d_moments`` with the mesh against (c)'s state; (i3)
      ``get_corr_matrix`` with the mesh against the pair path; (i4) two
      worker processes of this script (``--worker RANK PORT DIR``) sharing
      the card over gloo, each rebuilding (c)'s dataset and running both
      tests with ``distributed=True`` and without in the same process (bit
      for bit equal, 2 launches a path per rank), rank 0's merged results
      calibrated as (c)'s and (e)'s, its 1D result bit for bit (i1)'s run
      without a mesh; each (i1) run's ``profiling.steady_state``;
  (b) the kernel against its plain PyTorch version on each main path's own
      tile, B = 2000: W = 1 and W = 2 on the 1D tile, W = 5 on the 2D tile,
      and on the first tile of each path's tiling in (i) (W = 2 on 240
      genes, W = 5 on 128 pairs), in distribution; then, with the same
      seed, element by element against the plain version fed from the
      kernel's own Philox stream
      (``fused_bootstrap_sums_philox``) on a subsample of rows, B = 256; two
      launches with one seed bit for bit, and B = 1000 against the first
      1000 replicates of B = 2000;
  (d) the kernel's time and its plain version's at each main path's tile
      shape (W = 2 and W = 5), B = 1000 and B = 10000, beside the bound
      (``memento_tpu_torch.utils.roofline``: which resource bounds it and
      the share of the bound reached); the wrapper's tensor operations and
      the launch alone, the launch with the rows longest first and in index
      order;
  (l) the exact sampler's kernel (``csrc/multinomial_bootstrap.cu``) on
      one group call of each main path (group 0's rows of (b)'s 1D tile,
      W = 2, and of its 2D tile, W = 5): with one seed, draw by draw against
      its plain version on the kernel's Philox stream
      (``fused_multinomial_sums_philox``) on ~128 rows, B = 256, at most
      ``MN_FLIP_SHARE`` of the replicates off; two launches bit for bit and
      B = 1000 the first 1000 replicates of B = 2000; in distribution
      against the ``torch.binomial`` chain it replaced (B = 2000); its time,
      the launch's alone and the chain's at B = 1000 beside the bound
      (``memento_tpu_torch.utils.roofline.multinomial_roofline``);
  (m) the GEV refit kernel (``csrc/gev_refine.cu``) on the flagged rows of
      (c)'s 1D tile and of (e)'s 2D tile (the rows the main paths handed to
      the refit), against the numpy path (``inference/gev.py::
      gev_refine_batch``) on the same rows: the share of (row, side) with
      the same accepted stage, the largest relative p-value difference
      where the stages agree, the largest in decades, the fits of both,
      a relaunch bit for bit; the kernel's time (the launch with its sort,
      and the settling with the host's rows) beside the numpy path's and
      the bound (``memento_tpu_torch.utils.roofline.gev_refine_roofline``);
  (j) the main paths under the device trace: one ``ht_1d_moments`` and one
      ``ht_2d_moments`` at (c)'s and (e)'s settings on their state inside
      ``profiling.device_trace`` (Chrome traces in ``chiprun_out/traces/``),
      each bit for bit (c)'s or (e)'s result with one cascade launch; per
      path the traced window, the device busy share, the top device
      operations and the longest idle gaps with the phases that overlap
      them (``trace_summary``); then one launch closed by ``sync_pull``;
  (k) the north-star scale of the scale drivers (``memento_tpu_torch/
      drivers/``), through the drivers' own functions, on one matrix of
      200,000 cells x 20,000 genes (``north_star_simulate``'s law, drawn on
      the card by ``_data.north_star_device``): (k1) the 1D test on every
      gene, two conditions split by cell index (a null design), B = 10,000
      (19 tiles); (k2) the 2D test on 10,000 pairs among the 4,000 most
      expressed genes, B = 1,000 (5 tiles); (k3) ``get_corr_matrix`` of one
      group (100,000 cells x 20,000 genes), 2,000 random entries held
      against the host float64 pair path; (k4) the eQTL shape, 10,240 genes
      with 1 to 8 SNP columns each, B = 5,000, tiles of 1,024.  Each line
      gives the seconds per stage, ``steady_state``, the peak device memory,
      the host RSS, the cascade launches (one a tile) and the card; the
      null gates hold the p-values.  (b) then checks the kernel on the first
      tile of (k1) (W = 2) and of (k2) (W = 5).

Then one JSON line of kernels, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed phase raises: the script
exits non-zero and prints no result line.  It refuses to run without a CUDA
device and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N_CELLS = 200_000
N_GENES = 1024
N_PLANTED = 64
EFFECT = 1.6
NUM_BOOT = 1000
CAPTURE_Q = 0.1  # the noise model's capture efficiency (obs column)
N_PAIRS = 512  # gene pairs of the 2D path
N_PLANTED_PAIRS = 64  # of them, correlated in condition 1 only
PLANT_MIN_MEAN = 0.5  # planted pairs take genes with at least this base mean
# generator scale: bench.py thins its NB means by 0.1, which leaves most
# genes under the 0.07 mean filter; at 1.0 about 92% of genes pass it
SIM_SCALE = 1.0

# phase (d)'s name for the resource that bounds a launch
BOUND_BY = {"hbm": "bytes", "fp32": "operations"}
# phase (j): where the device traces land (a gitignored output directory)
TRACE_DIR = os.path.join("chiprun_out", "traces")
CASCADE_KERNEL = "cascade_bootstrap_kernel"  # its name in a device trace
COLS_1D = ("de_coef", "de_se", "de_pval", "dv_coef", "dv_se", "dv_pval")
COLS_2D = ("corr_coef", "corr_se", "corr_pval")
# same-seed comparison of the kernel with the plain version on the kernel's
# Philox stream: limits on the relative differences of the sums.  On the
# card most sums come out bit-identical (median 0) and at least 99.998% of
# them within 5e-4 (the rest are sums near zero); a wrong or reused word in
# one bin of four moves most sums by ~4e-3 and a flipped rounding by ~2e-5.
SAME_SEED_MEDIAN = 1e-6
SAME_SEED_WITHIN = 5e-4
SAME_SEED_SHARE = 0.999


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def simulate(rng, n_cells, n_genes, pair_rng):
    """bench.py's NB-style generator (gamma-Poisson, log-uniform base means)
    with 2 conditions x 2 replicates in equal blocks, a planted mean effect
    on the first genes of condition 1, and a planted correlation on
    ``N_PLANTED_PAIRS`` disjoint gene pairs in condition 1.

    The two genes of a planted pair share half of their Gamma(2) expression
    factor (a common Gamma(1) term), so the factors correlate at 0.5 while
    each gene keeps its marginal law.  The pairs take genes without a mean
    effect, and their condition-1 counts are drawn from ``pair_rng`` after
    the main stream has drawn the whole matrix: every other count is what
    the generator gave before the pairs were planted.

    Returns ``(X, obs, planted)``; ``planted`` is ``[N_PLANTED_PAIRS, 2]``
    gene indices.
    """
    import scipy.sparse as sparse

    base = np.exp(rng.uniform(np.log(0.05), np.log(3.0), n_genes))
    eligible = np.nonzero((np.arange(n_genes) >= N_PLANTED)
                          & (base >= PLANT_MIN_MEAN))[0]
    planted = eligible[:2 * N_PLANTED_PAIRS].reshape(N_PLANTED_PAIRS, 2)
    per = n_cells // 4
    blocks, cond, rep = [], [], []
    for c in range(2):
        means = base.copy()
        if c == 1:
            means[:N_PLANTED] *= EFFECT
        for r in range(2):
            for start in range(0, per, 20_000):
                m = min(20_000, per - start)
                lam = rng.gamma(2.0, means / 2.0, size=(m, n_genes))
                counts = rng.poisson(lam * SIM_SCALE)
                if c == 1:
                    shared = pair_rng.gamma(1.0, 1.0, (m, N_PLANTED_PAIRS))
                    factor = np.repeat(shared, 2, axis=1) + pair_rng.gamma(
                        1.0, 1.0, (m, 2 * N_PLANTED_PAIRS))
                    counts[:, planted.ravel()] = pair_rng.poisson(
                        factor * means[planted.ravel()] / 2.0 * SIM_SCALE)
                blocks.append(sparse.csr_matrix(counts.astype(np.float32)))
            cond += [c] * per
            rep += [r] * per
    X = sparse.vstack(blocks).tocsr()
    obs = {
        "condition": np.array(cond).astype(str),
        "replicate": np.array(rep).astype(str),
        "capture_q": np.full(len(cond), CAPTURE_Q),
    }
    return X, obs, planted


def hyper_1d(data, n_obs, q, size_factor=None):
    """``hyper_relative``'s moments as a user estimator with the reference's
    dual signature: a tuple ``(expr [U, 1], draws [U, B])`` of tensors (its
    replicate moments), or a sparse matrix (its observed moments, scipy)."""
    if isinstance(data, tuple):
        m1 = (data[0] * data[1] * size_factor[0]).sum(axis=0) / n_obs
        m2 = (data[0] ** 2 * data[1] * size_factor[1]
              - (1 - q) * data[0] * data[1] * size_factor[1]).sum(
                  axis=0) / n_obs
        return [m1, m2 - m1 * m1]
    weight = (1.0 / size_factor).reshape(1, -1)
    m1 = np.asarray(weight @ data).ravel() / n_obs
    m2 = (np.asarray(weight**2 @ data.power(2)).ravel()
          - (1 - q) * np.asarray(weight**2 @ data).ravel()) / n_obs
    return [m1, m2 - m1 * m1]


def numpy_hyper_1d(data, n_obs, q, size_factor=None):
    """``hyper_1d`` written for numpy only (as for the reference): it cannot
    take a CUDA tensor, so the port runs it on the host."""
    if isinstance(data, tuple):
        expr, draws = (np.asarray(x, dtype=np.float64) for x in data)
        isf, isf2 = (np.asarray(x, dtype=np.float64) for x in size_factor)
        m1 = (expr * draws * isf).sum(axis=0) / n_obs
        m2 = (expr**2 * draws * isf2 - (1 - q) * expr * draws * isf2).sum(
            axis=0) / n_obs
        return [m1, m2 - m1**2]
    return hyper_1d(data, n_obs, q, size_factor)


def hyper_cov(data, n_obs, q, size_factor, idx1=None, idx2=None):
    """``hyper_relative``'s covariance of two distinct genes, dual
    signature: a tuple ``(expr1 [U, 1], expr2 [U, 1], draws [U, B])`` or a
    sparse matrix with the pairs' gene indices."""
    if isinstance(data, tuple):
        m1 = (data[0] * data[2] * size_factor[0]).sum(axis=0) / n_obs
        m2 = (data[1] * data[2] * size_factor[0]).sum(axis=0) / n_obs
        mx = (data[0] * data[1] * data[2] * size_factor[1]).sum(
            axis=0) / n_obs
        return mx - m1 * m2
    weight = (1.0 / size_factor).reshape(-1, 1)
    x = data[:, idx1].multiply(weight).tocsr()
    y = data[:, idx2].multiply(weight).tocsr()
    prod = np.asarray(x.multiply(y).sum(axis=0)).ravel() / n_obs
    return prod - (np.asarray(x.mean(axis=0)).ravel()
                   * np.asarray(y.mean(axis=0)).ravel())


def measured(fn, *a, **kw):
    """``fn(*a, **kw)`` between two device synchronisations: its result and
    ``{s, peak_gib, cascade_launches, multinomial_launches, custom_paths}``
    of the call."""
    import torch

    from memento_tpu_torch.ops import bootstrap, cuda_kernels

    cuda_kernels.reset_launches()
    bootstrap.reset_custom_paths()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    torch.cuda.synchronize()
    return out, {
        "s": round(time.perf_counter() - t0, 3),
        "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
        "cascade_launches": cuda_kernels.LAUNCHES[cuda_kernels.CASCADE],
        "multinomial_launches":
            cuda_kernels.LAUNCHES[cuda_kernels.MULTINOMIAL],
        "custom_paths": dict(bootstrap.CUSTOM_PATHS)}


def same_coefficients(res, base, cols, label, rtol=1e-5, atol=1e-6):
    """The rows of two result tables name the same items and their
    (deterministic) coefficients agree."""
    for key in ("gene", "gene_1", "gene_2"):
        if key in base.columns and list(res[key]) != list(base[key]):
            raise AssertionError(f"{label}: {key} lists differ")
    for col in cols:
        np.testing.assert_allclose(res[col], base[col], rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=f"{label} {col}")


def se_log_ratio(res, base, col):
    """Median |log(SE / SE of ``base``)| over the rows finite in both."""
    a, b = np.asarray(res[col], float), np.asarray(base[col], float)
    ok = np.isfinite(a) & np.isfinite(b) & (a > 0) & (b > 0)
    return float(np.median(np.abs(np.log(a[ok] / b[ok]))))


def median_dp(res, base, col):
    return float(np.nanmedian(np.abs(np.asarray(res[col], float)
                                     - np.asarray(base[col], float))))


def require(ok: bool, message: str) -> None:
    if not ok:
        raise AssertionError(message)


def unique_pairs(adata):
    """The unordered gene-name pairs of ``compute_2d_moments`` that the 2D
    test runs (no self-pair), in order of first appearance."""
    seen = []
    for a, b in adata.uns["memento"]["2d_moments"]["gene_pairs"]:
        key = frozenset((a, b))
        if a != b and key not in seen:
            seen.append(key)
    return seen


def options_full_width(mtt, adata, dev, base, base2, planted2, X, obs,
                       genes):
    """Phase (h) at full width: each option's run against (c)'s (``base``)
    or (e)'s (``base2``) on the same state; returns a dict of each run's
    numbers.  Every gate raises."""
    covariate, treatment = design(mtt, adata)
    ht = dict(covariate=covariate, treatment=treatment, num_boot=NUM_BOOT,
              resampling="bootstrap", approx=False, verbose=0, device=dev)

    def run_1d(ad=adata, **kw):
        mtt.ht_1d_moments(ad, **dict(ht, **kw))
        return mtt.get_1d_ht_result(ad)

    def run_2d(**kw):
        mtt.ht_2d_moments(adata, **dict(ht, **kw))
        return mtt.get_2d_ht_result(adata)

    out = {}
    planted = planted_genes_of(base)
    # exact multinomial, 1D and 2D: the cascade kernel held against the
    # multinomial kernel's exact conditional binomials at full scale
    res, info = measured(run_1d, sampler="multinomial")
    require(info["cascade_launches"] == 0 and info["multinomial_launches"],
            f"multinomial 1D: {info}")
    same_coefficients(res, base, ("de_coef", "dv_coef"), "multinomial 1D")
    info["se_log_ratio"] = {c: se_log_ratio(res, base, c)
                            for c in ("de_se", "dv_se")}
    require(max(info["se_log_ratio"].values()) < 0.10,
            f"multinomial 1D SEs against the cascade's: {info}")
    info["power_null_median_fp"] = calibration(res["de_pval"], planted,
                                               "(h) multinomial 1D")
    info["median_dp"] = {c: median_dp(res, base, c)
                         for c in ("de_pval", "dv_pval")}
    out["1d_multinomial"] = info

    res, info = measured(run_2d, sampler="multinomial")
    require(info["cascade_launches"] == 0 and info["multinomial_launches"],
            f"multinomial 2D: {info}")
    same_coefficients(res, base2, ("corr_coef",), "multinomial 2D")
    info["se_log_ratio"] = se_log_ratio(res, base2, "corr_se")
    require(info["se_log_ratio"] < 0.10,
            f"multinomial 2D SEs against the cascade's: {info}")
    info["power_null_median_fp"] = calibration(res["corr_pval"], planted2,
                                               "(h) multinomial 2D")
    info["median_dp"] = median_dp(res, base2, "corr_pval")
    out["2d_multinomial"] = info

    # the materialized samplers, 256 replicates a chunk: not conditioned on
    # N, so their SEs are expected at or above the cascade's (not gated)
    for sampler in ("poisson", "gaussian"):
        res, info = measured(run_1d, sampler=sampler, boot_chunk=256)
        require(info["cascade_launches"] == 0, f"{sampler}: {info}")
        same_coefficients(res, base, ("de_coef", "dv_coef"), sampler)
        info["power_null_median_fp"] = calibration(
            res["de_pval"], planted, f"(h) {sampler}",
            check_null_median=False)
        info["median_se_ratio"] = float(np.nanmedian(
            np.asarray(res["de_se"], float) / np.asarray(base["de_se"])))
        out[f"1d_{sampler}"] = info

    # eQTL mode: even genes test the condition, odd genes also the replicate
    groups = mtt.get_groups(adata)
    two = mtt.ColumnTable({"tx": groups["condition"].astype(np.float64),
                           "rep": groups["replicate"].astype(np.float64)},
                          index=groups.index)
    tfg = {g: ["tx"] if i % 2 == 0 else ["tx", "rep"]
           for i, g in enumerate(adata.var.index)}
    res, info = measured(run_1d, treatment=two, treatment_for_gene=tfg)
    require(len(res["gene"]) == sum(len(v) for v in tfg.values()),
            f"eQTL: {len(res['gene'])} rows")
    on_tx = np.asarray(res["tx"]) == "tx"
    tx_rows = mtt.ColumnTable({c: np.asarray(res[c])[on_tx]
                               for c in res.columns})
    same_coefficients(tx_rows, base, ("de_coef",), "eQTL tx rows")
    info["se_log_ratio"] = se_log_ratio(tx_rows, base, "de_se")
    require(info["se_log_ratio"] < 0.05, f"eQTL SEs: {info}")
    info["power"] = float((np.asarray(tx_rows["de_pval"])[planted]
                           < 0.05).mean())
    require(info["power"] >= 0.8, f"eQTL power: {info}")
    info["rows"] = len(res["gene"])
    out["1d_eqtl"] = info

    # checkpointed in blocks of 256 genes; block 2 deleted and run again
    with tempfile.TemporaryDirectory() as ckpt:
        first, info = measured(run_1d, checkpoint_dir=ckpt,
                               checkpoint_block=256)
        blocks = sorted(os.listdir(ckpt))
        require(len(blocks) == -(-adata.n_vars // 256), f"blocks {blocks}")
        require(info["cascade_launches"] == len(blocks),
                f"one tile per block expected: {info}")
        os.remove(os.path.join(ckpt, "1d_ht_block00002.npz"))
        second, again = measured(run_1d, checkpoint_dir=ckpt,
                                 checkpoint_block=256)
    require(again["cascade_launches"] == 1,
            f"the resumed run launched {again['cascade_launches']} tiles")
    for col in first.columns:
        require(np.array_equal(np.asarray(first[col]),
                               np.asarray(second[col]),
                               equal_nan=first[col].dtype.kind == "f"),
                f"the resumed run differs in {col}")
    same_coefficients(second, base, ("de_coef", "dv_coef"), "checkpointed")
    out["1d_checkpoint"] = {"blocks": len(blocks), "first": info,
                            "resumed": again}

    # a custom estimator tuple through the whole pipeline
    custom = mtt.AnnData(X, obs=obs, var=mtt.ColumnTable(index=genes))
    t0 = time.perf_counter()
    mtt.setup_memento(custom, q_column="capture_q",
                      estimator_type=(hyper_1d, hyper_cov))
    mtt.create_groups(custom, label_columns=["condition", "replicate"])
    mtt.compute_1d_moments(custom)
    prep_s = time.perf_counter() - t0
    res, info = measured(run_1d, ad=custom)
    require(info["cascade_launches"] == 0, f"custom: {info}")
    require(info["custom_paths"] == {"device": len(groups), "host": 0},
            f"the custom estimator did not take the device path: {info}")
    same_coefficients(res, base, ("de_coef", "dv_coef"), "custom")
    info["se_log_ratio"] = se_log_ratio(res, base, "de_se")
    require(info["se_log_ratio"] < 0.10, f"custom SEs: {info}")
    info["prepare_s"] = round(prep_s, 3)
    out["1d_custom"] = info
    return out


def options_small_slice(mtt, small_ad, X, obs, genes, rows, cols):
    """Phase (h) on (c)'s small slice, card against CPU: 2D with the Poisson
    and Gaussian samplers, per-pair treatments and a custom tuple, and a
    numpy-only 1D estimator (the host path on both).  Returns the median SE
    ratio of each."""
    from memento_tpu_torch.ops import bootstrap

    results = {}
    for where in ("cuda", "cpu"):
        ad = small_ad[where]
        covariate, treatment = design(mtt, ad)
        kw = dict(covariate=covariate, num_boot=500, resampling="bootstrap",
                  approx=False, verbose=0, device=where)
        got = results[where] = {}
        for sampler in ("poisson", "gaussian"):
            mtt.ht_2d_moments(ad, treatment=treatment, sampler=sampler, **kw)
            got[f"2d_{sampler}"] = mtt.get_2d_ht_result(ad)
        groups = mtt.get_groups(ad)
        two = mtt.ColumnTable({"tx": groups["condition"].astype(np.float64),
                               "rep": groups["replicate"].astype(np.float64)},
                              index=groups.index)
        tfg = {pair: ["tx"] if k % 2 == 0 else ["tx", "rep"]
               for k, pair in enumerate(unique_pairs(ad))}
        mtt.ht_2d_moments(ad, treatment=two, treatment_for_gene=tfg, **kw)
        got["2d_eqtl"] = mtt.get_2d_ht_result(ad)

        custom = mtt.AnnData(X[rows][:, cols],
                             obs={k: v[rows] for k, v in obs.items()},
                             var=mtt.ColumnTable(index=genes[cols]))
        mtt.setup_memento(custom, q_column="capture_q",
                          estimator_type=(hyper_1d, hyper_cov))
        mtt.create_groups(custom, label_columns=["condition", "replicate"])
        mtt.compute_1d_moments(custom)
        mtt.compute_2d_moments(custom,
                               ad.uns["memento"]["2d_moments"]["gene_pairs"])
        bootstrap.reset_custom_paths()
        mtt.ht_2d_moments(custom, treatment=treatment, **kw)
        require(bootstrap.CUSTOM_PATHS == {"device": 4, "host": 0},
                f"2D custom on {where}: {bootstrap.CUSTOM_PATHS}")
        got["2d_custom"] = mtt.get_2d_ht_result(custom)
        custom.uns["memento"]["estimator_type"] = (numpy_hyper_1d, hyper_cov)
        bootstrap.reset_custom_paths()
        mtt.ht_1d_moments(custom, treatment=treatment, **kw)
        require(bootstrap.CUSTOM_PATHS == {"device": 0, "host": 4},
                f"numpy-only 1D on {where}: {bootstrap.CUSTOM_PATHS}")
        got["1d_numpy_only"] = mtt.get_1d_ht_result(custom)

    ratios = {}
    for name, card in results["cuda"].items():
        cpu = results["cpu"][name]
        cols_ = ("de_coef", "dv_coef") if name.startswith("1d") \
            else ("corr_coef",)
        same_coefficients(card, cpu, cols_, f"small slice {name}", rtol=1e-4,
                          atol=1e-5)
        se = "de_se" if name.startswith("1d") else "corr_se"
        ratios[name] = float(np.nanmedian(np.asarray(card[se], float)
                                          / np.asarray(cpu[se], float)))
        require(0.85 <= ratios[name] <= 1.15,
                f"small slice {name}: median SE ratio {ratios[name]}")
    return ratios


def planted_genes_of(result):
    """Which rows of a 1D result table test a gene with a planted effect."""
    return np.array([int(x[1:]) < N_PLANTED for x in result["gene"]])


def calibration(pvals, planted, label, check_null_median=True):
    """Power on the planted genes or pairs, the null median p-value and the
    null false-positive share at 0.05; raises below power 0.8, for a null
    median outside [0.3, 0.7] (unless not asked) or a share above 0.10."""
    pvals = np.asarray(pvals, dtype=np.float64)
    power = float((pvals[planted] < 0.05).mean())
    null_median = float(np.nanmedian(pvals[~planted]))
    null_fp = float((pvals[~planted] < 0.05).mean())
    if power < 0.8:
        raise AssertionError(f"{label}: power on planted items {power} < 0.8")
    if check_null_median and not 0.3 <= null_median <= 0.7:
        raise AssertionError(f"{label}: null median p {null_median} outside "
                             "[0.3, 0.7]")
    if null_fp > 0.10:
        raise AssertionError(f"{label}: null false-positive share {null_fp} "
                             "> 0.10")
    return power, null_median, null_fp


def draw_pairs(n_genes, n_pairs):
    """Random gene pairs without self-pairs, drawn as bench.py draws those
    of its 2D configuration."""
    rng = np.random.default_rng(7)
    idx1 = rng.integers(0, n_genes, n_pairs)
    idx2 = (idx1 + 1 + rng.integers(0, n_genes - 1, n_pairs)) % n_genes
    return idx1, idx2


def main_path_pairs(adata, genes, planted_genes):
    """(e)'s pairs over the genes that passed the filter: ``(idx1, idx2,
    planted)``; the first of them are the planted pairs (their genes all
    pass: base mean >= PLANT_MIN_MEAN)."""
    position = {name: i for i, name in enumerate(adata.var.index)}
    idx1, idx2 = draw_pairs(adata.n_vars, N_PAIRS)
    idx1[:N_PLANTED_PAIRS] = [position[g] for g in genes[planted_genes[:, 0]]]
    idx2[:N_PLANTED_PAIRS] = [position[g] for g in genes[planted_genes[:, 1]]]
    planted_sets = {frozenset(pair) for pair in
                    zip(idx1[:N_PLANTED_PAIRS], idx2[:N_PLANTED_PAIRS])}
    planted2 = np.array([frozenset(pair) in planted_sets
                         for pair in zip(idx1, idx2)])
    return idx1, idx2, planted2


def timed_calls():
    """``(timed, secs)``: ``timed(name, fn, ...)`` calls ``fn`` between two
    device synchronisations and files its seconds under ``name``."""
    import torch

    secs = {}

    def timed(name, fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        secs[name] = round(time.perf_counter() - t0, 3)
        return out

    return timed, secs


def design(mtt, adata):
    """Intercept covariate and condition treatment, one row per group."""
    groups = mtt.get_groups(adata)
    covariate = mtt.ColumnTable({"intercept": np.ones(len(groups))},
                                index=groups.index)
    treatment = mtt.ColumnTable(
        {"stim": groups["condition"].astype(np.float64)}, index=groups.index)
    return covariate, treatment


def run_api(mtt, adata, device, num_boot, tile_size=None):
    """The 1D main path through the public entry points; returns the result
    table and the seconds of each entry point."""
    timed, secs = timed_calls()
    timed("setup_memento", mtt.setup_memento, adata, q_column="capture_q")
    timed("create_groups", mtt.create_groups, adata,
          label_columns=["condition", "replicate"])
    timed("compute_1d_moments", mtt.compute_1d_moments, adata)
    covariate, treatment = design(mtt, adata)
    timed("ht_1d_moments", mtt.ht_1d_moments, adata, covariate=covariate,
          treatment=treatment, num_boot=num_boot, resampling="bootstrap",
          approx=False, tile_size=tile_size, verbose=0, device=device)
    result = timed("get_1d_ht_result", mtt.get_1d_ht_result, adata)
    return result, secs


def run_api_2d(mtt, adata, device, idx1, idx2, num_boot):
    """The 2D main path through the public entry points, on an ``adata``
    the 1D path has been through; returns the result table and the seconds
    of each entry point."""
    names = np.asarray(adata.var.index)
    timed, secs = timed_calls()
    timed("compute_2d_moments", mtt.compute_2d_moments, adata,
          list(zip(names[idx1], names[idx2])))
    covariate, treatment = design(mtt, adata)
    timed("ht_2d_moments", mtt.ht_2d_moments, adata, covariate=covariate,
          treatment=treatment, num_boot=num_boot, resampling="bootstrap",
          approx=False, verbose=0, device=device)
    result = timed("get_2d_ht_result", mtt.get_2d_ht_result, adata)
    return result, secs


def main_path_tile(adata, model, tile=None):
    """The kernel inputs of the main path's (single) tile, or with ``tile``
    of the first tile of that size (phase (i)'s tiling), rebuilt from the
    pipeline state exactly as run_ht_1d / ht_1d_tile build them: counts
    ``[R*T, U]``, weights ``[R*T, U, 2]``, n_obs ``[R*T]``."""
    from memento_tpu_torch.inference.ht import (_round_up, default_tile_size,
                                                tile_budget)
    from memento_tpu_torch.ops.compress import compress_group

    uns = adata.uns["memento"]
    groups = uns["groups"]
    g = adata.n_vars
    if tile is None:
        tile = min(default_tile_size(len(groups), NUM_BOOT,
                                     tile_budget("cuda")), _round_up(g, 64))
        if tile < g:
            raise AssertionError(
                f"main path ran {-(-g // tile)} tiles; expected 1")
    comps = [compress_group(uns["group_cells"][grp],
                            uns["approx_size_factor"][grp],
                            cols=(0, min(tile, g))) for grp in groups]
    u = _round_up(max(c.padded_u for c in comps), 64)

    def pad(x, rows, cols):
        out = np.zeros((rows, cols), np.float32)
        out[:x.shape[0], :x.shape[1]] = x
        return out

    counts = np.stack([pad(c.counts, tile, u) for c in comps])
    values = np.stack([pad(c.values, tile, u) for c in comps])
    inv_sf = np.stack([pad(c.inv_sf, tile, u) for c in comps])
    inv_sf[counts == 0] = 1.0
    q = np.array([uns["group_q"][grp] for grp in groups], np.float32)
    c = model.var_correction(q)[:, None, None]
    a = values * inv_sf
    d = (values * values - c * values) * inv_sf * inv_sf
    n_obs = np.repeat(np.array([x.n_obs for x in comps], np.float32), tile)
    r = len(groups)
    return (counts.reshape(r * tile, u),
            np.stack([a, d], -1).reshape(r * tile, u, 2).astype(np.float32),
            n_obs)


def main_path_tile_2d(adata, model, idx1, idx2, device, tile=None):
    """The kernel inputs of the 2D main path's (single) tile, or with
    ``tile`` of the first tile of that size (phase (i)'s tiling), rebuilt
    from the pipeline state as ht_2d_moments / run_ht_2d / ht_2d_tile build
    them (unordered duplicates tested once, joint compression per group,
    one padded U for the tile): counts ``[R*P, U]``, weights
    ``[R*P, U, 5]``, n_obs ``[R*P]``, as tensors on ``device``."""
    import torch

    from memento_tpu_torch.inference.ht import (MAX_PAIR_TILE, _round_up,
                                                default_tile_size, tile_budget)
    from memento_tpu_torch.ops.bootstrap import pair_weights
    from memento_tpu_torch.ops.compress import compress_pairs

    seen, keep = set(), []
    for i, pair in enumerate(zip(idx1.tolist(), idx2.tolist())):
        if pair[0] != pair[1] and frozenset(pair) not in seen:
            seen.add(frozenset(pair))
            keep.append(i)
    idx1, idx2 = idx1[keep], idx2[keep]
    uns = adata.uns["memento"]
    groups = uns["groups"]
    if tile is None:
        tile = min(default_tile_size(len(groups), NUM_BOOT,
                                     tile_budget(device)),
                   MAX_PAIR_TILE,
                   _round_up(len(idx1), 64))
        if tile < len(idx1):
            raise AssertionError(
                f"2D main path ran {-(-len(idx1) // tile)} tiles; expected 1")
    comps = [compress_pairs(uns["group_cells"][grp],
                            uns["approx_size_factor"][grp], idx1[:tile],
                            idx2[:tile]) for grp in groups]
    u = _round_up(max(c.padded_u for c in comps), 64)

    def stack(field, fill=0.0):
        out = np.full((len(comps), tile, u), fill, np.float32)
        for r, c in enumerate(comps):
            x = getattr(c, field)
            out[r, :x.shape[0], :x.shape[1]] = x
        return torch.as_tensor(out, device=device)

    counts = stack("counts")
    inv_sf = stack("inv_sf", 1.0)
    q = torch.tensor([uns["group_q"][grp] for grp in groups],
                     dtype=torch.float32, device=device)
    weights = pair_weights(stack("values_1"), stack("values_2"), inv_sf,
                           inv_sf * inv_sf,
                           model.var_correction(q)[:, None, None])
    n_obs = torch.tensor([c.n_obs for c in comps], dtype=torch.float32,
                         device=device).repeat_interleave(tile)
    return (counts.reshape(-1, u).contiguous(),
            weights.reshape(-1, u, 5).contiguous(), n_obs)


def same_seed_check(cuda_kernels, sampling, counts, weights, n_rows, seed,
                    label):
    """The kernel against the plain version on the kernel's own Philox
    stream, element by element: a sum may differ by float32 rounding and by
    a few Gaussian draws whose rounding to an integer flipped (1/N of a sum
    each, ~2e-5 here); a word used twice or skipped would move a sum by
    ~1/sqrt(N) = 4e-3 and fail the share."""
    import torch

    k = cuda_kernels.fused_bootstrap_sums_cuda(counts, weights, n_rows, 256,
                                               seed)
    p = sampling.fused_bootstrap_sums_philox(counts, weights, n_rows, 256,
                                             seed)
    torch.cuda.synchronize()
    rel = (k - p).abs() / p.abs().clamp_min(1e-6)
    median = float(rel.median())
    share = float((rel <= SAME_SEED_WITHIN).float().mean())
    if not (median <= SAME_SEED_MEDIAN and share >= SAME_SEED_SHARE):
        raise AssertionError(
            f"{label}: same-seed median rel. diff {median:.3g} (limit "
            f"{SAME_SEED_MEDIAN}), share within {SAME_SEED_WITHIN} "
            f"{share:.4f} (limit {SAME_SEED_SHARE})")
    return median, share, float(rel.max())


# phase (l): the share of replicates whose multinomial kernel sums may differ
# from its plain version's on one seed (any of the W sums by more than
# MN_FLIP_REL): a waiting-time or rejection decision flipped by the last bit
# of logf / log1pf on the card changes that replicate's draws from there on
# (tests/test_torch_multinomial.py::FLIP_SHARE).  A reused or skipped Philox
# word would move most replicates.
MN_FLIP_SHARE = 1e-3
MN_FLIP_REL = 1e-4


def multinomial_group_call(cuda_kernels, sampling, counts, weights, n_obs,
                           seed, label):
    """Phase (l) on one group call of the exact sampler, ``counts [T, U]``,
    ``weights [T, U, W]`` and ``n_obs [T]`` of one cell group as the tiles
    hand them to ``fused_multinomial_sums_cuda``: with one seed, draw by
    draw against the plain version on the kernel's Philox stream
    (``fused_multinomial_sums_philox``) on ~128 rows, B = 256; two launches
    bit for bit and B = 1000 the first 1000 replicates of B = 2000; in
    distribution against the ``torch.binomial`` chain
    (``check_distribution``, B = 2000); then the wrapper's, the launch's and
    the chain's times at B = NUM_BOOT beside the bound
    (``utils/roofline.py::multinomial_roofline``).  Returns the record of
    the kernels line."""
    import torch

    from memento_tpu_torch.utils.roofline import multinomial_roofline

    t_dim, u_dim = counts.shape
    w_dim = weights.shape[-1]
    occupied = (counts > 0).sum(1)
    fn = cuda_kernels.fused_multinomial_sums_cuda

    sub = slice(0, None, max(1, t_dim // 128))
    c_s, w_s, n_s = (x[sub].contiguous() for x in (counts, weights, n_obs))
    k = fn(c_s, w_s, n_s, 256, seed)
    p = sampling.fused_multinomial_sums_philox(c_s, w_s, n_s, 256, seed)
    rel = ((k - p).abs() / p.abs().clamp_min(1e-6)).amax(1)  # [rows, B]
    flip_share = float((rel > MN_FLIP_REL).float().mean())
    require(bool(torch.isfinite(k).all()) and flip_share <= MN_FLIP_SHARE,
            f"{label}: same seed, {flip_share:.3g} of the replicates off the "
            f"plain version (limit {MN_FLIP_SHARE})")

    w1 = weights.clone()
    w1[..., 0] = 1.0  # weight 1: the resample's total
    k = fn(counts, w1, n_obs, 2000, seed + 1)
    require(torch.equal(k, fn(counts, w1, n_obs, 2000, seed + 1)),
            f"{label}: two launches with one seed differ")
    require(torch.equal(k[..., :1000], fn(counts, w1, n_obs, 1000, seed + 1)),
            f"{label}: B=1000 is not the first 1000 replicates of B=2000")
    chain = sampling.fused_bootstrap_sums(counts, w1, n_obs, 2000, seed + 2,
                                          sampler="multinomial")
    torch.cuda.synchronize()
    # a row's total: the group's cells, or 0 for a padding row (no counts),
    # which both versions leave at 0
    cons_tol = conservation_limit(float(n_obs.max()), int(occupied.max()))
    err, worst_mean, worst_sd = check_distribution(
        k.cpu().numpy(), chain.cpu().numpy(), counts.sum(1).cpu().numpy(),
        cons_tol, label)
    del k, chain, w1

    ms = time_ms(lambda: fn(counts, weights, n_obs, NUM_BOOT, 7), reps=10)
    inputs = cuda_kernels.cascade_inputs(counts)
    launch_ms = time_ms(lambda: cuda_kernels.launch_multinomial(
        weights, n_obs, inputs, NUM_BOOT, 7), reps=10)
    chain_ms = time_ms(lambda: sampling.fused_bootstrap_sums(
        counts, weights, n_obs, NUM_BOOT, 7, sampler="multinomial"), reps=2)
    roof = multinomial_roofline(counts.cpu().numpy(), NUM_BOOT, ms / 1e3,
                                w_dim)
    bound_ms = 1e3 * roof["bound_s"]
    require(ms >= bound_ms, f"{label}: {ms} ms is below the bound of "
            f"{bound_ms} ms")
    return {
        "shape": {"rows": t_dim, "bins": u_dim, "W": w_dim, "B": NUM_BOOT,
                  "max_occupied": int(occupied.max()),
                  "mean_occupied": float(occupied.float().mean())},
        "ms": ms,
        "launch_ms": launch_ms,
        "plain_ms": chain_ms,
        "bound_ms": bound_ms,
        "bound_by": BOUND_BY[roof["limiting_resource"]],
        "roofline_share": bound_ms / ms,
        "draws_per_s": roof["draws_per_s"],
        "philox_calls_per_replicate": roof["philox_calls_per_replicate"],
        "max_abs_err": err,
        "distribution": {"mean_dev_sd": worst_mean, "sd_ratio_dev": worst_sd},
        "same_seed": {"rows": int(c_s.shape[0]), "B": 256,
                      "flip_share": flip_share},
    }


def time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


class FlaggedRows:
    """While open, keeps a copy of the rows each ``_DeferredGEV.submit``
    receives (the flagged rows of every tile), with their resampling."""

    def __init__(self, ht):
        self.ht = ht
        self.rows = []

    def __enter__(self):
        original = self.original = self.ht._DeferredGEV.submit
        kept = self.rows

        def submit(worker, rows_dev, gi, gk, out_pval, resampling):
            kept.append((rows_dev.clone(), resampling))
            return original(worker, rows_dev, gi, gk, out_pval, resampling)

        self.ht._DeferredGEV.submit = submit
        return self

    def __exit__(self, *exc):
        self.ht._DeferredGEV.submit = self.original
        return False


# phase (m): what the card's GEV refits must reach against numpy's on the
# same rows (tests/test_torch_gev_kernel.py's limits)
# same_stage_share; every row where the stages agree within GEV_P_RTOL_ALL
# (a Nelder-Mead step decided by two nearly equal likelihoods ends the fit
# elsewhere within its 1e-5 convergence test; the share of rows within
# GEV_P_RTOL is reported, not held: one such row among the main paths' ~100
# is a share of 1%)
GEV_SAME_STAGE_SHARE = 0.99
GEV_P_RTOL = 1e-6
GEV_P_RTOL_ALL = 1e-4
GEV_MAX_DECADES = 1.0


def gev_kernel_check(kept, label):
    """Phase (m) on the rows a main path handed to the refit: the kernel
    against the numpy path on the same rows, its relaunch, its time and
    the numpy path's, and its roofline.  Returns the kernels line's
    numbers."""
    import torch

    from memento_tpu_torch.inference import gev
    from memento_tpu_torch.ops import cuda_kernels
    from memento_tpu_torch.utils import profiling
    from memento_tpu_torch.utils.roofline import gev_refine_roofline

    if not kept:
        raise AssertionError(f"{label}: the main path refit no row")
    resampling = kept[0][1]
    rows = torch.cat([r for r, _ in kept])
    m, num_boot = rows.shape[0], rows.shape[1] - 1
    fallbacks = np.full(m, 1.0 / (num_boot + 1))
    out = gev.launch_refine(rows, resampling)
    again = gev.launch_refine(rows, resampling)
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int64), again.view(torch.int64)):
        raise AssertionError(f"{label}: two launches on one input differ")
    host = out.cpu().numpy()
    profiling.reset_timings()
    t0 = time.perf_counter()
    got, acc_k = gev.settle(host, rows, fallbacks, resampling,
                            counter="card")
    settle_ms = 1e3 * (time.perf_counter() - t0)
    stats, nulls = gev.split_rows(rows.cpu().numpy(), resampling)
    acc_n = np.zeros((m, 2), np.int64)
    t0 = time.perf_counter()
    want = gev.gev_refine_batch(stats, nulls, fallbacks, counter="numpy",
                                accepted=acc_n)
    numpy_ms = 1e3 * (time.perf_counter() - t0)
    fits = profiling.counters()
    same = acc_k == acc_n
    rows_same = same.all(1)
    rel = np.abs(got - want) / np.abs(want)
    decades = np.abs(np.log10(got) - np.log10(want))
    ms = time_ms(lambda: gev.launch_refine(rows, resampling), reps=5)
    tail_len = min(gev.TAIL_SCHEDULE[0], num_boot)
    roof = gev_refine_roofline(host[:, 4].sum(), m, tail_len, ms / 1e3)
    rec = {
        "shape": {"rows": m, "B": num_boot, "launches": len(kept),
                  "resampling": resampling},
        "status": np.bincount(host[:, 1].astype(int), minlength=3).tolist(),
        "same_stage_share": float(same.mean()),
        "p_rtol_share": float((rel[rows_same] <= GEV_P_RTOL).mean())
        if rows_same.any() else 1.0,
        "p_rtol_max": float(rel[rows_same].max()) if rows_same.any() else 0.0,
        "max_decades": float(decades.max()),
        "fits": {"card": fits.get("card", 0), "numpy": fits.get("numpy", 0)},
        "ms": ms,
        "settle_ms": settle_ms,
        "plain_ms": numpy_ms,
        "bound_ms": 1e3 * roof["bound_s"],
        "bound_by": roof["limiting_resource"],
        "roofline_share": roof["bound_s"] / roof["measured_s"],
        "values_fitted": roof["values_fitted"],
        "resources": cuda_kernels.gev_resources(),
    }
    if not (rec["same_stage_share"] >= GEV_SAME_STAGE_SHARE
            and rec["p_rtol_max"] <= GEV_P_RTOL_ALL
            and rec["max_decades"] <= GEV_MAX_DECADES
            and rec["fits"]["card"] == rec["fits"]["numpy"]):
        raise AssertionError(f"{label}: the kernel disagrees with the numpy "
                             f"path: {rec}")
    return rec


def conservation_limit(n_max: float, u_max: int) -> float:
    """How far a float32 weight-1 sum may lie from N: both versions add up
    to ``u_max`` draws into a running sum near N, each addition rounds by up
    to half an ulp of N, and the roundings add as a random walk: 1e-5 N up
    to some 800 bins, 3 eps sqrt(U) N beyond (the worst of millions of sums
    stays under half of that).  A lost draw would show as a cell or more."""
    eps = float(np.finfo(np.float32).eps)
    return n_max * max(1e-5, 3.0 * eps * np.sqrt(u_max))


def check_distribution(k, p, n_rows, cons_tol, label):
    """Weight-1 sums conserve N in both versions (to ``cons_tol``, see
    ``conservation_limit``); the other weights agree in distribution: per
    row, mean within 0.15 sd and sd within 15% of the plain version's."""
    err = float(np.abs(k[:, 0, :] - p[:, 0, :]).max())
    for name, x in (("kernel", k), ("plain", p)):
        dev = float(np.abs(x[:, 0, :] - n_rows[:, None]).max())
        if dev > cons_tol:
            raise AssertionError(f"{label}: {name} breaks conservation by {dev}")
    worst_mean = worst_sd = 0.0
    for wi in range(1, k.shape[1]):
        sd = p[:, wi].std(1)
        live = sd > 0
        mdev = np.abs(k[live, wi].mean(1) - p[live, wi].mean(1)) / sd[live]
        sdev = np.abs(k[live, wi].std(1) / sd[live] - 1.0)
        worst_mean = max(worst_mean, float(mdev.max()))
        worst_sd = max(worst_sd, float(sdev.max()))
    if worst_mean > 0.15 or worst_sd > 0.15:
        raise AssertionError(f"{label}: mean dev {worst_mean:.3f} sd, sd ratio "
                             f"dev {worst_sd:.3f} (limits 0.15, 0.15)")
    if not np.isfinite(k).all():
        raise AssertionError(f"{label}: non-finite kernel output")
    return err, worst_mean, worst_sd


NATIVE_1D = ("row_sums_csr", "suffstats_csr", "col_sums_csr",
             "suffstats_csc", "compress_group_range")
NATIVE_2D = ("pair_prods_csc", "compress_pairs")


def check_native_calls(native, names, label):
    calls = dict(native.CALLS)
    missing = [n for n in names if calls[n] <= 0]
    if missing:
        raise AssertionError(f"{label} took no native pass for {missing}: "
                             f"{calls}")
    return {n: c for n, c in calls.items() if c}


def canonical_rows(c):
    """A group tile's fields with each row's combos sorted by (value, bin),
    padding last: the native packer keeps nonzero combos in first-seen
    order, the numpy packer in code order."""
    key = c.values.astype(np.float64) * 256.0 + c.sf_bin
    key[np.arange(c.padded_u)[None, :] >= c.n_unique[:, None]] = np.inf
    order = np.argsort(key, axis=1, kind="stable")
    return {f: np.take_along_axis(getattr(c, f), order, axis=1)
            for f in ("values", "counts", "inv_sf", "sf_bin")}


def host_clock(fn, *a, **kw):
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    return out, time.perf_counter() - t0


def native_against_plain(adata, idx1, idx2):
    """Phase (g): each native entry of the main paths against its plain
    version on the main paths' own inputs, with the seconds of both."""
    from memento_tpu_torch import api
    from memento_tpu_torch.ops import corr, estimators, size_factor
    from memento_tpu_torch.ops.compress import compress_group, compress_pairs

    uns = adata.uns["memento"]
    secs = {}

    def both(name, native_fn, plain_fn):
        a, ta = host_clock(native_fn)
        b, tb = host_clock(plain_fn)
        secs[name] = {"native_s": round(ta, 4), "plain_s": round(tb, 4)}
        return a, b

    for r, grp in enumerate(uns["groups"]):
        cells, asf = uns["group_cells"][grp], uns["approx_size_factor"][grp]
        fresh = cells.copy()  # no cached prep: as the main path's first call
        got, want = both(f"compress_group[{r}]",
                         lambda: compress_group(fresh, asf, backend="native"),
                         lambda: compress_group(cells, asf, backend="numpy"))
        if not np.array_equal(got.n_unique, want.n_unique) \
                or got.padded_u != want.padded_u:
            raise AssertionError(f"group {grp}: n_unique or U differ")
        g_rows, w_rows = canonical_rows(got), canonical_rows(want)
        for f in g_rows:
            if not np.array_equal(g_rows[f], w_rows[f]):
                raise AssertionError(f"group {grp}: combos differ in {f}")
        got, want = both(
            f"compress_pairs[{r}]",
            lambda: compress_pairs(fresh, asf, idx1, idx2, backend="native"),
            lambda: compress_pairs(cells, asf, idx1, idx2, backend="numpy"))
        for f in ("values_1", "values_2", "counts", "inv_sf", "inv_sf_sq",
                  "n_unique", "sf_bin", "bin_inv_sf"):
            if not np.array_equal(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"group {grp}: pair tiles differ in {f}")

    def close(name, pair):
        got, want = (x if isinstance(x, tuple) else (x,) for x in pair)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-12, err_msg=name)

    X = adata.X
    # the plain versions read float64: scipy sums float32 data in float32
    X64 = X.astype(np.float64).tocsc()
    sf = np.asarray(adata.obs["memento_size_factor"])
    grp = uns["groups"][0]
    cells, cells_sf = uns["group_cells"][grp], uns["size_factor"][grp]
    mask = np.isin(np.asarray(adata.var.index), uns["least_variable_genes"])
    close("suffstats csr", both(
        "suffstats_sparse[csr]", lambda: estimators.suffstats_sparse(X, sf),
        lambda: estimators.suffstats_scipy(X, sf)))
    close("suffstats csc", both(
        "suffstats_sparse[csc]",
        lambda: estimators.suffstats_sparse(cells, cells_sf),
        lambda: estimators.suffstats_scipy(cells, cells_sf)))
    close("size factor total", both(
        "estimate_size_factor[total]",
        lambda: size_factor.estimate_size_factor(X, total=True),
        lambda: size_factor.estimate_size_factor(X64, total=True)))
    close("size factor masked", both(
        "estimate_size_factor[mask]",
        lambda: size_factor.estimate_size_factor(X, mask=mask),
        lambda: size_factor.estimate_size_factor(X64, mask=mask)))
    # scipy's mean scales before it sums (1e-12 apart); the plain column
    # sums of integer counts over the cell count are exact
    close("obs mean", both(
        "_obs_mean", lambda: api._obs_mean(X),
        lambda: np.asarray(X64.sum(axis=0)).ravel() / X64.shape[0]))
    w2 = (1.0 / cells_sf) ** 2
    close("pair products", both(
        "cov_sparse_pairs.pair_prods",
        lambda: corr.pair_prods(cells, w2, idx1, idx2),
        lambda: corr.pair_prods_scipy(cells, w2, idx1, idx2)))
    return secs


# Phase (i): tile sizes that give the main paths 4 tiles each (about 940
# genes pass the filter; (e) tests 512 pairs)
TILE_1D_I = 240
TILE_2D_I = 128
N_WORKERS = 2  # processes sharing the card in (i4)
WORKER_TIMEOUT_S = 420
GROUP_TIMEOUT_S = 180  # process group start-up and each collective


def equal_tables(a, b, cols, label):
    for col in cols:
        require(np.array_equal(np.asarray(a[col]), np.asarray(b[col]),
                               equal_nan=True),
                f"{label}: {col} differs")


def mesh_runs(mtt, adata, dev):
    """(i1): the 1D and 2D tests at 4 tiles each without a mesh, on the
    visible cards (``make_mesh()``) and on ``cuda:0`` listed twice; each
    mesh run bit for bit equal to the run without one, 4 launches each.
    Returns ``(numbers, launches by path, the 1D run without a mesh)``."""
    from memento_tpu_torch.parallel.mesh import make_mesh
    from memento_tpu_torch.utils import profiling

    covariate, treatment = design(mtt, adata)
    ht = dict(covariate=covariate, treatment=treatment, num_boot=NUM_BOOT,
              resampling="bootstrap", approx=False, verbose=0)
    meshes = {"visible": make_mesh(), "cuda0_twice": make_mesh(
        ["cuda:0", "cuda:0"])}
    paths = (("1d", mtt.ht_1d_moments, mtt.get_1d_ht_result, TILE_1D_I,
              COLS_1D),
             ("2d", mtt.ht_2d_moments, mtt.get_2d_ht_result, TILE_2D_I,
              COLS_2D))
    out, launches, bases = {}, {}, {}
    for path, test, result, tile, cols in paths:
        def run(**kw):
            test(adata, tile_size=tile, **ht, **kw)
            return result(adata)

        # each run's throughput without its first tile's one-off, from its
        # own phases
        profiling.reset_timings()
        base, info = measured(run, device=dev)
        info["steady_state"] = profiling.steady_state(info["s"], f"ht{path}",
                                                      len(base))
        require(info["cascade_launches"] == 4,
                f"{path} at tile {tile}: {info}")
        out[f"{path}_no_mesh"] = info
        bases[path] = base
        for name, mesh in meshes.items():
            profiling.reset_timings()
            res, info = measured(run, mesh=mesh)
            info["steady_state"] = profiling.steady_state(
                info["s"], f"ht{path}", len(res))
            require(info["cascade_launches"] == 4,
                    f"{path} on mesh {name}: {info}")
            equal_tables(res, base, cols, f"{path} on mesh {name}")
            info["devices"] = [str(d) for d in mesh]
            out[f"{path}_mesh_{name}"] = info
            if name == "visible":
                launches[f"mesh_{path}"] = info["cascade_launches"]
    return out, launches, bases["1d"]


def streamed_moments(mtt, adata, X, obs, genes):
    """(i2): ``stream_mean_var`` over the whole matrix on the visible cards,
    both precisions, against the native host float64 pass; then
    ``setup_memento`` / ``compute_1d_moments`` given the mesh (they keep the
    native pass) against (c)'s state.  Returns the seconds and largest
    relative differences."""
    import torch

    from memento_tpu_torch.ops import estimators as est
    from memento_tpu_torch.parallel.mesh import make_mesh
    from memento_tpu_torch.parallel.streaming import stream_mean_var

    mesh = make_mesh()
    sf = np.asarray(adata.obs["memento_size_factor"])
    out = {}
    (m_ref, v_ref), out["host_native_s"] = host_clock(
        est.mean_var_sparse, X, sf, CAPTURE_Q)
    for precision, tol_m, tol_v in (("high", dict(rtol=1e-10),
                                     dict(rtol=1e-10)),
                                    ("fast", dict(rtol=3e-4),
                                     dict(rtol=3e-3, atol=1e-5))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, v = stream_mean_var(mesh, X, sf, CAPTURE_Q, est.HYPER_RELATIVE,
                               precision=precision)
        out[f"stream_{precision}_s"] = round(time.perf_counter() - t0, 3)
        np.testing.assert_allclose(m, m_ref, err_msg=f"{precision} mean",
                                   **tol_m)
        np.testing.assert_allclose(v, v_ref, err_msg=f"{precision} var",
                                   **tol_v)
        with np.errstate(invalid="ignore", divide="ignore"):
            out[f"stream_{precision}_max_rel"] = float(np.nanmax(
                np.abs(v - v_ref) / np.abs(v_ref)))

    ad = mtt.AnnData(X, obs=obs, var=mtt.ColumnTable(index=genes))
    timed, secs = timed_calls()
    timed("setup_memento", mtt.setup_memento, ad, q_column="capture_q",
          mesh=mesh)
    timed("create_groups", mtt.create_groups, ad,
          label_columns=["condition", "replicate"])
    timed("compute_1d_moments", mtt.compute_1d_moments, ad, mesh=mesh)
    out["api_mesh_s"] = secs
    want, got = adata.uns["memento"], ad.uns["memento"]
    for a, b in zip(got["all_1d_moments"], want["all_1d_moments"]):
        np.testing.assert_allclose(a, b, rtol=1e-10)
    np.testing.assert_allclose(ad.obs["memento_size_factor"], sf, rtol=1e-10)
    require(got["gene_list"] == want["gene_list"], "mesh gene lists differ")
    for g in want["groups"]:
        for a, b in zip(got["1d_moments"][g], want["1d_moments"][g]):
            np.testing.assert_allclose(a, b, rtol=1e-10, equal_nan=True)
    return out


def corr_on_mesh(mtt, adata, group, idx1, idx2, corr_mat):
    """(i3): ``get_corr_matrix(mesh=make_mesh())`` on (f)'s group against
    the host float64 pair path (limit 1e-3, as (f)) and (f)'s matrix."""
    import torch

    from memento_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mat = mtt.get_corr_matrix(adata, group, mesh=make_mesh())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    pair_corr = adata.uns["memento"]["2d_moments"][group]["corr"]
    at_pairs = mat[idx1, idx2]
    inside = np.isfinite(at_pairs) & (np.abs(pair_corr) < 1)
    err = float(np.abs(at_pairs[inside] - pair_corr[inside]).max())
    require(inside.sum() >= 0.9 * N_PAIRS and err <= 1e-3,
            f"mesh correlation matrix vs pair path: {err}")
    require(np.array_equal(np.isnan(mat), np.isnan(corr_mat)),
            "mesh correlation matrix NaN pattern differs from (f)")
    return {"s": round(secs, 3), "max_abs_vs_pairs": err,
            "max_abs_vs_f": float(np.nanmax(np.abs(mat - corr_mat)))}


def distributed_worker(rank: int, port: str, outdir: str, seed: int) -> int:
    """One process of (i4): joins the gloo group, rebuilds (c)'s dataset from
    the seed, runs the public API, then each test with
    ``distributed=True`` and without it in this process on the same state
    (bit for bit equal, its own 2 tiles a path).  Writes its numbers to
    ``outdir/rank{rank}.json``; rank 0 also its result arrays."""
    import torch

    import memento_tpu_torch as mtt
    from memento_tpu_torch.ops import cuda_kernels
    from memento_tpu_torch.parallel import distributed as dist
    from memento_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        raise RuntimeError(f"worker {rank}: no CUDA device")
    dist.initialize(f"localhost:{port}", N_WORKERS, rank,
                    timeout=GROUP_TIMEOUT_S)
    dev = dist.local_device()
    t0 = time.perf_counter()
    X, obs, planted_genes = simulate(
        np.random.default_rng(seed), N_CELLS, N_GENES,
        np.random.default_rng([seed, 2]))
    genes = np.array([f"G{i}" for i in range(N_GENES)])
    adata = mtt.AnnData(X, obs=obs, var=mtt.ColumnTable(index=genes))
    sim_s = time.perf_counter() - t0
    timed, prep = timed_calls()
    timed("setup_memento", mtt.setup_memento, adata, q_column="capture_q")
    timed("create_groups", mtt.create_groups, adata,
          label_columns=["condition", "replicate"])
    timed("compute_1d_moments", mtt.compute_1d_moments, adata)
    idx1, idx2, _ = main_path_pairs(adata, genes, planted_genes)
    names = np.asarray(adata.var.index)
    mtt.compute_2d_moments(adata, list(zip(names[idx1], names[idx2])))
    covariate, treatment = design(mtt, adata)
    ht = dict(covariate=covariate, treatment=treatment, num_boot=NUM_BOOT,
              resampling="bootstrap", approx=False, verbose=0)
    numbers = {"rank": rank, "device": str(dev), "simulate_s": round(sim_s, 3),
               "prepare_s": prep}
    arrays = {}
    torch.cuda.reset_peak_memory_stats(dev)
    for path, test, result, tile, label, cols in (
            ("1d", mtt.ht_1d_moments, mtt.get_1d_ht_result, TILE_1D_I,
             "ht1d", COLS_1D),
            ("2d", mtt.ht_2d_moments, mtt.get_2d_ht_result, TILE_2D_I,
             "ht2d", COLS_2D)):
        cuda_kernels.reset_launches()
        profiling.reset_timings()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        test(adata, distributed=True, tile_size=tile, **ht)
        torch.cuda.synchronize(dev)
        dist_s = time.perf_counter() - t0
        launches = cuda_kernels.LAUNCHES["cascade_bootstrap"]
        merge_s = profiling.timings()[f"{label}.merge"]["total_s"]
        merged = result(adata)
        t0 = time.perf_counter()
        test(adata, distributed=False, tile_size=tile, device=dev, **ht)
        torch.cuda.synchronize(dev)
        one_s = time.perf_counter() - t0
        single = result(adata)
        equal_tables(merged, single, cols, f"rank {rank} {path}")
        require(launches == 2, f"rank {rank} {path}: {launches} launches in "
                "the distributed call, expected its own 2 tiles")
        numbers[path] = {"distributed_s": round(dist_s, 3),
                         "single_s": round(one_s, 3),
                         "merge_allreduce_s": round(merge_s, 4),
                         "launches": launches}
        for col in cols:
            arrays[f"{path}_{col}"] = np.asarray(merged[col], np.float64)
        if path == "1d":
            arrays["1d_gene"] = np.asarray(merged["gene"]).astype(str)
    numbers["peak_gib"] = round(
        torch.cuda.max_memory_allocated(dev) / 2**30, 3)
    if rank == 0:
        np.savez(os.path.join(outdir, "rank0.npz"), **arrays)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(numbers, f)
    return 0


def distributed_runs(seed: int, result_1d_tile, planted2):
    """(i4): ``N_WORKERS`` worker processes of this script sharing the card
    over gloo on localhost; every worker must exit 0 in time.  Checks rank
    0's merged results (calibration) and gathers each rank's numbers."""
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = str(sk.getsockname()[1])
    env = dict(os.environ, OMP_NUM_THREADS=str(
        max(1, (os.cpu_count() or 2) // N_WORKERS)))
    with tempfile.TemporaryDirectory() as outdir:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--worker", str(rank), port, outdir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for rank in range(N_WORKERS)]
        outs = []
        try:
            for proc in procs:
                out, err = proc.communicate(timeout=WORKER_TIMEOUT_S)
                outs.append((proc.returncode, out, err))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        for rank, (rc, out, err) in enumerate(outs):
            require(rc == 0, f"worker {rank} exited {rc}\n{out[-2000:]}\n"
                    f"{err[-4000:]}")
        ranks = []
        for rank in range(N_WORKERS):
            with open(os.path.join(outdir, f"rank{rank}.json")) as f:
                ranks.append(json.load(f))
        with np.load(os.path.join(outdir, "rank0.npz")) as z:
            arrays = {k: z[k] for k in z.files}
    planted = np.array([int(g[1:]) < N_PLANTED for g in arrays["1d_gene"]])
    cal = {"1d": calibration(arrays["1d_de_pval"], planted, "distributed 1D"),
           "2d": calibration(arrays["2d_corr_pval"], planted2,
                             "distributed 2D")}
    same_as_parent = all(
        np.array_equal(arrays[f"1d_{col}"], np.asarray(result_1d_tile[col]),
                       equal_nan=True) for col in COLS_1D)
    return ranks, cal, same_as_parent


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_summary(path):
    """What a Chrome trace of ``torch.profiler`` says about the device.

    The window spans every complete event of the trace.  Device activity is
    its kernels, copies and memsets (``DEVICE_CATEGORIES``); the busy share
    is the union of their intervals over the window, ``None`` when the trace
    holds no device event (the profiler saw no device).  ``ops`` sums the
    device events by name, most time first.  ``gaps`` are the three longest
    intervals of the window with no device activity, each with the three
    host ranges (``user_annotation``: the ``phase`` names, on any thread)
    that overlap it most, as ``[name, overlap_ms]``.
    """
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in DEVICE_CATEGORIES)
    busy, gaps, cursor = 0.0, [], lo
    for start, end in device:
        if start > cursor:
            gaps.append((cursor, start))
        busy += max(0.0, end - max(start, cursor))
        cursor = max(cursor, end)
    if hi > cursor:
        gaps.append((cursor, hi))
    ops = {}
    for e in events:
        if e.get("cat") in DEVICE_CATEGORIES:
            count, us = ops.get(e["name"], (0, 0.0))
            ops[e["name"]] = (count + 1, us + e["dur"])
    ranges = [e for e in events if e.get("cat") == "user_annotation"]

    def overlapping(start, end):
        by_name = {}
        for e in ranges:
            overlap = min(end, e["ts"] + e["dur"]) - max(start, e["ts"])
            if overlap > 0:
                by_name[e["name"]] = by_name.get(e["name"], 0.0) + overlap
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
        return [[name, us / 1e3] for name, us in top]

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:3]
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_share": busy / (hi - lo) if device else None,
        "device_events": len(device),
        "ops": [{"name": name, "count": count, "ms": us / 1e3}
                for name, (count, us) in sorted(ops.items(),
                                                key=lambda kv: -kv[1][1])],
        "gaps": [{"at_ms": (start - lo) / 1e3, "ms": (end - start) / 1e3,
                  "phases": overlapping(start, end)}
                 for start, end in longest],
        "bytes": os.path.getsize(path),
    }


def traced_paths(mtt, adata, dev, base, base2, tile_1d, seed):
    """(j): one ``ht_1d_moments`` and one ``ht_2d_moments`` at (c)'s and
    (e)'s settings on their state, each under ``device_trace``; each result
    bit for bit (c)'s or (e)'s, one cascade launch a path (by the counter
    and, where the trace holds device events, by the trace).  Then one
    launch on the 1D tile closed by ``sync_pull``.  Returns each path's
    ``trace_summary`` and its traced call's seconds."""
    import torch

    from memento_tpu_torch.ops import cuda_kernels
    from memento_tpu_torch.utils.profiling import (TRACE_FILE, device_trace,
                                                   sync_pull)

    covariate, treatment = design(mtt, adata)
    ht = dict(covariate=covariate, treatment=treatment, num_boot=NUM_BOOT,
              resampling="bootstrap", approx=False, verbose=0, device=dev)
    out = {}
    for path, test, result, want, cols in (
            ("1d", mtt.ht_1d_moments, mtt.get_1d_ht_result, base, COLS_1D),
            ("2d", mtt.ht_2d_moments, mtt.get_2d_ht_result, base2, COLS_2D)):
        logdir = os.path.join(TRACE_DIR, path)
        cuda_kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with device_trace(logdir, dev):
            test(adata, **ht)
            torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        launches = cuda_kernels.LAUNCHES["cascade_bootstrap"]
        equal_tables(result(adata), want, cols, f"(j) {path} under the trace")
        require(launches == 1, f"(j) {path}: {launches} cascade launches")
        summary = trace_summary(os.path.join(logdir, TRACE_FILE))
        traced = sum(op["count"] for op in summary["ops"]
                     if CASCADE_KERNEL in op["name"])
        require(traced == 1 or summary["busy_share"] is None,
                f"(j) {path}: {traced} cascade kernels in the trace")
        out[path] = {"call_s": call_s, "trace_launches": traced, **summary}
    counts, weights, n_obs = tile_1d
    sums = cuda_kernels.fused_bootstrap_sums_cuda(counts, weights, n_obs,
                                                  NUM_BOOT, seed)
    pulled = sync_pull({"sums": [sums]})
    require(pulled == float(sums.nansum()),
            f"(j) sync_pull {pulled} against nansum {float(sums.nansum())}")
    out["sync_pull"] = pulled
    return out


# Phase (k): the scale drivers' north-star configurations
NS_CELLS = 200_000
NS_GENES = 20_000
NS_BOOT_1D = 10_000
NS_PAIRS = 10_000
NS_BOOT_2D = 1_000
EQTL_GENES = 10_240
EQTL_BOOT = 5_000
EQTL_KT = 8
EQTL_TILE = 1024
EQTL_MIN_TESTS = 45_000  # (k4)'s real (not padded) gene-SNP tests
CORR_ENTRIES = 2000  # (k3)'s entries held against the pair path


def null_gates(label, calib, finite_min=0.99):
    """A null design's p-values: finite share, median in [0.3, 0.7] and the
    share below 0.05 at most 0.10 (``_report.null_calibration``)."""
    require(calib["finite_pval_frac"] >= finite_min,
            f"{label}: finite p-value share {calib['finite_pval_frac']}")
    if "null_median_pval" in calib:
        require(0.3 <= calib["null_median_pval"] <= 0.7,
                f"{label}: null median p {calib['null_median_pval']}")
        require(calib["null_fp_share_005"] <= 0.10,
                f"{label}: null FP share {calib['null_fp_share_005']}")


def north_star_scale(mtt, dev, card, seed):
    """Phase (k): the drivers' north-star paths on one matrix drawn on the
    card.  Logs one line a sub-phase and returns ``(launches by path, the
    kernel inputs of (k1)'s and (k2)'s first tiles)``."""
    import torch

    from memento_tpu_torch.drivers import (_data, _report, eqtl_north_star,
                                           north_star, north_star_2d)
    from memento_tpu_torch.ops.corr import cov_sparse_pairs
    from memento_tpu_torch.ops.estimators import HYPER_RELATIVE
    from memento_tpu_torch.utils import profiling

    def resources():
        return _report.resources(dev, with_card=False)

    def phase_table():
        return {name: round(v["total_s"], 3)
                for name, v in profiling.timings().items()}

    def tiling(label):
        """(tiles, tile size) the last run used: its ``<label>.launch``
        spans (the warm-up launches outside them) and their rows ``T``."""
        sizes = [sp["attrs"]["T"] for sp in profiling.spans()
                 if sp["name"] == f"{label}.launch"]
        require(len(set(sizes)) == 1, f"{label}: tiles of {set(sizes)} rows")
        return len(sizes), sizes[0]

    t0 = time.perf_counter()
    X = _data.north_star_device(NS_CELLS, NS_GENES, seed=seed, device=dev)
    torch.cuda.empty_cache()
    log(f"(k) data: {NS_CELLS} cells x {NS_GENES} genes drawn on the card "
        f"(north_star_simulate's law, chunks of 10,000 cells) in "
        f"{time.perf_counter() - t0:.1f} s | nnz {X.nnz} (density "
        f"{X.nnz / NS_CELLS / NS_GENES:.4f}) | host RSS "
        f"{_report.host_rss_bytes() / 2**30:.2f} GiB | {card}")
    launches, tiles = {}, {}

    # (k1) the 1D test on every gene, B = 10,000
    phases = {}
    _report.reset(dev)
    adata = north_star.prepare(X, phases)
    del X
    result, steady = north_star.run_1d(adata, NS_BOOT_1D, None, dev, phases,
                                       verbose=0)
    info = resources()
    ht_phases = phase_table()
    rec = north_star.record({"genes": NS_GENES, "num_boot": NS_BOOT_1D,
                             "tile": None}, adata, result, steady, phases)
    n_tiles, tile_1d = tiling("ht1d")
    require(rec["config"]["genes_tested"] == NS_GENES,
            f"(k1) tested {rec['config']['genes_tested']} genes")
    null_gates("(k1) de_pval", rec)
    require(rec["dv_finite_pval_frac"] >= 0.99,
            f"(k1) dv finite share {rec['dv_finite_pval_frac']}")
    require(info["cascade_launches"] == n_tiles,
            f"(k1) {info['cascade_launches']} launches, {n_tiles} tiles")
    launches["k1"] = info["cascade_launches"]
    log(f"(k1) north_star: {NS_GENES} genes x {NS_CELLS} cells, B = "
        f"{NS_BOOT_1D}, {n_tiles} tiles of {tile_1d} | {json.dumps(rec)} | "
        f"ht1d phases {json.dumps(ht_phases)} | {json.dumps(info)} | {card}")
    tiles["1d_ns"] = tuple(torch.as_tensor(a, device=dev) for a in
                           main_path_tile(adata, HYPER_RELATIVE, tile_1d))

    # (k2) the 2D test on 10,000 pairs, B = 1,000, on (k1)'s state
    phases = {}
    _report.reset(dev)
    result2, steady2 = north_star_2d.run_2d(adata, NS_PAIRS, NS_BOOT_2D, None,
                                            dev, phases, verbose=0)
    info = resources()
    ht_phases = phase_table()
    rec = north_star_2d.record({"genes": NS_GENES, "pairs": NS_PAIRS,
                                "num_boot": NS_BOOT_2D, "tile": None},
                               adata, result2, steady2, phases)
    uns = adata.uns["memento"]["2d_moments"]
    idx1, idx2 = uns["gene_idx_1"], uns["gene_idx_2"]
    n_tested = len(result2)
    n_tiles, tile_2d = tiling("ht2d")
    require(n_tested >= 0.99 * NS_PAIRS, f"(k2) tested {n_tested} pairs")
    null_gates("(k2) corr_pval", rec)
    require(info["cascade_launches"] == n_tiles,
            f"(k2) {info['cascade_launches']} launches, {n_tiles} tiles")
    launches["k2"] = info["cascade_launches"]
    log(f"(k2) north_star_2d: {n_tested} pairs ({NS_PAIRS} drawn) among "
        f"the 4,000 most expressed genes, B = {NS_BOOT_2D}, {n_tiles} tiles "
        f"of {tile_2d} | {json.dumps(rec)} | ht2d phases "
        f"{json.dumps(ht_phases)} | {json.dumps(info)} | {card}")
    tiles["2d_ns"] = main_path_tile_2d(adata, HYPER_RELATIVE, idx1, idx2, dev,
                                       tile_2d)

    # (k3) get_corr_matrix of one group
    group = adata.uns["memento"]["groups"][0]
    cells = adata.uns["memento"]["group_cells"][group]
    var = adata.uns["memento"]["1d_moments"][group][1]
    _report.reset(dev)
    profiling.reset_timings()
    t0 = time.perf_counter()
    mat = mtt.get_corr_matrix(adata, group, device=dev)
    corr_s = time.perf_counter() - t0
    info = resources()
    corr_phases = phase_table()
    live = var > 0
    require(mat.shape == (NS_GENES, NS_GENES), f"(k3) shape {mat.shape}")
    uns = adata.uns["memento"]
    rng = np.random.default_rng(seed + 23)

    def pair_path(i1, i2):
        """Host float64 covariances of the pairs over their variances."""
        cov = cov_sparse_pairs(cells, uns["size_factor"][group],
                               uns["group_q"][group], i1, i2, HYPER_RELATIVE)
        return cov / np.sqrt(var[i1] * var[i2])

    # the rows and columns of genes with no variance are NaN; off them an
    # entry is NaN only where the correlation leaves [-1.05, 1.05] (the
    # reference's rule), which the pair path must confirm
    require(np.isnan(mat[~live]).all() and np.isnan(mat[:, ~live]).all(),
            "(k3) a gene with no variance has a finite entry")
    bad = ~np.isfinite(mat)
    bad[~live] = False
    bad[:, ~live] = False
    off = np.argwhere(bad)
    del bad
    if len(off):
        some = off[rng.choice(len(off), min(len(off), CORR_ENTRIES),
                              replace=False)]
        raw = np.abs(pair_path(some[:, 0], some[:, 1]))
        require((raw > 1.05 - 1e-3).all(), "(k3) NaN entries off the NaN "
                f"genes where the pair path gives |corr| {raw.min():.4g}")
    pick = rng.choice(np.nonzero(live)[0], (2 * CORR_ENTRIES, 2))
    i1, i2 = pick[pick[:, 0] != pick[:, 1]][:CORR_ENTRIES].T
    pair_corr = mtt.api._corr_from_cov_np(
        pair_path(i1, i2) * np.sqrt(var[i1] * var[i2]), var[i1], var[i2])
    inside = np.isfinite(mat[i1, i2])
    corr_err = float(np.abs(mat[i1, i2][inside] - pair_corr[inside]).max())
    require(corr_err <= 1e-3 and inside.mean() >= 0.99,
            f"(k3) max |diff| against the pair path {corr_err}, finite "
            f"share of the entries {inside.mean()}")
    finite_live = 1.0 - len(off) / float(live.sum()) ** 2
    log(f"(k3) get_corr_matrix: group {group} [{cells.shape[0]} cells x "
        f"{NS_GENES} genes] in {corr_s:.3f} s | phases "
        f"{json.dumps(corr_phases)} | finite share off the "
        f"{int((~live).sum())} genes with no variance: {finite_live} ("
        f"{len(off)} entries out of [-1.05, 1.05] by the pair path too) | "
        f"{len(i1)} random entries against the host float64 pair path: max "
        f"|diff| {corr_err:.3g} (limit 1e-3) "
        f"| mean |offdiag| {float(np.nanmean(np.abs(mat[i1, i2]))):.4g} | "
        f"{json.dumps(info)} | {card}")
    del mat

    # (k4) the eQTL shape on the first 10,240 genes
    Xe = adata.X[:, :EQTL_GENES].tocsr()
    del adata, cells
    t0 = time.perf_counter()
    state = eqtl_north_star.prepare(Xe)
    prep_s = time.perf_counter() - t0
    nt, treatment = _data.eqtl_design(EQTL_GENES, EQTL_KT)
    _report.reset(dev)
    res, wall = eqtl_north_star.run_eqtl(state, treatment, EQTL_BOOT,
                                         EQTL_TILE, dev, verbose=False)
    info = resources()
    ht_phases = phase_table()
    rec = eqtl_north_star.record(
        {"kt": EQTL_KT, "num_boot": EQTL_BOOT, "tile": EQTL_TILE},
        Xe.shape[0], nt, res, wall)
    n_tiles = -(-EQTL_GENES // EQTL_TILE)
    require(rec["config"]["tests"] >= EQTL_MIN_TESTS,
            f"(k4) {rec['config']['tests']} tests")
    null_gates("(k4) mean_pval", {"finite_pval_frac":
                                  rec["finite_pval_frac"]})
    require(info["cascade_launches"] == n_tiles,
            f"(k4) {info['cascade_launches']} launches, {n_tiles} tiles")
    launches["k4"] = info["cascade_launches"]
    log(f"(k4) eqtl_north_star: {EQTL_GENES} genes, {rec['config']['tests']} "
        f"gene-SNP tests (Kt <= {EQTL_KT}), B = {EQTL_BOOT}, {n_tiles} tiles "
        f"of {EQTL_TILE} | prepare {prep_s:.3f} s | {json.dumps(rec)} | "
        f"ht1d phases {json.dumps(ht_phases)} | {json.dumps(info)} | {card}")
    del state, res, Xe
    torch.cuda.empty_cache()
    return launches, tiles


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--worker", nargs=3, metavar=("RANK", "PORT", "DIR"),
                        help="run as one process of phase (i4)")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.worker:
        rank, port, outdir = args.worker
        return distributed_worker(int(rank), port, outdir, args.seed)
    import memento_tpu_torch as mtt
    from memento_tpu_torch import native
    from memento_tpu_torch.native import _build as native_build
    from memento_tpu_torch.inference import ht
    from memento_tpu_torch.ops import cuda_kernels, kernel_build, sampling
    from memento_tpu_torch.ops.estimators import HYPER_RELATIVE
    from memento_tpu_torch.utils import profiling
    from memento_tpu_torch.utils.roofline import roofline

    if any(m == "jax" or m.startswith(("jax.", "memento_tpu."))
           or m == "memento_tpu" for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")
    dev = torch.device("cuda")
    card = card_line()

    # ---- (a) the card and the build ---------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # g++ while nvcc runs
        host_lib = pool.submit(native_build.load)
        kernel_build.build()
        build_s = time.perf_counter() - t0
        host_lib.result()
    host_build = (f"native host library: {native_build.BUILD_LOG['compiler']}"
                  f" | build {native_build.BUILD_LOG['seconds']:.2f} s | "
                  f"{os.cpu_count()} CPUs, {native_build.omp_threads()} "
                  "OpenMP threads")
    ptxas = cuda_kernels.cascade_ptxas()
    instances = {}
    for w_dim in cuda_kernels.SUPPORTED_W:
        if w_dim not in ptxas:
            raise AssertionError(f"no ptxas report for the W={w_dim} instance")
        instances[w_dim] = {**ptxas[w_dim],
                            **cuda_kernels.cascade_resources(w_dim)}
        if ptxas[w_dim]["spill_store_bytes"] or \
                ptxas[w_dim]["spill_load_bytes"]:
            raise AssertionError(f"W={w_dim} instance spills: {ptxas[w_dim]}")
    gev_use = {**cuda_kernels.gev_ptxas(), **cuda_kernels.gev_resources()}
    if gev_use["spill_store_bytes"] or gev_use["spill_load_bytes"]:
        raise AssertionError(f"gev_refine spills: {gev_use}")
    log(f"(a) card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | build {build_s:.2f} s | ptxas and runtime, "
        f"per W instance: {json.dumps(instances)}; gev_refine "
        f"{json.dumps(gev_use)} | {host_build}")

    # ---- (c) the 1D main path ---------------------------------------------
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    X, obs, planted_genes = simulate(
        rng, N_CELLS, N_GENES, np.random.default_rng([args.seed, 2]))
    genes = np.array([f"G{i}" for i in range(N_GENES)])
    adata = mtt.AnnData(X, obs=obs, var=mtt.ColumnTable(index=genes))
    log(f"(c) data: {N_CELLS} cells x {N_GENES} genes, nnz {X.nnz}, "
        f"simulated in {time.perf_counter() - t0:.1f} s (seed {args.seed})")

    cuda_kernels.reset_launches()
    native.reset_calls()
    profiling.reset_timings()
    with FlaggedRows(ht) as flagged_1d:
        result, secs = run_api(mtt, adata, dev, NUM_BOOT)
    launches_1d = dict(cuda_kernels.LAUNCHES)
    calls_1d = check_native_calls(native, NATIVE_1D, "the 1D main path")
    phases = {name: round(v["total_s"], 3)
              for name, v in profiling.timings().items()}
    if launches_1d["cascade_bootstrap"] <= 0 or \
            launches_1d["gev_refine"] != len(flagged_1d.rows):
        raise AssertionError(f"main path launched no kernel, or not one GEV "
                             f"launch a refit: {launches_1d}")

    tested = result["gene"]
    if len(tested) < 0.8 * N_GENES or result.shape[1] != 8:
        raise AssertionError(f"unexpected result shape {result.shape}")
    if not np.isfinite(result["de_coef"]).mean() > 0.95:
        raise AssertionError("too many non-finite coefficients")
    planted = planted_genes_of(result)
    power, null_median, null_fp = calibration(result["de_pval"], planted,
                                              "1D")
    planted_coef = float(np.nanmean(result["de_coef"][planted]))
    log(f"(c) main path: {len(tested)} genes tested ({planted.sum()} planted) | "
        f"seconds {json.dumps(secs)} | ht1d phases {json.dumps(phases)} | "
        f"launches {json.dumps(launches_1d)} | native calls "
        f"{json.dumps(calls_1d)} | power {power:.3f} | planted mean coef "
        f"{planted_coef:.3f} "
        f"(log 1.6 = 0.470) | null median p {null_median:.3f} | "
        f"null FP@0.05 {null_fp:.3f}")
    log(f"(c) phases of the 1D main path:\n{profiling.report()}")

    # the same API on a small slice, on the card and on the CPU (plain path):
    # observed coefficients are deterministic and must agree
    rows = np.concatenate([np.arange(b, b + 2000)
                           for b in range(0, N_CELLS, N_CELLS // 4)])
    cols = np.r_[0:32, N_PLANTED:N_PLANTED + 96]
    small, small_ad = {}, {}
    for where in ("cuda", "cpu"):
        small_ad[where] = mtt.AnnData(
            X[rows][:, cols], obs={k: v[rows] for k, v in obs.items()},
            var=mtt.ColumnTable(index=genes[cols]))
        small[where], _ = run_api(mtt, small_ad[where], where, 500)
    sg, sc = small["cuda"], small["cpu"]
    if list(sg["gene"]) != list(sc["gene"]):
        raise AssertionError("small-slice gene lists differ")
    for col in ("de_coef", "dv_coef"):
        np.testing.assert_allclose(sg[col], sc[col], rtol=1e-4, atol=1e-5,
                                   equal_nan=True, err_msg=col)
    se_ratio = float(np.nanmedian(sg["de_se"] / sc["de_se"]))
    p_diff = float(np.nanmedian(np.abs(sg["de_pval"] - sc["de_pval"])))
    log(f"(c) small slice ({len(rows)} cells x {len(cols)} genes) card vs CPU "
        f"plain path: coefficients agree (rtol 1e-4) | median SE ratio "
        f"{se_ratio:.3f} | median |dp| {p_diff:.4f}")
    if not 0.85 <= se_ratio <= 1.15 or p_diff > 0.05:
        raise AssertionError("small-slice SE / p-value disagreement")

    # ---- (e) the 2D main path ----------------------------------------------
    idx1, idx2, planted2 = main_path_pairs(adata, genes, planted_genes)

    cuda_kernels.reset_launches()
    native.reset_calls()
    profiling.reset_timings()
    with FlaggedRows(ht) as flagged_2d:
        result2, secs2 = run_api_2d(mtt, adata, dev, idx1, idx2, NUM_BOOT)
    launches_2d = dict(cuda_kernels.LAUNCHES)
    if launches_2d["gev_refine"] != len(flagged_2d.rows):
        raise AssertionError(f"2D main path: not one GEV launch a refit: "
                             f"{launches_2d}")
    calls_2d = check_native_calls(native, NATIVE_2D, "the 2D main path")
    by_w = dict(cuda_kernels.LAUNCHES_BY_W)
    phases2 = {name: round(v["total_s"], 3)
               for name, v in profiling.timings().items()}
    if by_w[5] <= 0 or by_w[5] != launches_2d["cascade_bootstrap"]:
        raise AssertionError("the 2D main path must launch the kernel with "
                             f"W = 5 and no other W: {by_w}")
    if result2.shape != (N_PAIRS, 5):
        raise AssertionError(f"unexpected 2D result shape {result2.shape}")
    if not np.isfinite(result2["corr_coef"]).mean() > 0.95:
        raise AssertionError("too many non-finite correlation coefficients")
    power2, null_median2, null_fp2 = calibration(result2["corr_pval"],
                                                 planted2, "2D")
    planted_coef2 = float(np.nanmean(result2["corr_coef"][planted2]))
    busy2 = phases2["ht2d.dispatch"] / secs2["ht_2d_moments"]
    log(f"(e) 2D main path: {N_PAIRS} pairs tested ({planted2.sum()} planted) "
        f"over {adata.n_vars} genes | seconds {json.dumps(secs2)} | ht2d "
        f"phases {json.dumps(phases2)} | launches {json.dumps(launches_2d)} "
        f"by W {json.dumps(by_w)} | native calls {json.dumps(calls_2d)} | "
        f"device program share of ht_2d_moments "
        f"{busy2:.3f} | power {power2:.3f} | planted mean coef "
        f"{planted_coef2:.3f} | null median p {null_median2:.3f} | "
        f"null FP@0.05 {null_fp2:.3f}")
    log(f"(e) phases of the 2D main path:\n{profiling.report()}")

    # the same API on the small slice, on the card and on the CPU
    s_idx1, s_idx2 = draw_pairs(small_ad["cuda"].n_vars, 48)
    small2 = {where: run_api_2d(mtt, small_ad[where], where, s_idx1, s_idx2,
                                500)[0] for where in ("cuda", "cpu")}
    sg, sc = small2["cuda"], small2["cpu"]
    np.testing.assert_allclose(sg["corr_coef"], sc["corr_coef"], rtol=1e-4,
                               atol=1e-5, equal_nan=True, err_msg="corr_coef")
    se_ratio2 = float(np.nanmedian(sg["corr_se"] / sc["corr_se"]))
    p_diff2 = float(np.nanmedian(np.abs(sg["corr_pval"] - sc["corr_pval"])))
    log(f"(e) small slice ({len(rows)} cells, {len(s_idx1)} pairs over "
        f"{small_ad['cuda'].n_vars} genes) card vs CPU plain path: "
        f"corr_coef agree (rtol 1e-4) | median SE ratio {se_ratio2:.3f} | "
        f"median |dp| {p_diff2:.4f}")
    if not 0.85 <= se_ratio2 <= 1.15 or p_diff2 > 0.05:
        raise AssertionError("2D small-slice SE / p-value disagreement")

    # ---- (f) the correlation matrix ----------------------------------------
    uns = adata.uns["memento"]
    group = uns["groups"][0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    corr_mat = mtt.get_corr_matrix(adata, group, device=dev)
    torch.cuda.synchronize()
    corr_s = time.perf_counter() - t0
    pair_corr = uns["2d_moments"][group]["corr"]
    at_pairs = corr_mat[idx1, idx2]
    inside = np.isfinite(at_pairs) & (np.abs(pair_corr) < 1)
    corr_err = float(np.abs(at_pairs[inside] - pair_corr[inside]).max())
    small_mats = {where: mtt.get_corr_matrix(
        small_ad[where], small_ad[where].uns["memento"]["groups"][0],
        device=where) for where in ("cuda", "cpu")}
    if not np.array_equal(np.isnan(small_mats["cuda"]),
                          np.isnan(small_mats["cpu"])):
        raise AssertionError("corr matrix NaN pattern differs, card vs CPU")
    small_err = float(np.nanmax(np.abs(small_mats["cuda"]
                                       - small_mats["cpu"])))
    log(f"(f) get_corr_matrix: group {group} "
        f"[{uns['group_cells'][group].shape[0]} cells x {adata.n_vars} genes] "
        f"in {corr_s:.3f} s | {int(inside.sum())} of {N_PAIRS} pair entries "
        f"held against the host float64 pair path: max |diff| {corr_err:.3g} "
        f"(limit 1e-3) | small slice card vs CPU: NaN pattern equal, "
        f"max |diff| {small_err:.3g} (limit 1e-4)")
    if inside.sum() < 0.9 * N_PAIRS or corr_err > 1e-3 or small_err > 1e-4:
        raise AssertionError("correlation matrix disagreement")

    # ---- (g) the native host layer against its plain version ---------------
    host_secs = native_against_plain(adata, idx1, idx2)
    log(f"(g) native host layer vs numpy/scipy on the main paths' inputs "
        f"({os.cpu_count()} CPUs, {native_build.omp_threads()} OpenMP "
        f"threads): group packer equal as combos per gene, pair packer slot "
        f"for slot, sums within rtol 1e-12 | seconds "
        f"{json.dumps(host_secs)} | {card}")

    # ---- (h) the other options -------------------------------------------
    t0 = time.perf_counter()
    options = options_full_width(mtt, adata, dev, result, result2, planted2,
                                 X, obs, genes)
    small_ratios = options_small_slice(mtt, small_ad, X, obs, genes, rows,
                                       cols)
    log(f"(h) options at full width (seconds, peak device memory in GiB, "
        f"cascade launches, against (c)/(e)): {json.dumps(options)} | small "
        f"slice card vs CPU, coefficients agree (rtol 1e-4), median SE "
        f"ratio: {json.dumps(small_ratios)} | phase (h) "
        f"{time.perf_counter() - t0:.1f} s | {card}")

    # ---- (i) multi-GPU and multi-process ------------------------------------
    t_i = time.perf_counter()
    mesh_info, launches_i, base_1d_tile = mesh_runs(mtt, adata, dev)
    log(f"(i1) mesh: 1D at tile {TILE_1D_I}, 2D at tile {TILE_2D_I}, 4 tiles "
        f"each, without a mesh, on make_mesh() and on cuda:0 twice: bit for "
        f"bit equal, 4 launches each | {json.dumps(mesh_info)} | {card}")
    log("(i1) steady state without the first tile's one-off (oneoff_s, "
        "steady_s, steady_items_per_s) by run: " + json.dumps(
            {k: v["steady_state"] for k, v in mesh_info.items()}))
    stream_info = streamed_moments(mtt, adata, X, obs, genes)
    log(f"(i2) streamed moments on make_mesh() ({N_CELLS} x {N_GENES}): "
        f"'high' within rtol 1e-10 and 'fast' within the JAX tolerances of "
        f"the native float64 pass; setup_memento / compute_1d_moments with "
        f"the mesh equal (c)'s at rtol 1e-10 | {json.dumps(stream_info)} | "
        f"{card}")
    corr_info = corr_on_mesh(mtt, adata, group, idx1, idx2, corr_mat)
    log(f"(i3) get_corr_matrix(mesh=make_mesh()) on group {group}: "
        f"{json.dumps(corr_info)} (limit 1e-3 against the pair path) | (f) "
        f"took {corr_s:.3f} s | {card}")
    torch.cuda.empty_cache()
    ranks, cal, same_as_parent = distributed_runs(args.seed, base_1d_tile,
                                                  planted2)
    require(same_as_parent, "rank 0's merged 1D result differs from (i1)'s "
            "one-process run at the same tile size")
    for path in ("1d", "2d"):
        launches_i[f"dist_{path}"] = sum(r[path]["launches"] for r in ranks)
    log(f"(i4) distributed: {N_WORKERS} processes sharing the card over "
        f"gloo, distributed=True bit for bit equal to the one-process call in "
        f"each, 2 launches a path per rank | per rank {json.dumps(ranks)} | "
        f"(power, null median p, null FP@0.05) {json.dumps(cal)} | rank 0's "
        f"1D result bit for bit equal to (i1)'s run without a mesh | "
        f"phase (i) {time.perf_counter() - t_i:.1f} s | {card}")

    # ---- (k) the north-star scale --------------------------------------------
    t_k = time.perf_counter()
    launches_k, tiles_k = north_star_scale(mtt, dev, card, args.seed)
    log(f"(k) phase (k) {time.perf_counter() - t_k:.1f} s | launches "
        f"{json.dumps(launches_k)}")

    # ---- (b) kernel against its plain version on each main path's tile ----
    # each main path's tile, and the first tile of each path's tiling in (i)
    def tile_1d(tile=None):
        return tuple(torch.as_tensor(a, device=dev)
                     for a in main_path_tile(adata, HYPER_RELATIVE, tile))

    tiles = {
        "1d": tile_1d(),
        "2d": main_path_tile_2d(adata, HYPER_RELATIVE, idx1, idx2, dev),
        "1d_tile240": tile_1d(TILE_1D_I),
        "2d_tile128": main_path_tile_2d(adata, HYPER_RELATIVE, idx1, idx2, dev,
                                        TILE_2D_I),
        **tiles_k,
    }
    if int((tiles["1d"][0] > 0).sum(1).max()) <= 256:
        raise AssertionError("no 1D row with U > 256")
    max_err, shapes, same_seed = {}, {}, {}
    for key, tile_w, check_w, what in (
            ("1d", 2, (1, 2), "1D main path tile"),
            ("2d", 5, (5,), "2D main path tile"),
            ("1d_tile240", 2, (2,), f"first 1D tile of {TILE_1D_I} in (i)"),
            ("2d_tile128", 5, (5,), f"first 2D tile of {TILE_2D_I} in (i)"),
            ("1d_ns", 2, (2,), "first 1D tile of (k1), B = 10000 path"),
            ("2d_ns", 5, (5,), "first 2D tile of (k2)")):
        counts, weights, _ = tiles[key]
        t_dim, u_dim = counts.shape
        occupied = (counts > 0).sum(1)
        small_bins = float(((counts > 0) & (counts < 8)).sum()
                           / occupied.sum())
        shapes[key] = {"rows": t_dim, "bins": u_dim, "W": tile_w,
                       "B": NS_BOOT_1D if key == "1d_ns" else NUM_BOOT}
        # the plain version holds a [rows, bins, 32] float32 table; take
        # every k-th row if that would pass 8 GiB
        step = -(-(t_dim * u_dim * 32 * 4) // (8 << 30))
        counts_b = counts[::step].contiguous()
        n_rows = counts_b.sum(1)
        cons_tol = conservation_limit(float(n_rows.max()), int(occupied.max()))
        max_err[key], dist = 0.0, None
        # same-seed subsample: at most ~128 rows, the main path's own
        # weights; it must hold rows that end inside a group of four bins
        sub = slice(0, None, max(1, t_dim // 128))
        counts_s = counts[sub].contiguous()
        n_rows_s = counts_s.sum(1)
        ragged = int(((counts_s > 0).sum(1) % 4 != 0).sum())
        if ragged == 0:
            raise AssertionError(f"{what}: same-seed subsample has no row "
                                 "whose end is not a multiple of 4")
        same_seed[key] = {}
        for w_dim in check_w:
            w_b = weights[::step, :, :w_dim].clone()
            w_b[..., 0] = 1.0  # weight 1: the resample's total
            w_b = w_b.contiguous()
            k = cuda_kernels.fused_bootstrap_sums_cuda(
                counts_b, w_b, n_rows, 2000, args.seed + 11)
            pl = sampling.fused_bootstrap_sums(counts_b, w_b, n_rows, 2000,
                                               args.seed + 12)
            torch.cuda.synchronize()
            err, wm, ws = check_distribution(
                k.cpu().numpy(), pl.cpu().numpy(), n_rows.cpu().numpy(),
                cons_tol, f"{what}, W={w_dim}")
            max_err[key] = max(max_err[key], err)
            dist = (wm, ws)
            # one seed, one result: launched again, and asked for half
            again = cuda_kernels.fused_bootstrap_sums_cuda(
                counts_b, w_b, n_rows, 2000, args.seed + 11)
            half = cuda_kernels.fused_bootstrap_sums_cuda(
                counts_b, w_b, n_rows, 1000, args.seed + 11)
            if not torch.equal(k, again):
                raise AssertionError(f"{what}, W={w_dim}: two launches with "
                                     "one seed differ")
            if not torch.equal(half, k[..., :1000]):
                raise AssertionError(f"{what}, W={w_dim}: B=1000 is not the "
                                     "first 1000 replicates of B=2000")
            del k, pl, again, half
            same_seed[key][w_dim] = same_seed_check(
                cuda_kernels, sampling, counts_s,
                weights[sub, :, :w_dim].contiguous(), n_rows_s,
                args.seed + 13, f"{what}, W={w_dim}")
        log(f"(b) cascade_bootstrap vs plain on the {what} [{t_dim} rows x "
            f"{u_dim} bins, max occupied {int(occupied.max())}, mean occupied "
            f"{float(occupied.float().mean()):.0f}, "
            f"{small_bins:.3f} of occupied bins below 8; row step {step}], "
            f"W in {check_w}, B=2000: conservation max "
            f"|kernel - plain| {max_err[key]:.4g} (limit "
            f"{cons_tol:.3g}); W={check_w[-1]} mean dev "
            f"{dist[0]:.3f} sd, sd ratio dev {dist[1]:.3f} (limits 0.15) | "
            f"relaunch and B=1000-of-2000 bit-identical | same seed vs plain "
            f"on the kernel's Philox stream [{counts_s.shape[0]} rows, "
            f"{ragged} ending inside a group, B=256] (median rel. diff, share "
            f"within {SAME_SEED_WITHIN}, max) by W: "
            f"{json.dumps(same_seed[key])} (limits {SAME_SEED_MEDIAN}, "
            f"{SAME_SEED_SHARE})")

    # ---- (d) times at each main path's tile shape --------------------------
    timings, wrapper_parts = {}, {}
    for key, tile_w in (("1d", 2), ("2d", 5)):
        counts, weights, n_obs = tiles[key]
        counts_host = counts.cpu().numpy()
        for num_boot in (NUM_BOOT, 10_000):
            ms = time_ms(lambda: cuda_kernels.fused_bootstrap_sums_cuda(
                counts, weights, n_obs, num_boot, 7), reps=10)
            # the plain version is timed at B = 10000 only if three calls of
            # it stay within a minute, judged from its time at B = 1000
            plain_ms = None
            if num_boot == NUM_BOOT or \
                    3 * 10 * timings[tile_w, NUM_BOOT][1] < 60e3:
                plain_ms = time_ms(lambda: sampling.fused_bootstrap_sums(
                    counts, weights, n_obs, num_boot, 7), reps=2)
            roof = roofline(counts_host, num_boot, ms / 1e3, tile_w)
            bound_ms = 1e3 * roof["bound_s"]
            bound_by = BOUND_BY[roof["limiting_resource"]]
            first_ms = 1e3 * max(roof["t_memory_bound_s"],
                                 roof["t_compute_bound_first_design_s"])
            if ms < bound_ms:
                raise AssertionError(f"W={tile_w} B={num_boot}: {ms} ms is "
                                     f"below the bound of {bound_ms} ms")
            timings[tile_w, num_boot] = (ms, plain_ms, bound_ms, bound_by)
            # the wrapper's parts: its tensor operations, and the launch
            # alone with the rows longest first and in index order (each
            # launch variant twice, in turns)
            first = cuda_kernels.cascade_inputs(counts)
            index = cuda_kernels.cascade_inputs(counts, longest_first=False)
            parts = {"inputs_ms": time_ms(
                lambda: cuda_kernels.cascade_inputs(counts), reps=10)}
            for name, inputs in (("launch_ms", first),
                                 ("launch_index_order_ms", index)) * 2:
                t = time_ms(lambda: cuda_kernels.launch_cascade(
                    counts, weights, n_obs, inputs, num_boot, 7), reps=10)
                parts[name] = min(t, parts.get(name, t))
            parts["bound_first_design_ms"] = first_ms
            wrapper_parts[tile_w, num_boot] = parts
            plain_txt = "not timed (over a minute)" if plain_ms is None \
                else f"{plain_ms:.3f} ms"
            log(f"(d) cascade_bootstrap B={num_boot} [{counts.shape[0]} x "
                f"{counts.shape[1]}, W={tile_w}]: kernel {ms:.3f} ms "
                f"(tensor operations before the launch "
                f"{parts['inputs_ms']:.3f}, launch {parts['launch_ms']:.3f}, "
                f"launch in index order "
                f"{parts['launch_index_order_ms']:.3f}) | plain "
                f"{plain_txt} | bound {bound_ms:.4f} ms ({bound_by}; by the "
                f"first design's count {first_ms:.4f} ms) | roofline: "
                f"{roof['limiting_resource']} bound, {bound_ms / ms:.3f} of "
                f"the bound reached (fp32 {roof['fp32_utilization']:.3f}, "
                f"hbm {roof['hbm_utilization']:.4f}), "
                f"{roof['useful_draws_per_s']:.4g} useful draws/s, "
                f"{roof['philox_calls_per_replicate']} Philox calls a "
                f"replicate | {card}")

    # ---- (l) the exact sampler's kernel on one group call of each path ----
    n_groups = len(adata.uns["memento"]["groups"])
    multinomial = {}
    for key, what in (("1d", "1D"), ("2d", "2D")):
        counts, weights, n_obs = tiles[key]
        rows = counts.shape[0] // n_groups  # group 0's rows
        rec = multinomial_group_call(
            cuda_kernels, sampling, counts[:rows].contiguous(),
            weights[:rows].contiguous(), n_obs[:rows].contiguous(),
            args.seed + 19, f"(l) {what} group call")
        multinomial[key] = rec
        log(f"(l) multinomial_bootstrap on group 0 of the {what} main path's "
            f"tile [{rec['shape']['rows']} rows x {rec['shape']['bins']} "
            f"bins, max occupied {rec['shape']['max_occupied']}, mean "
            f"occupied {rec['shape']['mean_occupied']:.1f}], "
            f"W={rec['shape']['W']}: same seed vs the plain version on its "
            f"Philox stream [{rec['same_seed']['rows']} rows, B=256]: "
            f"{rec['same_seed']['flip_share']:.3g} of the replicates off "
            f"(limit {MN_FLIP_SHARE}) | relaunch and B=1000-of-2000 "
            f"bit-identical | against the torch.binomial chain, B=2000: "
            f"conservation max |kernel - chain| {rec['max_abs_err']:.4g}, "
            f"mean dev {rec['distribution']['mean_dev_sd']:.3f} sd, sd ratio "
            f"dev {rec['distribution']['sd_ratio_dev']:.3f} (limits 0.15) | "
            f"B={NUM_BOOT}: kernel {rec['ms']:.3f} ms (launch alone "
            f"{rec['launch_ms']:.3f}) | chain {rec['plain_ms']:.3f} ms | "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
            f"{rec['roofline_share']:.3f} of the bound reached, "
            f"{rec['draws_per_s']:.4g} draws/s, "
            f"{rec['philox_calls_per_replicate']:.1f} Philox calls a "
            f"replicate | {card}")

    # ---- (m) the GEV refit kernel on the main paths' flagged rows ---------
    gev_checks = {}
    for key, kept, what in (("1d", flagged_1d.rows, "1D"),
                            ("2d", flagged_2d.rows, "2D")):
        rec = gev_checks[key] = gev_kernel_check(kept, f"(m) {what}")
        log(f"(m) gev_refine on the {what} main path's flagged rows "
            f"[{rec['shape']['rows']} rows from {rec['shape']['launches']} "
            f"launches, B={rec['shape']['B']}, "
            f"{rec['shape']['resampling']}]: status (kept, refined, host) "
            f"{rec['status']} | against the numpy path on the same rows: "
            f"same accepted stage on {rec['same_stage_share']:.4f} of (row, "
            f"side) (limit {GEV_SAME_STAGE_SHARE}), where they agree "
            f"{rec['p_rtol_share']:.4f} of the rows within {GEV_P_RTOL} "
            f"and all within {rec['p_rtol_max']:.3g} (limit "
            f"{GEV_P_RTOL_ALL}), largest "
            f"{rec['max_decades']:.3g} decades, fits "
            f"{json.dumps(rec['fits'])} | relaunch bit-identical | kernel "
            f"{rec['ms']:.3f} ms (the launch with its sort; the settling "
            f"with the host's rows {rec['settle_ms']:.3f} ms) | numpy "
            f"{rec['plain_ms']:.1f} ms | bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), {rec['roofline_share']:.4f} of the bound "
            f"reached, {rec['values_fitted']:.4g} values fitted | "
            f"{json.dumps(rec['resources'])} | {card}")

    # ---- (j) the main paths under the device trace --------------------------
    t_j = time.perf_counter()
    traces = traced_paths(mtt, adata, dev, result, result2, tiles["1d"],
                          args.seed + 17)
    for path in ("1d", "2d"):
        t = traces[path]
        busy = ("not measured: the trace holds no device event (the "
                "profiler saw no kernel, copy or memset)"
                if t["busy_share"] is None else f"{t['busy_share']:.4f}")
        top = [[o["name"][:80], o["count"], round(o["ms"], 3)]
               for o in t["ops"][:5]]
        gaps = [[round(g["at_ms"], 3), round(g["ms"], 3),
                 [[name, round(ms, 3)] for name, ms in g["phases"]]]
                for g in t["gaps"]]
        log(f"(j) {path} main path under device_trace ({TRACE_DIR}/{path}): "
            f"bit for bit (c)/(e)'s result, {t['trace_launches']} cascade "
            f"launch in the trace | window {t['window_s']:.3f} s (call "
            f"{t['call_s']:.3f} s with the profiler's start and the trace's "
            f"export) | device busy share {busy} over "
            f"{t['device_events']} device events | top "
            f"device operations (name, count, ms) {json.dumps(top)} | "
            f"longest idle gaps (at ms, ms, phases overlapping most with "
            f"their ms) {json.dumps(gaps)} | trace {t['bytes']} bytes | "
            f"{card}")
    log(f"(j) sync_pull closed one launch on the 1D tile: "
        f"{traces['sync_pull']!r} = float(out.nansum()) | phase (j) "
        f"{time.perf_counter() - t_j:.1f} s")

    def numbers(key, tile_w, launches):
        ms, plain_ms, bound_ms, bound_by = timings[tile_w, NUM_BOOT]
        ms10, plain10, bound10, _ = timings[tile_w, 10_000]
        return {
            "launches": launches,
            "max_abs_err": max(err for k, err in max_err.items()
                               if shapes[k]["W"] == tile_w),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "shape": shapes[key],
            **wrapper_parts[tile_w, NUM_BOOT],
            "same_seed": same_seed[key],
            "B10000": {"ms": ms10, "plain_ms": plain10, "bound_ms": bound10,
                       **wrapper_parts[tile_w, 10_000]},
        }

    # one kernel, two uses: the top-level numbers are those of the 1D path's
    # tile (W = 2) with the launches of both main paths; "W5" holds the same
    # keys for the 2D path's tile; max_abs_err covers phase (i)'s tiles of
    # the same W too, whose checks "phase_i_tiles" holds
    kernel = {
        "name": "cascade_bootstrap",
        "route": "cuda",
        "source": "memento_tpu_torch/csrc/cascade_bootstrap.cu",
        "replaces": "memento_tpu/ops/pallas_kernels.py:53",
        **numbers("1d", 2, launches_1d["cascade_bootstrap"]
                  + launches_2d["cascade_bootstrap"]
                  + sum(launches_k.values())),
        "launches_by_path": {"1d": launches_1d["cascade_bootstrap"],
                             "2d": launches_2d["cascade_bootstrap"],
                             **launches_i, **launches_k},
        "W5": numbers("2d", 5, launches_2d["cascade_bootstrap"]
                      + launches_k["k2"]),
        "phase_i_tiles": {key: {"shape": shapes[key],
                                "max_abs_err": max_err[key],
                                "same_seed": same_seed[key]}
                          for key in ("1d_tile240", "2d_tile128")},
        "phase_k_tiles": {key: {"shape": shapes[key],
                                "max_abs_err": max_err[key],
                                "same_seed": same_seed[key]}
                          for key in ("1d_ns", "2d_ns")},
    }
    # the exact sampler's kernel: the 1D group call's numbers (W = 2) with
    # the launches of (h)'s exact runs; "W5" those of the 2D group call
    launches_mn = {path: options[f"{path}_multinomial"]["multinomial_launches"]
                   for path in ("1d", "2d")}
    kernel_mn = {
        "name": "multinomial_bootstrap",
        "route": "cuda",
        "source": "memento_tpu_torch/csrc/multinomial_bootstrap.cu",
        "replaces": "memento_tpu/ops/sampling.py:164",
        "launches": sum(launches_mn.values()),
        "launches_by_path": launches_mn,
        "library_ms": None,
        **multinomial["1d"],
        "W5": multinomial["2d"],
    }
    # the GEV refit kernel: the 1D path's flagged rows, "2d" the 2D path's
    kernel_gev = {
        "name": "gev_refine",
        "route": "cuda",
        "source": "memento_tpu_torch/csrc/gev_refine.cu",
        "replaces": "none: the JAX package refits in numpy "
                    "(memento_tpu/inference/gev.py::gev_refine_batch)",
        "launches": launches_1d["gev_refine"] + launches_2d["gev_refine"],
        "launches_by_path": {"1d": launches_1d["gev_refine"],
                             "2d": launches_2d["gev_refine"]},
        "library_ms": None,
        **gev_checks["1d"],
        "2d": gev_checks["2d"],
    }
    print(json.dumps({"kernels": [kernel, kernel_mn, kernel_gev]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
