"""The bootstrap kernels alone: the cascade at the JAX package's benchmark
tiles, the exact multinomial at the shapes of its group calls.

    python -m memento_tpu_torch.drivers.kernel_bench [--device cuda]

The counterpart of the JAX package's ``examples/kernel_bench.py``: its three
tiles (``_data.kernel_counts``, the same counts for the same seed): the
north-star tile T = 1,024 rows x U = 1,024 bins at B = 10,000 (dense), the
headline tile 1,024 x 600 at B = 1,000 (dense) and the north-star tile with
ragged rows.  Each runs at W = 2 and W = 5, the widths the 1D and 2D tests
launch (the JAX script's W = 3 is launched by no path), through
``ops/cuda_kernels.py::fused_bootstrap_sums_cuda``: its time (CUDA events,
the mean of ``KB_REPS`` launches after one more), its plain version's
(``ops/sampling.py::fused_bootstrap_sums``, once after one more) and its
bound from ``utils/roofline.py``.

The exact sampler (``"multinomial"``: ``csrc/multinomial_bootstrap.cu``
through ``fused_multinomial_sums_cuda``) at one group call of each test
(``MULTINOMIAL_CALLS``, rows from ``_data.multinomial_counts``), B =
KB_BOOT_HEAD: the wrapper's time, the launch's alone, and the
``torch.binomial`` chain's that it replaced
(``sampling.fused_bootstrap_sums``, once after one more; KB_PLAIN).

Prints one JSON line (``_report.py``); on the CPU the "kernel" is the plain
version, timed by the host clock.

Environment knobs: KB_ROWS (1,024), KB_BINS (1,024), KB_BINS_HEAD (600),
KB_BOOT (10,000), KB_BOOT_HEAD (1,000), KB_REPS (10), KB_PLAIN (1: time the
plain version and the chain; 0: skip them).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..ops import cuda_kernels, sampling
from ..utils.roofline import multinomial_roofline, roofline
from . import _report
from ._data import kernel_counts, multinomial_counts

N_TRIALS = 50_000  # each row's sum: above any dense row's 39 x U
WIDTHS = (2, 5)
# The exact sampler's group calls in the benchmark's cells, (test, rows,
# cells of the group, W): the atlas sweep's largest cell type (0.38 of
# 200,000 cells over 2 conditions x 4 donors: 9,500 cells a group) in a 1D
# tile of 2,752 genes (``ht.default_tile_size`` at 8 groups, B = 1,000), and
# a 2D query's largest (1,000 target pairs) in the PBMC design's largest
# type (0.38 of 20,000 cells over 2 x 8: 475 cells a group);
# ``benchmarks/configs``, ``benchmarks/traffic/*-exact.json``
MULTINOMIAL_CALLS = (("1d", 2752, 9500, 2), ("2d", 1000, 475, 5))


def knobs() -> dict:
    env = _report.env_int
    return {"rows": env("KB_ROWS", 1024), "bins": env("KB_BINS", 1024),
            "bins_head": env("KB_BINS_HEAD", 600),
            "num_boot": env("KB_BOOT", 10_000),
            "num_boot_head": env("KB_BOOT_HEAD", 1000),
            "reps": env("KB_REPS", 10), "plain": env("KB_PLAIN", 1) == 1,
            "multinomial_calls": MULTINOMIAL_CALLS}


def tiles(cfg: dict, seed: int = 0):
    """The three tiles of ``kernel_bench.py`` in its order: ``(T, U, B,
    ragged, counts, weights [T, U, 5])``.  The counts are the JAX script's
    (its W = 3 weights are drawn to keep its stream); the weights are
    uniform in [0, 1) from a second generator."""
    rng = np.random.default_rng(seed)
    wrng = np.random.default_rng([seed, 1])
    out = []
    for t_dim, u_dim, b, ragged in (
            (cfg["rows"], cfg["bins"], cfg["num_boot"], False),
            (cfg["rows"], cfg["bins_head"], cfg["num_boot_head"], False),
            (cfg["rows"], cfg["bins"], cfg["num_boot"], True)):
        counts = kernel_counts(rng, t_dim, u_dim, ragged, N_TRIALS)
        rng.random((t_dim, u_dim, 3))
        weights = wrng.random((t_dim, u_dim, max(WIDTHS))).astype(np.float32)
        out.append((t_dim, u_dim, b, ragged, counts, weights))
    return out


def time_ms(fn, reps: int, dev: torch.device) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls after one more:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) / reps * 1e3
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(stop) / reps


def run(cfg: dict, dev: torch.device) -> list:
    records = []
    for t_dim, u_dim, b, ragged, counts_np, weights_np in tiles(cfg):
        counts = torch.as_tensor(counts_np, device=dev)
        n_obs = torch.full((t_dim,), float(N_TRIALS), device=dev)
        for w_dim in WIDTHS:
            weights = torch.as_tensor(
                np.ascontiguousarray(weights_np[..., :w_dim]), device=dev)
            cuda_kernels.reset_launches()
            ms = time_ms(lambda: cuda_kernels.fused_bootstrap_sums_cuda(
                counts, weights, n_obs, b, 7), cfg["reps"], dev)
            launches = cuda_kernels.LAUNCHES["cascade_bootstrap"]
            plain_ms = time_ms(lambda: sampling.fused_bootstrap_sums(
                counts, weights, n_obs, b, 7), 1, dev) if cfg["plain"] \
                else None
            roof = roofline(counts_np, b, ms / 1e3, w_dim)
            rec = {"tile": [t_dim, u_dim, b],
                   "kind": "ragged" if ragged else "dense", "W": w_dim,
                   "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": roof["bound_s"] * 1e3,
                   "bound_by": {"fp32": "operations",
                                "hbm": "bytes"}[roof["limiting_resource"]],
                   "share_of_bound": roof["bound_s"] * 1e3 / ms,
                   "fp32_utilization": roof["fp32_utilization"],
                   "hbm_utilization": roof["hbm_utilization"],
                   "useful_draws_per_s": roof["useful_draws_per_s"],
                   "library_ms": None, "launches": launches}
            _report.log(f"T={t_dim} U={u_dim} B={b} "
                        f"{rec['kind']} W={w_dim}: {ms:.3f} ms, plain "
                        f"{plain_ms}, bound {rec['bound_ms']:.4f} ms "
                        f"({rec['bound_by']})")
            records.append(rec)
            del weights
    return records


def run_multinomial(cfg: dict, dev: torch.device, seed: int = 0) -> list:
    """The exact sampler's kernel at the group calls of
    ``cfg["multinomial_calls"]``, beside the chain it replaced."""
    rng = np.random.default_rng([seed, 2])
    wgen = torch.Generator().manual_seed(seed)
    b = cfg["num_boot_head"]
    records = []
    for label, rows, cells, w_dim in cfg["multinomial_calls"]:
        counts_np = multinomial_counts(rng, rows, cells, pair=label == "2d")
        counts = torch.as_tensor(counts_np, device=dev)
        n_obs = counts.sum(1)
        weights = torch.rand((*counts.shape, w_dim), generator=wgen).to(dev)
        inputs = cuda_kernels.cascade_inputs(counts)
        cuda_kernels.reset_launches()
        ms = time_ms(lambda: cuda_kernels.fused_multinomial_sums_cuda(
            counts, weights, n_obs, b, 7), cfg["reps"], dev)
        launches = cuda_kernels.LAUNCHES[cuda_kernels.MULTINOMIAL]
        launch_ms = time_ms(lambda: cuda_kernels.launch_multinomial(
            weights, n_obs, inputs, b, 7), cfg["reps"], dev) \
            if dev.type == "cuda" else None
        chain_ms = time_ms(lambda: sampling.fused_bootstrap_sums(
            counts, weights, n_obs, b, 7, sampler="multinomial"), 1, dev) \
            if cfg["plain"] else None
        roof = multinomial_roofline(counts_np, b, ms / 1e3, w_dim)
        rec = {"tile": [rows, counts.shape[1], b], "kind": label,
               "W": w_dim, "cells": cells,
               "mean_row_bins": float((counts_np > 0).sum(1).mean()),
               "ms": ms, "launch_ms": launch_ms, "chain_ms": chain_ms,
               "bound_ms": roof["bound_s"] * 1e3,
               "bound_by": {"fp32": "operations",
                            "hbm": "bytes"}[roof["limiting_resource"]],
               "share_of_bound": roof["bound_s"] * 1e3 / ms,
               "launches": launches}
        _report.log(f"multinomial {label}: T={rows} U={counts.shape[1]} "
                    f"B={b} W={w_dim}: {ms:.3f} ms (launch {launch_ms}), "
                    f"chain {chain_ms}")
        records.append(rec)
    return records


def main(argv=None) -> int:
    args = _report.parse_args(__doc__, argv)
    dev = _report.select_device(args.device)
    cfg = knobs()
    if dev.type == "cuda":
        from .. import build

        build.build([cuda_kernels.CASCADE, cuda_kernels.MULTINOMIAL])
    _report.reset(dev)
    records = run(cfg, dev)
    multinomial = run_multinomial(cfg, dev)
    _report.emit({"config": cfg, "tiles": records,
                  "multinomial": multinomial, "device": str(dev),
                  **_report.resources(dev)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
