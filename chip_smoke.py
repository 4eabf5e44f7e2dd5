#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``memento_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU (Hopper):

    python3 chip_smoke.py [--seed 0]

Phases, one line each:

  (a) the card and the kernel build (``nvcc``, from ``memento_tpu_torch/csrc``);
  (c) the main path through the public API at the published runtime scale:
      200,000 cells x 1,024 genes, 2 conditions x 2 replicates,
      ``hyper_relative``, bootstrap resampling with GEV tail refinement,
      B = 1000, a 1.6x mean effect planted on 64 genes; then the same API on
      a small slice on the card and on the CPU (plain path) for agreement;
  (b) each kernel against its plain PyTorch version on the main path's own
      tile, at W = 1 and W = 2, B = 2000;
  (d) each kernel's time and its plain version's at the main path's tile
      shape, B = 1000 and B = 10000, beside the bound.

Then one JSON line of kernels, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed phase raises: the script
exits non-zero and prints no result line.  It refuses to run without a CUDA
device and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

N_CELLS = 200_000
N_GENES = 1024
N_PLANTED = 64
EFFECT = 1.6
NUM_BOOT = 1000
CAPTURE_Q = 0.1  # the noise model's capture efficiency (obs column)
# generator scale: bench.py thins its NB means by 0.1, which leaves most
# genes under the 0.07 mean filter; at 1.0 about 92% of genes pass it
SIM_SCALE = 1.0

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, FP32 operations/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12

# Operations per draw of the cascade kernel, counted from
# csrc/cascade_bootstrap.cu (each arithmetic instruction one operation).
OPS_PHILOX = 10 * 10 + 8  # 10 rounds of 2 mul.hi, 2 mul.lo, 4 xor, 2 adds
OPS_GAUSS = 30  # 2 uniforms, log, sqrt, cos, CF term, round, clamp
OPS_TABLE_FIXED = 20  # uniform, exp, sqrt, trip count, shift, clamp
OPS_TABLE_STEP = 5  # compare-add, multiply, divide, add
OPS_PER_WEIGHT = 2  # multiply-add into each of the W sums


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def simulate(rng, n_cells, n_genes):
    """bench.py's NB-style generator (gamma-Poisson, log-uniform base means)
    with 2 conditions x 2 replicates in equal blocks and a planted mean
    effect on the first genes of condition 1."""
    import scipy.sparse as sparse

    base = np.exp(rng.uniform(np.log(0.05), np.log(3.0), n_genes))
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
                blocks.append(sparse.csr_matrix(
                    rng.poisson(lam * SIM_SCALE).astype(np.float32)))
            cond += [c] * per
            rep += [r] * per
    X = sparse.vstack(blocks).tocsr()
    obs = {
        "condition": np.array(cond).astype(str),
        "replicate": np.array(rep).astype(str),
        "capture_q": np.full(len(cond), CAPTURE_Q),
    }
    return X, obs


def run_api(mtt, adata, device, num_boot, tile_size=None):
    """The 1D main path through the public entry points; returns the result
    table and the seconds of each entry point."""
    import torch

    secs = {}

    def timed(name, fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        secs[name] = round(time.perf_counter() - t0, 3)
        return out

    timed("setup_memento", mtt.setup_memento, adata, q_column="capture_q")
    timed("create_groups", mtt.create_groups, adata,
          label_columns=["condition", "replicate"])
    timed("compute_1d_moments", mtt.compute_1d_moments, adata)
    groups = mtt.get_groups(adata)
    covariate = mtt.ColumnTable({"intercept": np.ones(len(groups))},
                                index=groups.index)
    treatment = mtt.ColumnTable(
        {"stim": groups["condition"].astype(np.float64)}, index=groups.index)
    timed("ht_1d_moments", mtt.ht_1d_moments, adata, covariate=covariate,
          treatment=treatment, num_boot=num_boot, resampling="bootstrap",
          approx=False, tile_size=tile_size, verbose=0, device=device)
    result = timed("get_1d_ht_result", mtt.get_1d_ht_result, adata)
    return result, secs


def main_path_tile(adata, model):
    """The kernel inputs of the main path's (single) tile, rebuilt from the
    pipeline state exactly as run_ht_1d / ht_1d_tile build them: counts
    ``[R*T, U]``, weights ``[R*T, U, 2]``, n_obs ``[R*T]``."""
    from memento_tpu_torch.inference.ht import _round_up, default_tile_size
    from memento_tpu_torch.ops.compress import compress_group

    uns = adata.uns["memento"]
    groups = uns["groups"]
    g = adata.n_vars
    tile = min(default_tile_size(len(groups), NUM_BOOT), _round_up(g, 64))
    if tile < g:
        raise AssertionError(f"main path ran {-(-g // tile)} tiles; expected 1")
    comps = [compress_group(uns["group_cells"][grp],
                            uns["approx_size_factor"][grp]) for grp in groups]
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


def cascade_work(counts: np.ndarray, w_dim: int, num_boot: int):
    """(bytes, operations) the cascade bootstrap needs on these inputs:
    each input read once, the output written once; operations per draw for
    the bins this data occupies (absorbing bins draw no random numbers)."""
    t_dim, u_dim = counts.shape
    nbytes = 4 * (counts.size * (1 + w_dim) + t_dim + t_dim * w_dim * num_boot)
    ctail = np.cumsum(counts[:, ::-1], axis=1)[:, ::-1]
    occupied = counts > 0
    absorbing = occupied & (counts >= ctail)
    drawn = occupied & ~absorbing
    gauss = drawn & (counts >= 8.0)
    table = drawn & (counts < 8.0)
    lam = np.where(table, counts, 0.0)
    n_iter = np.minimum(32, np.ceil(lam + 5.0 * np.sqrt(lam) + 4.0)) * table
    per_boot = (drawn.sum() * OPS_PHILOX + gauss.sum() * OPS_GAUSS
                + table.sum() * OPS_TABLE_FIXED + n_iter.sum() * OPS_TABLE_STEP
                + occupied.sum() * (OPS_PER_WEIGHT * w_dim + 1))
    return nbytes, float(per_boot) * num_boot


def bound(counts, w_dim, num_boot):
    nbytes, ops = cascade_work(counts, w_dim, num_boot)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


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


def check_distribution(k, p, n_rows, label):
    """Weight-1 sums conserve N exactly in both versions; the other weights
    agree in distribution: per row, mean within 0.15 sd and sd within 15%
    of the plain version's."""
    cons_tol = 1e-5 * n_rows.max()
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import memento_tpu_torch as mtt
    from memento_tpu_torch.ops import cuda_kernels, kernel_build, sampling
    from memento_tpu_torch.ops.estimators import HYPER_RELATIVE
    from memento_tpu_torch.utils import profiling

    if any(m == "jax" or m.startswith(("jax.", "memento_tpu."))
           or m == "memento_tpu" for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")
    dev = torch.device("cuda")
    card = card_line()

    # ---- (a) the card and the build ---------------------------------------
    t0 = time.perf_counter()
    kernel_build.build()
    build_s = time.perf_counter() - t0
    ptxas = kernel_build.BUILD_LOG.get("cascade_bootstrap", "")
    regs = re.findall(r"Used (\d+) registers", ptxas)
    spills = re.findall(r"(\d+) bytes spill stores", ptxas)
    ptxas = (f"registers per W instance {'/'.join(regs)}, "
             f"spill bytes {'/'.join(spills)}")
    log(f"(a) card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | build {build_s:.2f} s | ptxas: {ptxas}")

    # ---- (c) the main path ------------------------------------------------
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    X, obs = simulate(rng, N_CELLS, N_GENES)
    genes = np.array([f"G{i}" for i in range(N_GENES)])
    adata = mtt.AnnData(X, obs=obs, var=mtt.ColumnTable(index=genes))
    log(f"(c) data: {N_CELLS} cells x {N_GENES} genes, nnz {X.nnz}, "
        f"simulated in {time.perf_counter() - t0:.1f} s (seed {args.seed})")

    cuda_kernels.reset_launches()
    profiling.reset_timings()
    result, secs = run_api(mtt, adata, dev, NUM_BOOT)
    launches = dict(cuda_kernels.LAUNCHES)
    phases = {name: round(v["total_s"], 3)
              for name, v in profiling.timings().items()}
    if launches["cascade_bootstrap"] <= 0:
        raise AssertionError(f"main path launched no kernel: {launches}")

    tested = result["gene"]
    gene_idx = np.array([int(x[1:]) for x in tested])
    de_p = result["de_pval"]
    if len(tested) < 0.8 * N_GENES or result.shape[1] != 8:
        raise AssertionError(f"unexpected result shape {result.shape}")
    if not np.isfinite(result["de_coef"]).mean() > 0.95:
        raise AssertionError("too many non-finite coefficients")
    planted = gene_idx < N_PLANTED
    power = float((de_p[planted] < 0.05).mean())
    null_p = de_p[~planted]
    null_median = float(np.nanmedian(null_p))
    null_fp = float((null_p < 0.05).mean())
    planted_coef = float(np.nanmean(result["de_coef"][planted]))
    log(f"(c) main path: {len(tested)} genes tested ({planted.sum()} planted) | "
        f"seconds {json.dumps(secs)} | ht1d phases {json.dumps(phases)} | "
        f"launches {json.dumps(launches)} | "
        f"power {power:.3f} | planted mean coef {planted_coef:.3f} "
        f"(log 1.6 = 0.470) | null median p {null_median:.3f} | "
        f"null FP@0.05 {null_fp:.3f}")
    if power < 0.8:
        raise AssertionError(f"power on planted genes {power} < 0.8")
    if not 0.3 <= null_median <= 0.7:
        raise AssertionError(f"null median p {null_median} outside [0.3, 0.7]")
    if null_fp > 0.10:
        raise AssertionError(f"null false-positive share {null_fp} > 0.10")

    # the same API on a small slice, on the card and on the CPU (plain path):
    # observed coefficients are deterministic and must agree
    rows = np.concatenate([np.arange(b, b + 2000)
                           for b in range(0, N_CELLS, N_CELLS // 4)])
    cols = np.r_[0:32, N_PLANTED:N_PLANTED + 96]
    small = {}
    for where in ("cuda", "cpu"):
        sub = mtt.AnnData(X[rows][:, cols],
                          obs={k: v[rows] for k, v in obs.items()},
                          var=mtt.ColumnTable(index=genes[cols]))
        small[where], _ = run_api(mtt, sub, where, 500)
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

    # ---- (b) kernel against its plain version on the main path's tile -----
    counts_np, weights_np, n_obs_np = main_path_tile(adata, HYPER_RELATIVE)
    u_rows = (counts_np > 0).sum(1)
    counts = torch.as_tensor(counts_np, device=dev)
    n_rows = counts.sum(1)
    if int(u_rows.max()) <= 256:
        raise AssertionError(f"no row with U > 256 (max {u_rows.max()})")
    max_err = 0.0
    dist = {}
    for w_dim in (1, 2):
        weights = torch.as_tensor(weights_np, device=dev)[..., :w_dim].clone()
        weights[..., 0] = 1.0  # weight 1: the resample's total
        weights = weights.contiguous()
        k = cuda_kernels.fused_bootstrap_sums_cuda(
            counts, weights, n_rows, 2000, args.seed + 11)
        p = sampling.fused_bootstrap_sums(counts, weights, n_rows, 2000,
                                          args.seed + 12)
        torch.cuda.synchronize()
        err, wm, ws = check_distribution(k.cpu().numpy(), p.cpu().numpy(),
                                         n_rows.cpu().numpy(), f"W={w_dim}")
        max_err = max(max_err, err)
        dist[w_dim] = (wm, ws)
    log(f"(b) cascade_bootstrap vs plain on the main path tile "
        f"[{counts_np.shape[0]} rows x {counts_np.shape[1]} bins, max occupied "
        f"{int(u_rows.max())}], B=2000: conservation max |kernel - plain| "
        f"{max_err:.4g} (limit {1e-5 * float(n_rows.max()):.3g}); "
        f"W=2 mean dev {dist[2][0]:.3f} sd, sd ratio dev {dist[2][1]:.3f} "
        f"(limits 0.15)")

    # ---- (d) times at the main path's tile shape ---------------------------
    weights = torch.as_tensor(weights_np, device=dev)
    n_obs = torch.as_tensor(n_obs_np, device=dev)
    timings = {}
    for num_boot in (NUM_BOOT, 10_000):
        ms = time_ms(lambda: cuda_kernels.fused_bootstrap_sums_cuda(
            counts, weights, n_obs, num_boot, 7), reps=10)
        plain_ms = time_ms(lambda: sampling.fused_bootstrap_sums(
            counts, weights, n_obs, num_boot, 7), reps=2)
        bound_ms, bound_by = bound(counts_np, 2, num_boot)
        timings[num_boot] = (ms, plain_ms, bound_ms, bound_by)
        log(f"(d) cascade_bootstrap B={num_boot} [{counts_np.shape[0]} x "
            f"{counts_np.shape[1]}, W=2]: kernel {ms:.3f} ms | plain "
            f"{plain_ms:.3f} ms | bound {bound_ms:.4f} ms ({bound_by}) | "
            f"{card}")

    ms, plain_ms, bound_ms, bound_by = timings[NUM_BOOT]
    ms10, plain10, bound10, _ = timings[10_000]
    kernels = [{
        "name": "cascade_bootstrap",
        "route": "cuda",
        "source": "memento_tpu_torch/csrc/cascade_bootstrap.cu",
        "replaces": "memento_tpu/ops/pallas_kernels.py:53",
        "launches": launches["cascade_bootstrap"],
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "shape": {"rows": int(counts_np.shape[0]),
                  "bins": int(counts_np.shape[1]), "W": 2, "B": NUM_BOOT},
        "B10000": {"ms": ms10, "plain_ms": plain10, "bound_ms": bound10},
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
