"""Batched differential mean / variability tests (1D, per gene) and
differential correlation tests (2D, per gene pair).

Counterpart of ``memento_tpu/inference/ht.py``.  One device program per
test evaluates a padded tile of genes (``ht_1d_tile``) or gene pairs
(``ht_2d_tile``) across every replicate group at once:

  bootstrap sampling  ->  moment contraction  ->  residual-variance transform
  (1D) or covariance -> correlation (2D)  ->  invalid-value fill  ->
  weighted meta-regression  ->  ASL

and ``run_ht_1d`` / ``run_ht_2d`` tile the gene / pair axis on the host
through one shared loop: tile t+1 is compressed on a prefetch thread while
the device runs tile t, inputs ship in compact transport dtypes, the tiles in
flight are bounded, and the flagged p-value tails are refined (GEV) on a
worker thread.  Group dropping and NaN semantics are masks and zero weights,
as in the JAX package.

Two ways to spread the tiles, which combine: ``mesh`` (a tuple of devices,
``parallel/mesh.py``) sends whole tiles round-robin to its devices, each
launching the CUDA kernel on its own tiles; ``distributed=True`` in a
``torch.distributed`` group gives each process its round-robin share of the
tiles and merges the rows (``parallel/distributed.py``).  A tile's seed is
``fold_seed(seed, tile start)`` wherever it runs, so both equal the
one-device run bit for bit at the same ``tile_size``.  (Under a mesh the JAX
package took its XLA cascade, because a ``pallas_call`` needs an explicit
``shard_map``; a CUDA kernel needs nothing of the kind.)

Device math is float32, as on the JAX device path; host stages are float64.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device import fold_seed, generator, resolve_device, warming
from ..ops.bootstrap import (SAMPLERS, bootstrap_1d, bootstrap_1d_custom,
                             bootstrap_2d, bootstrap_2d_custom)
from ..ops.estimators import NoiseModel, corr_from_cov
from ..ops.mv_regression import residual_variance
from ..utils import profiling
from .asl import asl_counting
from .gev import DeferredGEV
from .regression import meta_regress


def fill_invalid(gen, vals, valid):
    """Replace invalid entries by uniform draws from the row's valid ones.

    Args:
      gen: ``torch.Generator`` on ``vals.device``.
      vals: ``[..., B]``; valid: ``[..., B]`` bool.

    Returns:
      (filled ``[..., B]``, all_invalid ``[...]`` bool).  A row with no
      valid entry is wholly invalid (its group is then dropped).
    """
    all_invalid = ~valid.any(-1)
    # stable sort of invalidity: the first V positions are the valid
    # indices in their original order
    order = torch.sort((~valid).to(torch.int8), dim=-1, stable=True).indices
    n_valid = torch.clamp_min(valid.sum(-1), 1)[..., None]
    u = torch.rand(vals.shape, generator=gen, device=vals.device)
    pick = torch.minimum((u * n_valid).long(), n_valid - 1)
    donors = torch.gather(vals, -1, torch.gather(order, -1, pick))
    return torch.where(valid, vals, donors), all_invalid


def _dynamic_one_sample(treatment, good_t, treat_padded: bool):
    """Per-gene one-sample flags from the post-drop treatment matrices.

    Args:
      treatment: ``[T, R, Kt]``; good_t: ``[T, R]`` bool.
      treat_padded: per-gene treatments whose all-zero columns are padding.

    Returns:
      ``[T]`` bool.
    """
    ones = treatment == 1.0
    live = good_t[:, :, None]
    if treat_padded:
        col_used = (treatment != 0.0).any(1)[:, None, :]  # [T, 1, Kt]
        return ((ones | ~live | ~col_used).flatten(1).all(1)
                & col_used.flatten(1).any(1))
    return (ones | ~live).flatten(1).all(1)


def _nanstd(x):
    m = torch.nanmean(x, dim=-1, keepdim=True)
    return torch.sqrt(torch.nanmean((x - m) ** 2, dim=-1))


# Samplers drawn per (group, replicate chunk) with their own seeds; the
# cascade samplers draw every group of the tile in one call.
_CHUNKED = ("multinomial", "poisson", "gaussian")


def _chunked(b: int, boot_chunk: int, r: int, draw):
    """``draw(group, n, seed_coords)`` for each chunk of ``n`` replicates
    and each of ``r`` groups: the chunks' ``[..., n]`` results per output,
    stacked over groups, concatenated over chunks and trimmed to ``b``."""
    n_chunks = max(1, -(-b // boot_chunk))
    bc = -(-b // n_chunks)  # chunk size; b padded to n_chunks * bc
    chunks = [[draw(ri, bc, (0, ri, ci)) for ri in range(r)]
              for ci in range(n_chunks)]
    n_out = len(chunks[0][0])
    return tuple(
        torch.cat([torch.stack([grp[k] for grp in chunk]) for chunk in chunks],
                  -1)[..., :b]
        for k in range(n_out))


def _decode_inv_sf(inv_sf, inv_sf_sq, sf_binned: bool, dev):
    """Float32 ``(inv_sf, inv_sf_sq)`` ``[R, T, U]`` on ``dev`` from either
    transport form: the two float arrays, or (``sf_binned``) uint8 bin ids
    in ``inv_sf`` and the ``[R, NB]`` reciprocal table in ``inv_sf_sq``."""
    if not sf_binned:
        return tuple(torch.as_tensor(x, device=dev).to(torch.float32)
                     for x in (inv_sf, inv_sf_sq))
    table = torch.as_tensor(inv_sf_sq, device=dev).to(torch.float32)
    ids = torch.as_tensor(inv_sf, device=dev).long()
    inv_sf = torch.gather(table, 1, ids.reshape(ids.shape[0], -1)
                          ).reshape(ids.shape)
    return inv_sf, inv_sf * inv_sf


def ht_1d_tile(
    seed: int,
    values,  # [R, T, U]
    counts,  # [R, T, U]
    inv_sf,  # [R, T, U] (uint8 bin ids when sf_binned)
    inv_sf_sq,  # [R, T, U] (the [R, NB] reciprocal table when sf_binned)
    n_unique,  # [R, T]
    true_mean,  # [R, T]
    true_res_var,  # [R, T]
    mv_coeffs,  # [R, 3]
    q,  # [R]
    n_obs,  # [R]
    covariate,  # [R, K]
    treatment,  # [T, R, Kt]
    *,
    num_boot: int,
    model: NoiseModel,
    sampler: str = "cascade",
    one_sample: bool = False,
    resampling: str = "bootstrap",
    approx: bool = False,
    resample_rep: bool = False,
    boot_chunk: int = 1024,
    custom_1d=None,
    sf_binned: bool = False,
    treat_padded: bool = False,
    device=None,
):
    """Differential mean/variability test for one tile of genes.

    Inputs are numpy arrays (any transport dtype) or tensors; they move to
    ``device`` (default ``cuda``) and are computed in float32.  ``seed`` is
    the tile's derived seed; the stages fold it further (0: bootstrap,
    (1, 0)/(1, 1): mean/variance fill, 2: replicate resampling).

    The cascade samplers resample every group of the tile in one call.  The
    ``multinomial``, ``poisson`` and ``gaussian`` samplers run per group and
    per chunk of at most ``boot_chunk`` replicates, seeded by (0, group,
    chunk); on the card each such ``multinomial`` call is one launch of the
    multinomial kernel.  A user estimator ``custom_1d`` runs per group on
    exact multinomial draws of the ``torch.binomial`` chain (or the named
    materialized sampler), seeded by (0, group): on the card the same law
    as the kernel's, not the same draws.

    Counters (``utils/profiling``): ``ht1d.tiles``, each call;
    ``ht1d.group_calls``, each (group, chunk) draw of the per-group
    samplers.  The two meta-regressions are the device span
    ``ht1d.regress``.

    Returns a dict of ``[T, Kt]`` tensors (observed coefficients, bootstrap
    SEs, first-stage p-values, GEV flags) and the full coefficient tensors
    ``[T, Kt, B+1]`` for the host tail refinement.
    """
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, device=dev).to(torch.float32)

    values = f32(values)
    counts = f32(counts)
    inv_sf, inv_sf_sq = _decode_inv_sf(inv_sf, inv_sf_sq, sf_binned, dev)
    n_unique = torch.as_tensor(n_unique, device=dev)
    true_mean = f32(true_mean)
    true_res_var = f32(true_res_var)
    mv_coeffs = f32(mv_coeffs)
    q = f32(q)
    n_obs = f32(n_obs)
    covariate = f32(covariate)
    treatment = f32(treatment)

    r = values.shape[0]
    profiling.count("ht1d.tiles")
    if custom_1d is not None:
        groups = [bootstrap_1d_custom(
            custom_1d, values[ri], counts[ri], inv_sf[ri], inv_sf_sq[ri],
            n_obs[ri], q[ri], num_boot, fold_seed(seed, 0, ri), sampler)
            for ri in range(r)]
        boot_mean_raw, boot_var_raw = (torch.stack(x) for x in zip(*groups))
    elif sampler in _CHUNKED:
        profiling.count("ht1d.group_calls",
                        r * max(1, -(-num_boot // boot_chunk)))
        boot_mean_raw, boot_var_raw = _chunked(
            num_boot, boot_chunk, r, lambda ri, bc, at: bootstrap_1d(
                values[ri], counts[ri], inv_sf[ri], inv_sf_sq[ri], n_obs[ri],
                q[ri], model, bc, fold_seed(seed, *at), sampler))
    else:
        boot_mean_raw, boot_var_raw = bootstrap_1d(
            values, counts, inv_sf, inv_sf_sq, n_obs[:, None], q[:, None],
            model, num_boot, fold_seed(seed, 0), sampler)  # [R, T, B]

    res_var = residual_variance(boot_mean_raw, boot_var_raw,
                                mv_coeffs[:, None, :])

    mean_valid = torch.isfinite(boot_mean_raw) & (boot_mean_raw > 0)
    var_valid = torch.isfinite(res_var) & (res_var > 0)
    filled_mean, mean_dead = fill_invalid(
        generator(fold_seed(seed, 1, 0), dev), boot_mean_raw, mean_valid)
    filled_var, var_dead = fill_invalid(
        generator(fold_seed(seed, 1, 1), dev), res_var, var_valid)

    moments_ok = (
        torch.isfinite(true_mean)
        & torch.isfinite(true_res_var)
        & (true_mean != 0)
        & (true_res_var > 0)
        & (n_unique > 1)
    )
    good = moments_ok & ~mean_dead & ~var_dead  # [R, T]

    # (B+1) statistic matrices, column 0 observed.  The JAX package floors
    # at 1e-300 before the log, which is 0 in float32; so does this.
    one = torch.ones_like(true_mean)
    log_tm = torch.log(torch.where(good, true_mean, one))
    log_tv = torch.log(torch.where(good, true_res_var, one))
    boot_mean = torch.cat(
        [log_tm[..., None], torch.log(torch.clamp_min(filled_mean, 0.0))], -1)
    boot_var = torch.cat(
        [log_tv[..., None], torch.log(torch.clamp_min(filled_var, 0.0))], -1)
    zero = torch.zeros((), device=dev)
    boot_mean = torch.where(good[..., None], boot_mean, zero)
    boot_var = torch.where(good[..., None], boot_var, zero)

    weights = torch.where(good, n_obs[:, None], zero).T  # [T, R]
    os_vec = None if one_sample else \
        _dynamic_one_sample(treatment, good.T, treat_padded)  # [T]

    def regress(stats):  # [R, T, B+1] -> [T, Kt, B+1]
        gen = generator(fold_seed(seed, 2), dev) if resample_rep else None
        return meta_regress(covariate, treatment, stats.transpose(0, 1),
                            weights, one_sample=one_sample,
                            resample_rep=resample_rep, gen=gen,
                            one_sample_g=os_vec)

    with profiling.device_phase("ht1d.regress", dev):
        mean_coef = regress(boot_mean)
        var_coef = regress(boot_var)

    def finish(coef):
        pval, needs = asl_counting(coef, resampling, approx)
        return _nanstd(coef[..., 1:]), pval, needs

    mean_se, mean_pval, mean_needs = finish(mean_coef)
    var_se, var_pval, var_needs = finish(var_coef)

    # genes with no valid group at all -> NaN
    any_good = good.any(0)[:, None]  # [T, 1]
    nan = torch.tensor(float("nan"), device=dev)

    def nanify(x):
        return torch.where(any_good, x, nan)

    return {
        "mean_coef": nanify(mean_coef[..., 0]),
        "mean_se": nanify(mean_se),
        "mean_pval": nanify(mean_pval),
        "mean_needs_gev": mean_needs & any_good,
        "var_coef": nanify(var_coef[..., 0]),
        "var_se": nanify(var_se),
        "var_pval": nanify(var_pval),
        "var_needs_gev": var_needs & any_good,
        "mean_coef_full": mean_coef,
        "var_coef_full": var_coef,
    }


# Folded into a 2D tile's seed before its stages, so that a pair tile and a
# gene tile given the same derived seed (same run seed, same tile start)
# still draw different streams.
_PATH_2D = 0x2D


def ht_2d_tile(
    seed: int,
    values_1,  # [R, P, U]
    values_2,  # [R, P, U]
    counts,  # [R, P, U]
    inv_sf,  # [R, P, U] (uint8 bin ids when sf_binned)
    inv_sf_sq,  # [R, P, U] (the [R, NB] reciprocal table when sf_binned)
    true_corr,  # [R, P]
    q,  # [R]
    n_obs,  # [R]
    covariate,  # [R, K]
    treatment,  # [P, R, Kt]
    *,
    num_boot: int,
    model: NoiseModel,
    sampler: str = "cascade",
    one_sample: bool = False,
    resampling: str = "bootstrap",
    approx: bool = False,
    resample_rep: bool = False,
    boot_chunk: int = 1024,
    custom_est=None,
    sf_binned: bool = False,
    treat_padded: bool = False,
    device=None,
):
    """Differential-correlation test for one tile of gene pairs.

    Inputs are numpy arrays (any transport dtype) or tensors; they move to
    ``device`` (default ``cuda``) and are computed in float32.  ``seed`` is
    the tile's derived seed; the tile folds the 2D path constant into it and
    then the stages (0: bootstrap, 1: fill, 2: replicate resampling).

    One joint resample per (group, pair) gives the replicate covariance and
    both variances (W = 5 sums).  Samplers, ``boot_chunk`` and the user
    estimators ``custom_est = (fn_1d, fn_cov)`` as in ``ht_1d_tile``.  A
    replicate with an invalid variance is the sentinel correlation 1.0 and
    stays in the null; only non-finite replicates are refilled.  A group
    whose observed correlation is not finite or has |corr| == 1 is dropped
    for that pair (zero weight).

    Returns a dict of ``[P, Kt]`` tensors (observed coefficient, bootstrap
    SE, first-stage p-value, GEV flags) and the full coefficient tensor
    ``[P, Kt, B+1]`` for the host tail refinement.
    """
    dev = resolve_device(device)
    seed = fold_seed(seed, _PATH_2D)

    def f32(x):
        return torch.as_tensor(x, device=dev).to(torch.float32)

    values_1 = f32(values_1)
    values_2 = f32(values_2)
    counts = f32(counts)
    inv_sf, inv_sf_sq = _decode_inv_sf(inv_sf, inv_sf_sq, sf_binned, dev)
    true_corr = f32(true_corr)
    q = f32(q)
    n_obs = f32(n_obs)
    covariate = f32(covariate)
    treatment = f32(treatment)

    r = values_1.shape[0]
    if custom_est is not None:
        groups = [bootstrap_2d_custom(
            *custom_est, values_1[ri], values_2[ri], counts[ri], inv_sf[ri],
            inv_sf_sq[ri], n_obs[ri], q[ri], num_boot, fold_seed(seed, 0, ri),
            sampler) for ri in range(r)]
        boot_corr_raw = corr_from_cov(*(torch.stack(x) for x in zip(*groups)))
    elif sampler in _CHUNKED:
        boot_corr_raw, = _chunked(
            num_boot, boot_chunk, r, lambda ri, bc, at: (corr_from_cov(
                *bootstrap_2d(values_1[ri], values_2[ri], counts[ri],
                              inv_sf[ri], inv_sf_sq[ri], n_obs[ri], q[ri],
                              model, bc, fold_seed(seed, *at), sampler)),))
    else:
        boot_corr_raw = corr_from_cov(*bootstrap_2d(
            values_1, values_2, counts, inv_sf, inv_sf_sq, n_obs[:, None],
            q[:, None], model, num_boot, fold_seed(seed, 0), sampler))

    filled_corr, corr_dead = fill_invalid(
        generator(fold_seed(seed, 1), dev), boot_corr_raw,
        torch.isfinite(boot_corr_raw))

    moments_ok = torch.isfinite(true_corr) & (true_corr.abs() != 1.0)
    good = moments_ok & ~corr_dead  # [R, P]

    zero = torch.zeros((), device=dev)
    boot_corr = torch.cat(
        [torch.where(good, true_corr, zero)[..., None], filled_corr], -1)
    boot_corr = torch.where(good[..., None], boot_corr, zero)

    weights = torch.where(good, n_obs[:, None], zero).T  # [P, R]
    os_vec = None if one_sample else \
        _dynamic_one_sample(treatment, good.T, treat_padded)  # [P]
    gen = generator(fold_seed(seed, 2), dev) if resample_rep else None
    corr_coef = meta_regress(covariate, treatment, boot_corr.transpose(0, 1),
                             weights, one_sample=one_sample,
                             resample_rep=resample_rep, gen=gen,
                             one_sample_g=os_vec)  # [P, Kt, B+1]

    corr_se = _nanstd(corr_coef[..., 1:])
    corr_pval, corr_needs = asl_counting(corr_coef, resampling, approx)

    # pairs with no valid group at all -> NaN
    any_good = good.any(0)[:, None]  # [P, 1]
    nan = torch.tensor(float("nan"), device=dev)
    return {
        "corr_coef": torch.where(any_good, corr_coef[..., 0], nan),
        "corr_se": torch.where(any_good, corr_se, nan),
        "corr_pval": torch.where(any_good, corr_pval, nan),
        "corr_needs_gev": corr_needs & any_good,
        "corr_coef_full": corr_coef,
    }


# ---------------------------------------------------------------------------
# Host orchestration: pad genes into tiles, run tiles, refine tails
# ---------------------------------------------------------------------------


def _pad_axis(arr, size, axis, fill=0.0):
    pad = size - arr.shape[axis]
    if pad <= 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill)


# Float32 elements a tile's buffers may take off a CUDA card: 2**28 (1 GiB),
# the JAX package's fixed budget.
CPU_TILE_BUDGET = 1 << 28
# Share of a CUDA card's total memory that one tile's buffers may take; the
# rest holds the tiles in flight, the transfers and the caller's tensors.
TILE_MEMORY_SHARE = 0.5


def tile_budget(device) -> int:
    """Float32 elements one tile's buffers may take on ``device``: on a CUDA
    card ``TILE_MEMORY_SHARE`` of its total memory, so that the tiling (and
    with it each tile's seed) depends on the card and not on what else
    holds memory at the call; elsewhere ``CPU_TILE_BUDGET``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return CPU_TILE_BUDGET
    total = torch.cuda.get_device_properties(dev).total_memory
    return int(TILE_MEMORY_SHARE * total) // 4


def default_tile_size(r: int, num_boot: int,
                      budget_elems: int = CPU_TILE_BUDGET) -> int:
    """Gene-tile size: peak memory is about a dozen ``[R, T, B]`` float
    buffers within ``budget_elems`` (``tile_budget`` of the device), in
    multiples of 64 from 64 to 8,192."""
    t = budget_elems // max(1, r * num_boot * 12)
    t = max(64, min(8192, t))
    return (t // 64) * 64


# Cap on the default pair-tile size.  Inherited from the JAX package, where
# it bounds the joint pair packer's host cost and the padded U that one
# outlier pair forces on a whole tile; not measured on a CUDA card.
MAX_PAIR_TILE = 2048


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _max_combo_count(compressed, approx_sf) -> float:
    """Upper bound on any combo multiplicity: the largest size-factor-bin
    population (a combo can never exceed its bin's occupancy; the zero-zero
    combo of a gene pair can reach it)."""
    if compressed is not None:
        return max((float(np.max(c.counts, initial=0.0)) for c in compressed),
                   default=0.0)
    mx = 0.0
    for asf in approx_sf:
        if len(asf):
            _, occ = np.unique(np.asarray(asf), return_counts=True)
            mx = max(mx, float(occ.max()))
    return mx


def _value_dtype(vmax: float):
    """Transport dtype for expression values, fixed once per run."""
    if vmax < 127:
        return np.int8
    if vmax < 32767:
        return np.int16
    return np.float32


def _count_dtype(cmax: float):
    """Transport dtype for multiplicities.  torch has few ops on uint16, so
    counts travel as int16 below 32767 and widen on the host above."""
    if cmax < 32767:
        return np.int16
    if cmax < 2**31 - 1:
        return np.int32
    return np.float32


def _global_value_max(compressed, groups,
                      fields: Sequence[str] = ("values",)) -> float:
    if compressed is not None:
        return max((float(np.max(getattr(c, f), initial=0.0))
                    for c in compressed for f in fields), default=0.0)
    return max((float(grp.max()) if grp.nnz else 0.0 for grp in groups),
               default=0.0)


def _one_sample_flags(treatment: np.ndarray, per_item: bool) -> bool:
    """Static all-items one-sample shortcut: a globally all-ones treatment
    stays all-ones after any group drop, so the tiles skip the regression.
    Otherwise the tiles decide per gene (or pair) after the drop."""
    if not per_item:
        return bool(np.all(treatment == 1))
    col_used = (treatment != 0).any(axis=1)  # [G, Kt]; False = padding
    vec = np.all((treatment == 1) | ~col_used[:, None, :], axis=(1, 2)) \
        & col_used.any(axis=1)
    return bool(vec.all())


# Bound on tiles launched but not yet harvested: each pending result pins
# its [T, Kt, B+1] float32 coefficient tensors on the device.
DEFAULT_MAX_PENDING = 3

# Rows of the warm-up tile (see ``_warm_up``).
WARM_ROWS = 8
# (thread, device, run options) already warmed in this process.
_WARMED = set()
_WARMED_LOCK = threading.Lock()


def _warm_up(label: str, key, n_items: int, pack: Callable, launch: Callable,
             dev: torch.device) -> None:
    """Run the tile program once on a tile of ``WARM_ROWS`` rows, on the
    calling thread, and throw its results away.

    The first tile program of a process pays for first use: the CUDA
    context, the kernel library's loading (and build), lazily loaded device
    modules and the cuBLAS / cuSOLVER handles of the meta-regression's
    solve, which PyTorch keeps per thread.  The thread that will dispatch
    the tiles pays it here, on a tile of the run's first rows packed with
    the run's own options, while the prefetch thread packs the first real
    tile.  It runs once per thread, device and ``key`` (the run's options).
    Its kernel launches count in ``cuda_kernels.WARM_LAUNCHES``
    (``device.warming()``); a failure raises, as the real dispatch would.
    """
    marker = (threading.get_ident(), str(dev), label, key)
    with _WARMED_LOCK:
        if marker in _WARMED:
            return
    try:
        with profiling.phase(f"{label}.warm"), warming(), _on(dev):
            host_args, static = pack(0, min(WARM_ROWS, n_items), WARM_ROWS)
            tile_args = tuple(torch.as_tensor(np.ascontiguousarray(a),
                                              device=dev) for a in host_args)
            launch(0, tile_args, static, dev)
            if dev.type == "cuda":  # first use is paid here, not in tile 0
                with profiling.wait():
                    torch.cuda.synchronize(dev)
    except Exception as exc:
        raise RuntimeError(f"{label}: the first-use warm-up on {dev} "
                           "failed") from exc
    with _WARMED_LOCK:
        _WARMED.add(marker)


def _resolve_sampler(sampler: str) -> str:
    """``'auto'`` -> ``'cascade_cuda'``, whose wrapper launches the CUDA
    kernel on a card and runs the plain cascade on the CPU; any other
    sampler the caller names is the one that runs."""
    if sampler == "auto":
        return "cascade_cuda"
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}; options: "
                         f"{('auto',) + SAMPLERS}")
    return sampler


def _check_distributed(distributed: bool) -> int:
    """The number of processes sharing the tiles: the process group's size
    under ``distributed=True``, else 1 (the one-process path)."""
    if not distributed:
        return 1
    from ..parallel.distributed import process_count

    return process_count()


def _tile_devices(mesh, device, nproc: int):
    """The devices the tiles go to, round-robin: the mesh's, or the one
    ``device`` (under a process group, ``None`` means this process's card,
    ``parallel.distributed.local_device``)."""
    if mesh is not None:
        from ..parallel.mesh import as_mesh

        return as_mesh(mesh)
    if device is None and nproc > 1:
        from ..parallel.distributed import local_device

        device = local_device()
    return (resolve_device(device),)


def _resolve_tile(r: int, num_boot: int, devices, nproc: int,
                  cap: int) -> int:
    """The default tile size, at most ``cap``, within the smallest budget of
    ``devices``; with ``nproc`` > 1 the smallest over the processes, so
    that every process cuts the same tiles."""
    tile = min(default_tile_size(r, num_boot,
                                 min(tile_budget(dev) for dev in devices)),
               cap)
    if nproc > 1:
        from ..parallel.distributed import min_over_processes

        tile = min_over_processes(tile)
    return tile


def _names(devices) -> str:
    return ", ".join(str(d) for d in devices)


def _merge_distributed(out: dict, starts, tile_size: int, n: int) -> dict:
    """All-reduce the disjoint per-process result rows into the global
    result (every process returns the same full arrays)."""
    from ..parallel.distributed import merge_disjoint_rows

    owned = np.zeros(n, bool)
    for s in starts:
        owned[s:min(s + tile_size, n)] = True
    return merge_disjoint_rows(out, owned)


def _on(dev: torch.device):
    """Make ``dev`` the current CUDA device (the kernel launches on the
    current device's stream); nothing for the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _sf_transport(comps, csl, u: int, t: int):
    """Size factors of one tile in transport form, ``(inv_sf, inv_sf_sq,
    binned)``: one uint8 bin id per slot plus an ``[R, NB]`` reciprocal
    table where every group has the compact form, else two float16 arrays
    (quantized size factors tolerate float16).  ``csl`` slices the item axis
    of pre-compressed groups."""
    binned = all(c.sf_bin is not None for c in comps)
    if binned:
        isf = np.stack([_pad_axis(c.sf_bin[csl], u, 1, 0) for c in comps]
                       ).astype(np.uint8)
        nb = max(len(c.bin_inv_sf) for c in comps)
        isf2 = np.stack([_pad_axis(c.bin_inv_sf, nb, 0, 1.0)
                         for c in comps]).astype(np.float32)
        return _pad_axis(isf, t, 1, 0), isf2, True
    isf = np.stack([_pad_axis(c.inv_sf[csl], u, 1, 1.0) for c in comps])
    isf2 = np.stack([_pad_axis(c.inv_sf_sq[csl], u, 1, 1.0) for c in comps])
    return (_pad_axis(isf, t, 1, 1.0).astype(np.float16),
            _pad_axis(isf2, t, 1, 1.0).astype(np.float16), False)


def _treatment_tile(treatment: np.ndarray, start: int, stop: int, t: int):
    """``[t, R, Kt]`` float32 treatment of one tile, zero-padded."""
    if treatment.ndim == 3:
        tile = treatment[start:stop]
    else:
        tile = np.broadcast_to(treatment, (stop - start, *treatment.shape))
    return np.asarray(_pad_axis(tile, t, 0), dtype=np.float32)


def _run_tiles(label: str, unit: str, stats: Sequence[str], n_items: int,
               tile_size: int, kt: int, pack: Callable, launch: Callable, *,
               devices, nproc: int, num_boot: int, resampling: str,
               approx: bool, max_pending: int, verbose: bool, note: str,
               warm_key):
    """The tile loop of both tests.

    ``pack(start, stop, rows)`` builds the host inputs of the items
    ``start:stop`` padded to ``rows`` (a tuple of numpy arrays and a dict of
    static options) on the prefetch thread, so tile t+1 is compressed while
    the device runs tile t.  ``launch(start, args, static, dev)`` runs the
    tile's device program on the arrays transferred to ``dev`` and returns
    its result dict.  While the first tile is packed, this thread warms each
    device with the same program on a small tile (``_warm_up``, once per
    ``warm_key``) and the GEV worker starts its imports (on a card, the
    kernel's library too).  The tiles go round-robin to ``devices``; with
    ``nproc`` > 1 this process runs only its share (``process_tile_starts``)
    and the rows merge across the processes at the end.  Results are harvested at most ``max_pending``
    tiles behind the launches; flagged p-value tails go to the GEV refit
    (``gev.DeferredGEV``: a kernel launch for rows on a CUDA card).
    No items run no tile.

    Spans (``utils/profiling``; none waits for the device): per tile
    ``<label>.pack.wait`` (this thread waiting for the packer's
    ``<label>.compress+pack``), ``<label>.transfer``, ``<label>.launch``
    (host, with attributes T, U, R, B and ``steps``, the binomial-chain
    steps) inside ``<label>.dispatch`` (the device's time), and per harvested
    statistic ``<label>.harvest``; ``.wait`` spans where the host blocks on
    the device.

    Returns ``{<stat>_coef, <stat>_se, <stat>_pval}`` ``[n_items, Kt]``
    float64 arrays for each name in ``stats``.
    """
    out = {f"{stat}_{k}": np.full((n_items, kt), np.nan)
           for stat in stats for k in ("coef", "se", "pval")}
    starts = list(range(0, n_items, tile_size)) if n_items else []
    if nproc > 1:
        from ..parallel.distributed import process_tile_starts

        starts = process_tile_starts(starts)
    n_local = sum(min(s + tile_size, n_items) - s for s in starts)
    progress = profiling.ProgressReporter(n_local, unit=unit, label=label,
                                          enabled=bool(verbose))
    progress.note(note)
    gev_worker = DeferredGEV(label)
    keys = ("coef", "se", "pval") + (() if approx else ("needs_gev",))

    def harvest(start, stop, res):
        n = stop - start
        sl = slice(start, stop)
        for stat in stats:
            with profiling.phase(f"{label}.harvest"):
                with profiling.wait():
                    host = [res[f"{stat}_{k}"][:n].cpu().numpy()
                            for k in keys]
                profiling.resolve()
                out[f"{stat}_coef"][sl], out[f"{stat}_se"][sl], \
                    out[f"{stat}_pval"][sl] = host[:3]
                if not approx and host[3].any():
                    # gather only the flagged rows on the device: the card
                    # refits them in place, else the worker thread copies
                    # and refits them
                    gi, gk = np.nonzero(host[3])
                    full = res[f"{stat}_coef_full"]
                    rows_dev = full[torch.as_tensor(gi, device=full.device),
                                    torch.as_tensor(gk, device=full.device)]
                    gev_worker.submit(rows_dev, start + gi, gk,
                                      out[f"{stat}_pval"], resampling)
        progress.update(stop - start)

    def _pack(start):
        with profiling.phase(f"{label}.compress+pack"):
            return pack(start, min(start + tile_size, n_items), tile_size)

    pending = []
    # one prefetch thread: tile t+1 compresses while tile t runs
    prefetch = ThreadPoolExecutor(1, thread_name_prefix=f"{label}-pack")
    try:
        fut = profiling.submit(prefetch, _pack, starts[0]) if starts else None
        if starts:
            if not approx:
                gev_worker.preload(devices, num_boot)
            for dev in dict.fromkeys(devices):
                _warm_up(label, warm_key, n_items, pack, launch, dev)
        for i, start in enumerate(starts):
            with profiling.wait(f"{label}.pack.wait"):
                host_args, static = fut.result()
            fut = (profiling.submit(prefetch, _pack, starts[i + 1])
                   if i + 1 < len(starts) else None)
            dev = devices[i % len(devices)]
            with _on(dev):
                with profiling.phase(f"{label}.transfer"):
                    tile_args = tuple(
                        torch.as_tensor(np.ascontiguousarray(a), device=dev)
                        for a in host_args)
                r, t, u = tile_args[0].shape
                with profiling.device_phase(f"{label}.dispatch", dev), \
                        profiling.phase(f"{label}.launch", T=t, U=u, R=r,
                                        B=num_boot):
                    res = launch(start, tile_args, static, dev)
            pending.append((start, min(start + tile_size, n_items), res))
            while len(pending) > max_pending:
                harvest(*pending.pop(0))
        for item in pending:
            harvest(*item)
    finally:
        prefetch.shutdown(wait=True, cancel_futures=True)
        with profiling.phase(f"{label}.gev.join"):
            gev_worker.finish()
    progress.close()
    if nproc > 1:
        with profiling.phase(f"{label}.merge"):
            out = _merge_distributed(out, starts, tile_size, n_items)
    return out


def run_ht_1d(
    seed: int,
    compressed: Optional[Sequence] = None,  # list[CompressedGroup]
    true_mean: np.ndarray = None,  # [R, G]
    true_res_var: np.ndarray = None,  # [R, G]
    mv_coeffs: np.ndarray = None,  # [R, 3]
    q: np.ndarray = None,  # [R]
    covariate: np.ndarray = None,  # [R, K]
    treatment: np.ndarray = None,  # [R, Kt] or [G, R, Kt]
    num_boot: int = 1000,
    model: NoiseModel = None,
    sampler: str = "auto",
    resampling: str = "bootstrap",
    approx: bool = False,
    resample_rep: bool = False,
    tile_size: Optional[int] = None,
    boot_chunk: int = 1 << 30,
    verbose: bool = False,
    groups: Optional[Sequence] = None,  # list of [Nc_r, G] sparse CSC
    approx_sf: Optional[Sequence] = None,  # list of [Nc_r] quantized factors
    max_pending: int = DEFAULT_MAX_PENDING,
    device=None,
    custom_1d=None,
    mesh=None,
    distributed: bool = False,
):
    """Run the 1D test over all genes, tiling the gene axis.

    Two input modes:
      - ``compressed=[CompressedGroup, ...]``: pre-compressed tiles.
      - ``groups=[csc, ...], approx_sf=[...]``: raw per-group matrices,
        compressed per tile on a prefetch thread while the device runs the
        previous tile.

    Each tile's seed is ``fold_seed(seed, tile start)``, so results do not
    depend on the tiling order, the device or the process that runs the
    tile.  ``boot_chunk`` bounds the replicates drawn at once by the
    per-group samplers, ``custom_1d`` is a user estimator (see
    ``ht_1d_tile``).  ``mesh`` (a tuple of devices) sends whole tiles
    round-robin to its devices in place of ``device``; ``distributed=True``
    in a ``torch.distributed`` group runs this process's share of the tiles
    and merges the rows, every process returning the whole result (see the
    module docstring).

    Returns a dict of ``[G, Kt]`` float64 arrays: mean_coef/se/pval,
    var_coef/se/pval.
    """
    from ..ops.compress import compress_group

    nproc = _check_distributed(distributed)
    devices = _tile_devices(mesh, device, nproc)
    sampler = _resolve_sampler(sampler)
    if compressed is not None:
        r = len(compressed)
        u_fixed = max(c.padded_u for c in compressed)
    else:
        r = len(groups)
        u_fixed = None

    g = true_mean.shape[1]
    n_obs = np.array(
        [c.n_obs for c in compressed] if compressed is not None
        else [grp.shape[0] for grp in groups],
        dtype=np.float32,
    )

    per_gene_treatment = treatment.ndim == 3
    kt = treatment.shape[-1]
    one_sample = _one_sample_flags(treatment, per_gene_treatment)

    if tile_size is None:
        tile_size = _resolve_tile(r, num_boot, devices, nproc,
                                  _round_up(g, 64))

    vdtype = _value_dtype(_global_value_max(compressed, groups))
    cdtype = _count_dtype(_max_combo_count(compressed, approx_sf))

    def pack(start, stop, t):
        sl = slice(start, stop)
        if compressed is not None:
            u = u_fixed
            comps = compressed
            values = np.stack([_pad_axis(c.values[sl], u, 1) for c in comps])
            counts = np.stack([_pad_axis(c.counts[sl], u, 1) for c in comps])
            nuq = np.stack([c.n_unique[sl] for c in comps])
            csl = sl
        else:
            comps = [compress_group(grp, asf, cols=(start, stop))
                     for grp, asf in zip(groups, approx_sf)]
            u = _round_up(max(c.padded_u for c in comps), 64)
            values = np.stack([_pad_axis(c.values, u, 1) for c in comps])
            counts = np.stack([_pad_axis(c.counts, u, 1) for c in comps])
            nuq = np.stack([c.n_unique for c in comps])
            csl = slice(None)
        isf, isf2, binned = _sf_transport(comps, csl, u, t)
        host_args = (
            _pad_axis(values, t, 1).astype(vdtype),
            _pad_axis(counts, t, 1).astype(cdtype),
            isf,
            isf2,
            _pad_axis(nuq, t, 1).astype(np.int32),
            _pad_axis(true_mean[:, sl], t, 1, fill=np.nan),
            _pad_axis(true_res_var[:, sl], t, 1, fill=np.nan),
            np.asarray(mv_coeffs, dtype=np.float32),
            np.asarray(q, dtype=np.float32),
            n_obs,
            np.asarray(covariate, dtype=np.float32),
            _treatment_tile(treatment, start, stop, t),
        )
        return host_args, {"sf_binned": binned}

    def launch(start, tile_args, static, dev):
        return ht_1d_tile(
            fold_seed(seed, start), *tile_args,
            num_boot=num_boot, model=model,
            sampler=sampler, one_sample=one_sample,
            resampling=resampling, approx=approx, resample_rep=resample_rep,
            boot_chunk=min(boot_chunk, num_boot), custom_1d=custom_1d,
            treat_padded=per_gene_treatment, device=dev, **static)

    return _run_tiles(
        "ht1d", "genes", ("mean", "var"), g, tile_size, kt, pack, launch,
        devices=devices, nproc=nproc, num_boot=num_boot,
        resampling=resampling, approx=approx,
        max_pending=max_pending, verbose=verbose,
        note=f"{g} genes in tiles of {tile_size} on {_names(devices)} "
             f"(sampler {sampler}, {nproc} processes)",
        warm_key=(sampler, num_boot, r, kt,
                  np.shape(covariate)[-1], one_sample, per_gene_treatment,
                  resampling, approx, resample_rep, min(boot_chunk, num_boot),
                  id(custom_1d)))


def run_ht_2d(
    seed: int,
    compressed_pairs: Optional[Sequence] = None,  # list[CompressedPairGroup]
    true_corr: np.ndarray = None,  # [R, P]
    q: np.ndarray = None,  # [R]
    covariate: np.ndarray = None,  # [R, K]
    treatment: np.ndarray = None,  # [R, Kt] or [P, R, Kt]
    num_boot: int = 1000,
    model: NoiseModel = None,
    sampler: str = "auto",
    resampling: str = "bootstrap",
    approx: bool = False,
    resample_rep: bool = False,
    tile_size: Optional[int] = None,
    boot_chunk: int = 1 << 30,
    verbose: bool = False,
    groups: Optional[Sequence] = None,  # list of [Nc_r, G] sparse CSC
    approx_sf: Optional[Sequence] = None,  # list of [Nc_r] quantized factors
    idx1: Optional[np.ndarray] = None,  # [P] gene indices of each pair
    idx2: Optional[np.ndarray] = None,
    max_pending: int = DEFAULT_MAX_PENDING,
    device=None,
    custom_est=None,
    mesh=None,
    distributed: bool = False,
):
    """Run the 2D (differential correlation) test over all pairs, tiling the
    pair axis.

    Two input modes, as in ``run_ht_1d``:
      - ``compressed_pairs=[CompressedPairGroup, ...]``: pre-compressed.
      - ``groups=[csc, ...], approx_sf=[...], idx1, idx2``: raw per-group
        matrices and pair indices; each tile's pairs are jointly compressed
        (``compress_pairs``) on the prefetch thread.

    Each tile's seed is ``fold_seed(seed, tile start)``; ``ht_2d_tile`` folds
    the 2D path constant into it.  ``boot_chunk``, the user estimators
    ``custom_est = (fn_1d, fn_cov)``, ``mesh`` and ``distributed`` as in
    ``run_ht_1d``.

    Returns a dict of ``[P, Kt]`` float64 arrays: corr_coef/se/pval.
    """
    from ..ops.compress import compress_pairs

    nproc = _check_distributed(distributed)
    devices = _tile_devices(mesh, device, nproc)
    sampler = _resolve_sampler(sampler)
    if compressed_pairs is not None:
        r = len(compressed_pairs)
        u_fixed = max(c.padded_u for c in compressed_pairs)
        n_obs = [c.n_obs for c in compressed_pairs]
    else:
        r = len(groups)
        u_fixed = None
        n_obs = [grp.shape[0] for grp in groups]
    n_obs = np.array(n_obs, dtype=np.float32)
    p = true_corr.shape[1]

    per_pair_treatment = treatment.ndim == 3
    kt = treatment.shape[-1]
    one_sample = _one_sample_flags(treatment, per_pair_treatment)

    if tile_size is None:
        tile_size = _resolve_tile(r, num_boot, devices, nproc,
                                  min(MAX_PAIR_TILE, _round_up(p, 64)))

    vdtype = _value_dtype(_global_value_max(compressed_pairs, groups,
                                            ("values_1", "values_2")))
    # the zero-zero combo of a bin can hold the bin's whole population
    cdtype = _count_dtype(_max_combo_count(compressed_pairs, approx_sf))

    def pack(start, stop, t):
        sl = slice(start, stop)
        if compressed_pairs is not None:
            u = u_fixed
            comps = compressed_pairs
            csl = sl
        else:
            comps = [compress_pairs(grp, asf, idx1[sl], idx2[sl])
                     for grp, asf in zip(groups, approx_sf)]
            u = _round_up(max(c.padded_u for c in comps), 64)
            csl = slice(None)
        v1, v2, cnt = (
            _pad_axis(np.stack([_pad_axis(getattr(c, f)[csl], u, 1)
                                for c in comps]), t, 1)
            for f in ("values_1", "values_2", "counts"))
        isf, isf2, binned = _sf_transport(comps, csl, u, t)
        host_args = (
            v1.astype(vdtype),
            v2.astype(vdtype),
            cnt.astype(cdtype),
            isf,
            isf2,
            _pad_axis(true_corr[:, sl], t, 1, fill=np.nan),
            np.asarray(q, dtype=np.float32),
            n_obs,
            np.asarray(covariate, dtype=np.float32),
            _treatment_tile(treatment, start, stop, t),
        )
        return host_args, {"sf_binned": binned}

    def launch(start, tile_args, static, dev):
        return ht_2d_tile(
            fold_seed(seed, start), *tile_args,
            num_boot=num_boot, model=model,
            sampler=sampler, one_sample=one_sample,
            resampling=resampling, approx=approx, resample_rep=resample_rep,
            boot_chunk=min(boot_chunk, num_boot), custom_est=custom_est,
            treat_padded=per_pair_treatment, device=dev, **static)

    return _run_tiles(
        "ht2d", "pairs", ("corr",), p, tile_size, kt, pack, launch,
        devices=devices, nproc=nproc, num_boot=num_boot,
        resampling=resampling, approx=approx,
        max_pending=max_pending, verbose=verbose,
        note=f"{p} pairs in tiles of {tile_size} on {_names(devices)} "
             f"(sampler {sampler}, {nproc} processes)",
        warm_key=(sampler, num_boot, r, kt,
                  np.shape(covariate)[-1], one_sample, per_pair_treatment,
                  resampling, approx, resample_rep, min(boot_chunk, num_boot),
                  id(custom_est)))


__all__ = ["fill_invalid", "ht_1d_tile", "ht_2d_tile", "run_ht_1d",
           "run_ht_2d", "default_tile_size", "tile_budget", "MAX_PAIR_TILE",
           "CPU_TILE_BUDGET", "TILE_MEMORY_SHARE"]
