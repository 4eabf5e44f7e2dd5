"""Gene-batched differential mean / variability tests (1D).

Counterpart of ``memento_tpu/inference/ht.py`` (its 1D half).  One device
program, ``ht_1d_tile``, evaluates a padded tile of genes across every
replicate group at once:

  bootstrap sampling  ->  moment contraction  ->  residual-variance transform
  ->  invalid-value fill  ->  weighted meta-regression  ->  ASL

and ``run_ht_1d`` tiles the gene axis on the host: it compresses tile t+1 on
a prefetch thread while the device runs tile t, ships compact transport
dtypes, bounds the tiles in flight, and refines the flagged p-value tails
(GEV) on a worker thread.  Group dropping and NaN semantics are masks and
zero weights, as in the JAX package.

Device math is float32, as on the JAX device path; host stages are float64.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import fold_seed, generator, resolve_device
from ..ops.bootstrap import SAMPLERS, bootstrap_1d
from ..ops.estimators import NoiseModel
from ..ops.mv_regression import residual_variance
from ..utils import profiling
from .asl import asl_counting
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
    sf_binned: bool = False,
    treat_padded: bool = False,
    device=None,
):
    """Differential mean/variability test for one tile of genes.

    Inputs are numpy arrays (any transport dtype) or tensors; they move to
    ``device`` (default ``cuda``) and are computed in float32.  ``seed`` is
    the tile's derived seed; the stages fold it further (0: bootstrap,
    (1, 0)/(1, 1): mean/variance fill, 2: replicate resampling).

    Returns a dict of ``[T, Kt]`` tensors (observed coefficients, bootstrap
    SEs, first-stage p-values, GEV flags) and the full coefficient tensors
    ``[T, Kt, B+1]`` for the host tail refinement.
    """
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, device=dev).to(torch.float32)

    values = f32(values)
    counts = f32(counts)
    if sf_binned:
        table = f32(inv_sf_sq)  # [R, NB]
        ids = torch.as_tensor(inv_sf, device=dev).long()
        inv_sf = torch.gather(table, 1, ids.reshape(ids.shape[0], -1)
                              ).reshape(ids.shape)
        inv_sf_sq = inv_sf * inv_sf
    else:
        inv_sf = f32(inv_sf)
        inv_sf_sq = f32(inv_sf_sq)
    n_unique = torch.as_tensor(n_unique, device=dev)
    true_mean = f32(true_mean)
    true_res_var = f32(true_res_var)
    mv_coeffs = f32(mv_coeffs)
    q = f32(q)
    n_obs = f32(n_obs)
    covariate = f32(covariate)
    treatment = f32(treatment)

    boot_mean_raw, boot_var_raw = bootstrap_1d(
        values, counts, inv_sf, inv_sf_sq, n_obs[:, None], q[:, None], model,
        num_boot, fold_seed(seed, 0), sampler)  # [R, T, B]

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


class _DeferredGEV:
    """GEV tail refinement on a worker thread, off the tile loop.

    The main thread gathers the flagged coefficient rows on the device;
    the copy to the host and the batched MLE run on one worker thread,
    overlapped with later tiles.  Each task writes a disjoint set of
    ``(row, col)`` entries of its p-value array, submitted only after the
    counting p-values of those rows were stored.  ``finish()`` joins every
    task and re-raises the first worker error.
    """

    def __init__(self, phase_name: str):
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._futs = []
        self._phase = phase_name

    def submit(self, rows_dev, gi: np.ndarray, gk: np.ndarray,
               out_pval: np.ndarray, resampling: str) -> None:
        # the first call imports scipy.stats, which takes seconds
        with profiling.phase(self._phase + ".import"):
            from .gev import gev_refine_batch

        def work():
            with profiling.phase(self._phase):
                rows = rows_dev.cpu().numpy().astype(np.float64)
                stats = rows[:, 0]
                nulls = rows[:, 1:]
                if resampling == "bootstrap":
                    nulls = nulls - stats[:, None]
                out_pval[gi, gk] = gev_refine_batch(
                    stats, nulls, out_pval[gi, gk])

        self._futs.append(self._pool.submit(work))

    def finish(self) -> None:
        try:
            for f in self._futs:
                f.result()
        finally:
            self._futs = []
            self._pool.shutdown(wait=True)


def default_tile_size(r: int, num_boot: int,
                      budget_elems: int = 1 << 28) -> int:
    """Gene-tile size: peak memory is about a dozen ``[R, T, B]`` float
    buffers, so the tile can be large."""
    t = budget_elems // max(1, r * num_boot * 12)
    t = max(64, min(8192, t))
    return (t // 64) * 64


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _max_combo_count(compressed, approx_sf) -> float:
    """Upper bound on any combo multiplicity: the largest size-factor-bin
    population (a combo can never exceed its bin's occupancy)."""
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


def _global_value_max(compressed, groups) -> float:
    if compressed is not None:
        return max((float(np.max(c.values, initial=0.0)) for c in compressed),
                   default=0.0)
    return max((float(grp.max()) if grp.nnz else 0.0 for grp in groups),
               default=0.0)


def _one_sample_flags(treatment: np.ndarray, per_item: bool) -> bool:
    """Static all-genes one-sample shortcut: a globally all-ones treatment
    stays all-ones after any group drop, so the tiles skip the regression.
    Otherwise the tiles decide per gene after the drop."""
    if not per_item:
        return bool(np.all(treatment == 1))
    col_used = (treatment != 0).any(axis=1)  # [G, Kt]; False = padding
    vec = np.all((treatment == 1) | ~col_used[:, None, :], axis=(1, 2)) \
        & col_used.any(axis=1)
    return bool(vec.all())


# Bound on tiles launched but not yet harvested: each pending result pins
# two [T, Kt, B+1] float32 coefficient tensors on the device.
DEFAULT_MAX_PENDING = 3


def _resolve_sampler(sampler: str, device: torch.device) -> str:
    """``'auto'`` -> the CUDA kernel on a CUDA device, the plain cascade on
    the CPU; ``'cascade'`` asks for the plain version explicitly."""
    if sampler == "auto":
        return "cascade_cuda" if device.type == "cuda" else "cascade"
    if sampler not in SAMPLERS:
        raise NotImplementedError(
            f"sampler {sampler!r} is not ported yet; options: "
            f"{('auto',) + SAMPLERS}")
    return sampler


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
    depend on the tiling order.

    Returns a dict of ``[G, Kt]`` float64 arrays: mean_coef/se/pval,
    var_coef/se/pval.
    """
    if custom_1d is not None or mesh is not None or distributed:
        raise NotImplementedError(
            "custom estimators, mesh and distributed runs are not ported yet")
    from ..ops.compress import compress_group

    dev = resolve_device(device)
    sampler = _resolve_sampler(sampler, dev)
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
        tile_size = min(default_tile_size(r, num_boot), _round_up(g, 64))

    out = {
        k: np.full((g, kt), np.nan)
        for k in ["mean_coef", "mean_se", "mean_pval", "var_coef", "var_se",
                  "var_pval"]
    }

    vdtype = _value_dtype(_global_value_max(compressed, groups))
    cdtype = _count_dtype(_max_combo_count(compressed, approx_sf))

    def tile_inputs(start, stop, t):
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
        binned = all(c.sf_bin is not None for c in comps)
        if binned:
            # compact transport: 1 uint8 bin id per slot + a [R, NB] table
            isf = np.stack([_pad_axis(c.sf_bin[csl], u, 1, 0) for c in comps]
                           ).astype(np.uint8)
            nb = max(len(c.bin_inv_sf) for c in comps)
            isf2 = np.stack([_pad_axis(c.bin_inv_sf, nb, 0, 1.0)
                             for c in comps]).astype(np.float32)
            isf = _pad_axis(isf, t, 1, 0)
        else:
            # quantized size factors tolerate float16
            isf = np.stack([_pad_axis(c.inv_sf[csl], u, 1, 1.0)
                            for c in comps])
            isf2 = np.stack([_pad_axis(c.inv_sf_sq[csl], u, 1, 1.0)
                             for c in comps])
            isf = _pad_axis(isf, t, 1, 1.0).astype(np.float16)
            isf2 = _pad_axis(isf2, t, 1, 1.0).astype(np.float16)
        values = _pad_axis(values, t, 1).astype(vdtype)
        counts = _pad_axis(counts, t, 1).astype(cdtype)
        return (values, counts, isf, isf2,
                _pad_axis(nuq, t, 1).astype(np.int32), binned)

    def harvest(start, stop, res):
        n = stop - start
        sl = slice(start, stop)
        for stat in ("mean", "var"):
            with profiling.phase("ht1d.harvest"):
                coef, se, pval = (res[f"{stat}_{k}"][:n].cpu().numpy()
                                  for k in ("coef", "se", "pval"))
            rows_dev = gi = gk = None
            if not approx:
                with profiling.phase("ht1d.gev"):
                    needs = res[f"{stat}_needs_gev"][:n].cpu().numpy()
                    if needs.any():
                        # gather only the flagged rows on the device; the
                        # copy and the refit run on the worker thread
                        gi, gk = np.nonzero(needs)
                        full = res[f"{stat}_coef_full"]
                        rows_dev = full[torch.as_tensor(gi, device=full.device),
                                        torch.as_tensor(gk, device=full.device)]
            out[f"{stat}_coef"][sl] = coef
            out[f"{stat}_se"][sl] = se
            out[f"{stat}_pval"][sl] = pval
            if rows_dev is not None:
                gev_worker.submit(rows_dev, start + gi, gk,
                                  out[f"{stat}_pval"], resampling)
        progress.update(min(stop, g) - start)

    starts = list(range(0, g, tile_size))
    progress = profiling.ProgressReporter(g, unit="genes", label="ht1d",
                                          enabled=bool(verbose))
    progress.note(f"{g} genes in tiles of {tile_size} on {dev} "
                  f"(sampler {sampler})")
    pending = []
    gev_worker = _DeferredGEV("ht1d.gev.refine")

    def _pack(start):
        with profiling.phase("ht1d.compress+pack"):
            return tile_inputs(start, min(start + tile_size, g), tile_size)

    # one prefetch thread: tile t+1 compresses while tile t runs
    prefetch = ThreadPoolExecutor(1, thread_name_prefix="ht1d-pack")
    try:
        fut = prefetch.submit(_pack, starts[0]) if starts else None
        for i, start in enumerate(starts):
            stop = min(start + tile_size, g)
            t = tile_size
            sl = slice(start, stop)
            values, counts, isf, isf2, nuq, binned = fut.result()
            fut = (prefetch.submit(_pack, starts[i + 1])
                   if i + 1 < len(starts) else None)
            if per_gene_treatment:
                treat_tile = _pad_axis(treatment[sl], t, 0)
            else:
                treat_tile = np.broadcast_to(treatment, (stop - start, r, kt))
                treat_tile = _pad_axis(treat_tile, t, 0)
            host_args = (
                values,
                counts,
                isf,
                isf2,
                nuq,
                _pad_axis(true_mean[:, sl], t, 1, fill=np.nan),
                _pad_axis(true_res_var[:, sl], t, 1, fill=np.nan),
                np.asarray(mv_coeffs, dtype=np.float32),
                np.asarray(q, dtype=np.float32),
                n_obs,
                np.asarray(covariate, dtype=np.float32),
                np.asarray(treat_tile, dtype=np.float32),
            )
            with profiling.phase("ht1d.transfer", device=dev):
                tile_args = tuple(torch.as_tensor(np.ascontiguousarray(a),
                                                  device=dev)
                                  for a in host_args)
            with profiling.phase("ht1d.dispatch", device=dev):
                res = ht_1d_tile(
                    fold_seed(seed, start), *tile_args,
                    num_boot=num_boot, model=model, sampler=sampler,
                    one_sample=one_sample, resampling=resampling,
                    approx=approx, resample_rep=resample_rep,
                    sf_binned=binned, treat_padded=per_gene_treatment,
                    device=dev)
            pending.append((start, stop, res))
            while len(pending) > max_pending:
                harvest(*pending.pop(0))
        for item in pending:
            harvest(*item)
    finally:
        prefetch.shutdown(wait=True, cancel_futures=True)
        with profiling.phase("ht1d.gev.join"):
            gev_worker.finish()
    progress.close()
    return out


__all__ = ["fill_invalid", "ht_1d_tile", "run_ht_1d", "default_tile_size"]
