"""Batched GEV tail refinement (host, numpy/scipy).

A copy of ``memento_tpu/inference/gev.py`` (numpy only, so the port keeps its
own).  Every test whose two-sided extreme count is <= 10 is refined by
fitting a generalized extreme value law to shrinking sorted tails (300 -> 60
in steps of 30), accepting a fit whose KS p-value exceeds 0.05, and summing
the scaled tail CDF/SF.  The refits run vectorized over all flagged rows:

- probability-weighted-moment (Hosking 1985) starting values,
- a batched Nelder-Mead minimization of the GEV negative log-likelihood,
- the exact finite-n KS p-value via ``scipy.stats.kstwo.sf``,
- the reference's tail schedule, 0.05 KS gate, left-then-right ordering and
  counting-bound fallback.

``asl.gev_refine`` (serial, scipy) is the oracle and takes rows with
non-finite entries.
"""

from __future__ import annotations

import numpy as np
import scipy.special as sspec
import scipy.stats as sstats

from .asl import gev_refine

KS_GATE = 0.05
TAIL_SCHEDULE = tuple(range(300, 50, -30))  # 300, 270, ..., 60

# once-per-process latch for the small-num_boot warning (emitted from
# gev_refine_batch, which the tiled HT paths call once per tile)
_WARNED_SMALL_B = False
_GUMBEL_EPS = 1e-7
_EULER = 0.5772156649015329


# ---------------------------------------------------------------------------
# batched GEV primitives (scipy ``genextreme`` parameterization: shape c,
# support 1 - c*(x-loc)/scale > 0)
# ---------------------------------------------------------------------------


def gev_nll(params: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Negative log-likelihood per row; +inf outside the support.

    Args:
      params: ``[M, 3]`` (c, loc, scale).
      xs: ``[M, L]`` data.
    """
    c = params[:, 0:1]
    loc = params[:, 1:2]
    scale = params[:, 2:3]
    L = xs.shape[1]
    valid_scale = scale[:, 0] > 0
    safe_scale = np.where(scale > 0, scale, 1.0)
    z = (xs - loc) / safe_scale

    gumbel = np.abs(c[:, 0]) < _GUMBEL_EPS
    with np.errstate(all="ignore"):
        w = 1.0 - c * z
        in_support = (w > 0).all(axis=1)
        logw = np.log(np.maximum(w, 1e-300))
        t = np.exp(logw / np.where(np.abs(c) < _GUMBEL_EPS, 1.0, c))
        nll_gev = (t - (1.0 / c - 1.0) * logw).sum(axis=1)
        nll_gum = (np.exp(-np.clip(z, -700, 700)) + z).sum(axis=1)
    nll = np.where(gumbel, nll_gum, nll_gev) + L * np.log(safe_scale[:, 0])
    ok = valid_scale & (in_support | gumbel) & np.isfinite(nll)
    return np.where(ok, nll, np.inf)


def gev_cdf(x: np.ndarray, c, loc, scale) -> np.ndarray:
    """Batched genextreme CDF at one point per row."""
    with np.errstate(all="ignore"):
        z = (x - loc) / scale
        w = 1.0 - c * z
        t = np.exp(np.log(np.maximum(w, 1e-300))
                   / np.where(np.abs(c) < _GUMBEL_EPS, 1.0, c))
        cdf = np.exp(-t)
        cdf_gum = np.exp(-np.exp(-np.clip(z, -700, 700)))
    cdf = np.where(np.abs(c) < _GUMBEL_EPS, cdf_gum, cdf)
    # outside support: above the upper endpoint (c>0) -> 1, below the lower
    # endpoint (c<0) -> 0
    cdf = np.where(w <= 0, np.where(c > 0, 1.0, 0.0), cdf)
    return cdf


def gev_sf(x, c, loc, scale):
    return 1.0 - gev_cdf(x, c, loc, scale)


def pwm_start(xs_sorted: np.ndarray) -> np.ndarray:
    """Hosking (1985) probability-weighted-moment GEV estimates per row.

    Args:
      xs_sorted: ``[M, L]`` ascending-sorted data.

    Returns:
      ``[M, 3]`` (c, loc, scale) starting values (finite, scale > 0).
    """
    m, L = xs_sorted.shape
    j = np.arange(L, dtype=np.float64)
    b0 = xs_sorted.mean(axis=1)
    b1 = (xs_sorted * (j / max(L - 1, 1))).mean(axis=1)
    b2 = (xs_sorted * (j * (j - 1)
                       / max((L - 1) * (L - 2), 1))).mean(axis=1)
    with np.errstate(all="ignore"):
        zc = (2 * b1 - b0) / np.where(3 * b2 - b0 == 0, np.nan, 3 * b2 - b0) \
            - np.log(2) / np.log(3)
        k = 7.8590 * zc + 2.9554 * zc * zc
        g1k = sspec.gamma(1.0 + k)
        scale = (2 * b1 - b0) * k / (g1k * (1.0 - np.exp2(-k)))
        loc = b0 + scale * (g1k - 1.0) / k
        # Gumbel limit for tiny k
        scale_g = (2 * b1 - b0) / np.log(2)
        loc_g = b0 - _EULER * scale_g
    tiny = np.abs(k) < 1e-4
    k = np.where(tiny, 0.0, k)
    scale = np.where(tiny, scale_g, scale)
    loc = np.where(tiny, loc_g, loc)
    # robust fallback where PWM failed (degenerate data)
    std = xs_sorted.std(axis=1)
    bad = ~(np.isfinite(k) & np.isfinite(loc) & np.isfinite(scale)
            & (scale > 0))
    k = np.where(bad, 0.0, k)
    loc = np.where(bad, b0, loc)
    scale = np.where(bad, np.maximum(std, 1e-8), np.maximum(scale, 1e-12))
    return np.stack([k, loc, scale], axis=1)


def nelder_mead_batch(f, x0: np.ndarray, data: np.ndarray, iters: int = 150,
                      xatol: float = 1e-5, fatol: float = 1e-6) -> np.ndarray:
    """Minimize ``f(params [M, D], data [M, ...]) -> [M]`` per row.

    Standard Nelder-Mead (rho=1, chi=2, psi=0.5, sigma=0.5, scipy's simplex
    initialization), with every row stepped in lockstep via masks.  All four
    candidate points are evaluated each iteration — redundant FLOPs buy full
    vectorization across rows.  Converged rows (simplex collapsed below
    ``xatol``/``fatol``) are compacted out of the working set together with
    their data, so the cost tracks the slowest rows only.
    """
    m, d = x0.shape
    out = np.empty_like(x0)
    active = np.arange(m)

    simplex = np.repeat(x0[:, None, :], d + 1, axis=1)  # [M, D+1, D]
    nonzdelt, zdelt = 0.05, 0.00025
    for k in range(d):
        pt = simplex[:, k + 1, k]
        simplex[:, k + 1, k] = np.where(pt != 0, pt * (1 + nonzdelt), zdelt)
    fvals = np.stack([f(simplex[:, i], data) for i in range(d + 1)], axis=1)

    rho, chi, psi, sigma = 1.0, 2.0, 0.5, 0.5
    for _ in range(iters):
        order = np.argsort(fvals, axis=1)
        fvals = np.take_along_axis(fvals, order, axis=1)
        simplex = np.take_along_axis(simplex, order[:, :, None], axis=1)

        conv = (
            np.abs(simplex[:, 1:] - simplex[:, :1]).max(axis=(1, 2)) <= xatol
        ) & (np.abs(fvals[:, 1:] - fvals[:, :1]).max(axis=1) <= fatol)
        conv |= ~np.isfinite(fvals).any(axis=1)  # hopeless rows: stop early
        if conv.any():
            out[active[conv]] = simplex[conv, 0]
            keep = ~conv
            if not keep.any():
                return out
            active = active[keep]
            simplex = simplex[keep]
            fvals = fvals[keep]
            data = data[keep]

        centroid = simplex[:, :d].mean(axis=1)
        worst = simplex[:, -1]
        diff = centroid - worst
        xr = centroid + rho * diff
        xe = centroid + rho * chi * diff
        xco = centroid + psi * rho * diff
        xci = centroid - psi * diff
        fr = f(xr, data)
        fe = f(xe, data)
        fco = f(xco, data)
        fci = f(xci, data)

        f_best = fvals[:, 0]
        f_second = fvals[:, -2]
        f_worst = fvals[:, -1]

        use_e = (fr < f_best) & (fe < fr)
        use_r = ((fr < f_best) & ~(fe < fr)) | ((fr >= f_best)
                                                & (fr < f_second))
        use_co = (fr >= f_second) & (fr < f_worst) & (fco <= fr)
        use_ci = (fr >= f_worst) & (fci < f_worst)
        shrink = ~(use_e | use_r | use_co | use_ci)

        new_pt = np.where(
            use_e[:, None], xe,
            np.where(use_r[:, None], xr,
                     np.where(use_co[:, None], xco, xci)))
        new_f = np.where(use_e, fe,
                         np.where(use_r, fr, np.where(use_co, fco, fci)))
        simplex[:, -1] = np.where(shrink[:, None], simplex[:, -1], new_pt)
        fvals[:, -1] = np.where(shrink, fvals[:, -1], new_f)

        if shrink.any():
            best_pt = simplex[:, 0:1]
            shrunk = best_pt + sigma * (simplex[:, 1:] - best_pt)
            sm = shrink[:, None, None]
            simplex = np.where(sm, np.concatenate([best_pt, shrunk], axis=1),
                               simplex)
            for i in range(1, d + 1):
                fi = f(simplex[:, i], data)
                fvals[:, i] = np.where(shrink, fi, fvals[:, i])

    order = np.argsort(fvals, axis=1)
    simplex = np.take_along_axis(simplex, order[:, :, None], axis=1)
    out[active] = simplex[:, 0]
    return out


def gev_fit_batch(tails: np.ndarray, iters: int = 150):
    """Batched GEV MLE per row from PWM starts.

    Returns:
      (params ``[M, 3]``, ok ``[M]`` bool — finite NLL at the optimum).
    """
    x0 = pwm_start(np.sort(tails, axis=1))
    params = nelder_mead_batch(gev_nll, x0, tails, iters=iters)
    ok = np.isfinite(gev_nll(params, tails))
    return params, ok


def ks_pvalue_batch(tails_sorted: np.ndarray, params: np.ndarray) -> np.ndarray:
    """Two-sided exact KS p-value per row (== ``scipy.stats.kstest``)."""
    m, L = tails_sorted.shape
    c = params[:, 0:1]
    loc = params[:, 1:2]
    scale = params[:, 2:3]
    cdf = gev_cdf(tails_sorted, c, loc, scale)
    i = np.arange(1, L + 1, dtype=np.float64)
    d_plus = (i / L - cdf).max(axis=1)
    d_minus = (cdf - (i - 1) / L).max(axis=1)
    d = np.maximum(d_plus, d_minus)
    return sstats.kstwo.sf(np.clip(d, 0.0, 1.0), L)


# ---------------------------------------------------------------------------
# the reference refinement procedure, batched over rows
# ---------------------------------------------------------------------------


def _one_side(sorted_null: np.ndarray, points: np.ndarray, side: str,
              nm_iters: int):
    """Run the tail schedule for one side over all rows.

    Args:
      sorted_null: ``[M, B]`` ascending.
      points: ``[M]`` evaluation points (-|stat| left, |stat| right).
      side: 'left' (CDF of the smallest tail) or 'right' (SF of the largest).

    Returns:
      (value ``[M]`` scaled tail probability, resolved ``[M]`` bool).
    """
    m, b = sorted_null.shape
    value = np.zeros(m)
    resolved = np.zeros(m, bool)
    unres = np.arange(m)
    for n_exec in TAIL_SCHEDULE:
        if unres.size == 0:
            break
        le = min(n_exec, b)
        tails = (sorted_null[unres, :le] if side == "left"
                 else sorted_null[unres, b - le:])
        params, ok = gev_fit_batch(tails, iters=nm_iters)
        ksp = ks_pvalue_batch(np.sort(tails, axis=1), params)
        accept = ok & (ksp > KS_GATE)
        if accept.any():
            rows = unres[accept]
            pa = params[accept]
            pts = points[rows]
            if side == "left":
                val = gev_cdf(pts, pa[:, 0], pa[:, 1], pa[:, 2])
            else:
                val = gev_sf(pts, pa[:, 0], pa[:, 1], pa[:, 2])
            # the reference scales by n_exec/B even when the slice clipped
            value[rows] = (n_exec / b) * val
            resolved[rows] = True
            unres = unres[~accept]
    return value, resolved


def gev_refine_batch(stats: np.ndarray, nulls: np.ndarray,
                     fallbacks: np.ndarray, nm_iters: int = 150) -> np.ndarray:
    """Reference GEV refinement for many tests at once.

    Args:
      stats: ``[M]`` observed statistics.
      nulls: ``[M, B]`` null draws (already re-centred for bootstrap).
      fallbacks: ``[M]`` counting p-values used when fitting fails.

    Returns:
      ``[M]`` refined p-values.
    """
    stats = np.asarray(stats, np.float64)
    nulls = np.asarray(nulls, np.float64)
    out = np.asarray(fallbacks, np.float64).copy()
    m = stats.shape[0]
    if m == 0:
        return out
    global _WARNED_SMALL_B
    if nulls.shape[1] < TAIL_SCHEDULE[0] and not _WARNED_SMALL_B:
        # The schedule's "tail" is then the (clipped) whole null and the
        # reference's n_exec/B scaling exceeds 1 — the refinement is
        # nonsensical at this B (ref hypothesis_test.py:103-121 has the same
        # behavior silently).  Keep the bug-compatible numbers, but warn
        # ONCE per process — the tiled HT paths call this per tile (from the
        # deferred worker), and under an "always"/"error" warning filter the
        # repeat would fire for every tile of a long run.
        import warnings

        _WARNED_SMALL_B = True
        warnings.warn(
            f"GEV tail refinement with num_boot={nulls.shape[1]} < "
            f"{TAIL_SCHEDULE[0]}: the tail slice clips to the whole null "
            "and the reference's n_exec/B scale factor exceeds 1; refined "
            "p-values at this B are unreliable — use num_boot >= 300 or "
            "approx=True",
            RuntimeWarning, stacklevel=2)

    finite = np.isfinite(nulls).all(axis=1) & np.isfinite(stats)
    # rows with non-finite entries take the serial scipy path (rare; the
    # reference filters per-row, which breaks the fixed batch width)
    for i in np.nonzero(~finite)[0]:
        row = nulls[i]
        out[i] = gev_refine(stats[i], row[np.isfinite(row)], out[i])

    idx = np.nonzero(finite)[0]
    if idx.size == 0:
        return out
    sorted_null = np.sort(nulls[idx], axis=1)
    abs_stat = np.abs(stats[idx])

    left_val, left_ok = _one_side(sorted_null, -abs_stat, "left", nm_iters)
    # the reference attempts the right tail only when the left succeeded
    # and falls back when either side fails
    right_val = np.zeros(idx.size)
    right_ok = np.zeros(idx.size, bool)
    if left_ok.any():
        rv, rk = _one_side(sorted_null[left_ok], abs_stat[left_ok], "right",
                           nm_iters)
        right_val[left_ok] = rv
        right_ok[left_ok] = rk
    both = left_ok & right_ok
    out[idx[both]] = left_val[both] + right_val[both]
    return out


__all__ = [
    "gev_nll",
    "gev_cdf",
    "gev_sf",
    "pwm_start",
    "nelder_mead_batch",
    "gev_fit_batch",
    "ks_pvalue_batch",
    "gev_refine_batch",
    "TAIL_SCHEDULE",
    "KS_GATE",
]
