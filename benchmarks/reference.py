"""The plain reference: memento's 1D and 2D tests written out directly.

It follows the method's definition (Kim et al., memento; the estimators of
``memento_tpu``'s documentation), not the program's code, and imports
nothing of the program nor JAX.  From the same counts and labels that the
program was given it works out everything again: the size factors and
their bins, the groups, the observed moments, the gene filter, the
mean-variance fit, a bootstrap that resamples each group's cells with
replacement (``B`` multinomial weight vectors per group, shared by the
genes of the group: each gene's replicates have the same law as the
program's per-gene draws over compressed values), the meta-regression, the
standard errors and the two-sided counting p-values.  It does not refit the
tails of the flagged tests (memento's GEV step): no number that compares
them separates a skipped refit from sound runs yet (PERF.md).  It
implements the hyper_relative estimator and the bootstrap without the
normal approximation: ``supported`` refuses any other setting, so that a
cell with another is not judged against the wrong law.

Two precisions are named: ``host`` for the observed moments, the filter and
the fits, ``device`` for the bootstrap replicates, the meta-regression and
the p-values.  The reference is float64 in both.  The control computes the
same in the nearest precision below what the configuration states
(``precisions``: float32 for float64, bfloat16 for float32).

Where the program's semantics carry a detail that is not the method's, it
is followed here and named:

- the observed statistics use the exact size factors, the replicates the
  binned ones (30 equal-width bins, each cell's factor replaced by its bin
  mean, the largest kept exactly);
- a replicate whose mean or residual variance is not positive and finite is
  replaced by a draw among the same group's valid replicates; a group with
  none, or whose observed moments are not valid, gets weight 0;
- the regression weight of a group is its number of cells;
- the per-group gene filter compares scipy's mean of the counts, in the
  counts' float32, with the threshold (memento's own computation), so a
  mean that equals the threshold exactly passes when float32 rounds it up;
- a 2D replicate with a non-positive variance enters the null as
  correlation 1.0; an observed correlation of +-1 drops its group.

The combination count of a group's (value, size-factor bin) pairs, which the
program also asks to exceed 1, is not checked: it is at least the number
of occupied size-factor bins, so it decides nothing on these data.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# the nearest precision below each that a configuration may state
BELOW = {"float64": torch.float32, "float32": torch.bfloat16}
# samplers whose law is the multinomial resample that the reference draws
EXACT_LAW = ("auto", "cascade", "cascade_cuda", "multinomial")


def precisions(config) -> dict:
    """``{"reference": .., "control": ..}``, each ``{"host": dtype,
    "device": dtype}``: the reference in float64, the control one step
    below what the configuration states for its host stages and its device
    program."""
    stated = config["precision"]
    return {"reference": {"host": torch.float64, "device": torch.float64},
            "control": {"host": BELOW[stated["host_stages"]],
                        "device": BELOW[stated["device_program"]]}}


def supported(config, traffic) -> None:
    """Raise ``ValueError`` where the cell asks for what the reference does
    not implement."""
    wrong = []
    if config["estimator"] != "hyper_relative":
        wrong.append(f"estimator {config['estimator']!r}")
    if traffic["resampling"] != "bootstrap":
        wrong.append(f"resampling {traffic['resampling']!r}")
    if traffic["approx"]:
        wrong.append("approx=True")
    if traffic["sampler"] not in EXACT_LAW:
        wrong.append(f"sampler {traffic['sampler']!r}")
    if wrong:
        raise ValueError("the reference implements the hyper_relative "
                         "estimator and the exact bootstrap only, not "
                         + ", ".join(wrong))


# ---------------------------------------------------------------------------
# host stages
# ---------------------------------------------------------------------------

@dataclass
class Coo:
    """A group's or a cell type's counts as (row, column, value) tensors."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    n_rows: int
    n_cols: int


def to_coo(X, dtype, device) -> Coo:
    """A scipy CSR matrix as COO tensors on ``device``."""
    indptr = np.asarray(X.indptr, np.int64)
    rows = np.repeat(np.arange(X.shape[0], dtype=np.int64), np.diff(indptr))
    return Coo(torch.as_tensor(rows, device=device),
               torch.as_tensor(np.asarray(X.indices, np.int64), device=device),
               torch.as_tensor(np.asarray(X.data), device=device).to(dtype),
               X.shape[0], X.shape[1])


def col_sum(coo: Coo, vals) -> torch.Tensor:
    out = torch.zeros(coo.n_cols, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, coo.cols, vals)


def row_sum(coo: Coo, vals) -> torch.Tensor:
    out = torch.zeros(coo.n_rows, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, coo.rows, vals)


def moments(coo: Coo, sf, q):
    """Mean and variance per gene under the hypergeometric capture model:
    ``M1 = mean(x / sf)``, ``var = mean(x^2 / sf^2) - (1 - q) mean(x /
    sf^2) - M1^2``."""
    inv = 1.0 / sf[coo.rows]
    n = coo.n_rows
    m1 = col_sum(coo, coo.vals * inv) / n
    m2 = col_sum(coo, coo.vals * coo.vals * inv * inv) / n \
        - (1.0 - q) * col_sum(coo, coo.vals * inv * inv) / n
    return m1, m2 - m1 * m1


def polyfit2(mean, var) -> np.ndarray:
    """Least-squares ``log var ~ c2 log^2 m + c1 log m + c0`` over the
    genes with a positive, finite mean and variance (float64 on the host,
    as the fit is a handful of numbers); ``[c2, c1, c0]``."""
    mean = np.asarray(mean, np.float64)
    var = np.asarray(var, np.float64)
    ok = (mean > 0) & (var > 0) & np.isfinite(mean) & np.isfinite(var)
    x, y = np.log(mean[ok]), np.log(var[ok])
    if x.size < 3:
        return np.zeros(3)
    A = np.stack([x * x, x, np.ones_like(x)], 1)
    return np.linalg.lstsq(A, y, rcond=None)[0]


def residual_variance(mean, var, fit):
    """``var / exp(poly(log mean))``, NaN where mean or var is not
    positive."""
    ok = (mean > 0) & (var > 0)
    lm = torch.log(torch.where(ok, mean, torch.ones_like(mean)))
    lv = torch.log(torch.where(ok, var, torch.ones_like(var)))
    c2, c1, c0 = (float(c) for c in fit)
    rv = torch.exp(lv - (c2 * lm * lm + c1 * lm + c0))
    return torch.where(ok, rv, torch.full_like(rv, float("nan")))


def bin_factors(sf: np.ndarray, num_bins: int) -> np.ndarray:
    """Each factor replaced by the mean of its equal-width bin (edges from
    the smallest to the largest factor); the largest is kept exactly."""
    lo, hi = sf.min(), sf.max()
    if hi == lo:
        return sf.copy()
    edges = np.linspace(lo, hi, num_bins + 1)
    idx = np.clip(np.searchsorted(edges, sf, side="right") - 1, 0,
                  num_bins - 1)
    sums = np.bincount(idx, weights=sf, minlength=num_bins)
    cnt = np.bincount(idx, minlength=num_bins)
    out = sums[idx] / cnt[idx]
    out[sf == hi] = hi
    return out


@dataclass
class Prepared:
    """What the 1D and 2D tests start from, for one cell type."""

    genes: np.ndarray  # [Gt] names of the tested genes
    tested: np.ndarray  # [G] bool
    groups: list  # [(condition, donor)]
    group_rows: list  # [np.ndarray of the group's cell rows]
    sf: np.ndarray  # [N] exact size factors
    approx_sf: np.ndarray  # [N] binned
    mean: torch.Tensor  # [R, Gt] observed
    var: torch.Tensor  # [R, Gt]
    res_var: torch.Tensor  # [R, Gt]
    fit: np.ndarray  # shared mean-variance fit
    q: float


def prepare(X, condition, donor, q, gene_names, *, filter_mean_thresh=0.07,
            trim_percent=0.1, shrinkage=0.5, num_bins=30,
            min_perc_group=0.7, host=torch.float64, device="cpu") -> Prepared:
    """Size factors, groups, observed moments, gene filter and the shared
    mean-variance fit of one cell type (``setup_memento``,
    ``create_groups`` and ``compute_1d_moments`` of the method)."""
    coo = to_coo(X, host, device)
    n = coo.n_rows
    obs_mean = col_sum(coo, coo.vals) / n

    # size factors: total counts, then the least variable genes' counts
    naive = row_sum(coo, coo.vals)
    m, v = moments(coo, naive, q)
    m = torch.where(obs_mean < filter_mean_thresh, torch.zeros_like(m), m)
    rv = residual_variance(m, v, polyfit2(m.cpu(), v.cpu()))
    rv = rv.double().cpu().numpy()
    finite = rv[np.isfinite(rv)]
    if finite.size:
        mask = np.where(np.isfinite(rv), rv, np.inf) \
            < np.quantile(finite, trim_percent)
    else:
        mask = obs_mean.cpu().numpy() > 0
    keep = torch.as_tensor(mask, device=device)[coo.cols]
    nrc = row_sum(coo, torch.where(keep, coo.vals, torch.zeros_like(coo.vals)))
    nrc = nrc.double().cpu().numpy()
    nrc = nrc + np.quantile(nrc, shrinkage)
    sf = nrc / nrc.mean()
    approx_sf = bin_factors(sf, num_bins)

    # groups in order of appearance
    labels = np.asarray(condition, np.int64) * 100_000 + np.asarray(donor)
    _, first = np.unique(labels, return_index=True)
    order = labels[np.sort(first)]
    groups = [(int(lab // 100_000), int(lab % 100_000)) for lab in order]
    group_rows = [np.nonzero(labels == lab)[0] for lab in order]

    sf_t = torch.as_tensor(sf, device=device).to(host)
    means, vars_, fmask, rvmask = [], [], [], []
    for rows in group_rows:
        Xg = X[rows]
        sub = to_coo(Xg, host, device)
        mg, vg = moments(sub, sf_t[torch.as_tensor(rows, device=device)], q)
        # memento's per-group filter takes scipy's mean of the counts in
        # their own dtype (float32): at a tie (count / cells == threshold)
        # its rounding decides, so it is taken the same way here
        om = torch.as_tensor(np.asarray(Xg.mean(axis=0)).ravel(),
                             device=device)
        mx = torch.zeros(sub.n_cols, dtype=host, device=device)
        mx = mx.scatter_reduce_(0, sub.cols, sub.vals, "amax")
        means.append(mg)
        vars_.append(vg)
        fmask.append((om > filter_mean_thresh) & (vg > 0))
        rvmask.append(mx >= 2)
    tested = (torch.stack(fmask).to(torch.float64).mean(0)
              > min_perc_group).cpu().numpy()
    t_idx = torch.as_tensor(np.nonzero(tested)[0], device=device)
    mean = torch.stack(means)[:, t_idx]
    var = torch.stack(vars_)[:, t_idx]
    rvm = torch.stack(rvmask)[:, t_idx]
    fit = polyfit2(mean[rvm].cpu(), var[rvm].cpu())
    return Prepared(genes=np.asarray(gene_names)[tested], tested=tested,
                    groups=groups, group_rows=group_rows, sf=sf,
                    approx_sf=approx_sf, mean=mean, var=var,
                    res_var=residual_variance(mean, var, fit), fit=fit, q=q)


# ---------------------------------------------------------------------------
# bootstrap, meta-regression, p-values
# ---------------------------------------------------------------------------

def resample_weights(n: int, num_boot: int, gen, device, dtype):
    """``[B, n]`` multiplicities of ``n`` cells drawn with replacement."""
    idx = torch.randint(0, n, (num_boot, n), generator=gen, device=device)
    w = torch.zeros((num_boot, n), dtype=torch.float32, device=device)
    w.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.float32))
    return w.to(dtype)


def dense_columns(X, rows, cols, dtype, device):
    """``X[rows][:, cols]`` as a dense ``[n, len(cols)]`` tensor."""
    sub = X[rows][:, cols].toarray()
    return torch.as_tensor(sub, device=device).to(dtype)


def fill_invalid(vals, valid, gen):
    """Replace invalid replicates ``[..., B]`` by draws among the row's valid
    ones; returns (filled, row has none)."""
    dead = ~valid.any(-1)
    n_valid = valid.sum(-1, keepdim=True).clamp_min(1)
    order = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    u = torch.rand(vals.shape, generator=gen, device=vals.device)
    pick = torch.minimum((u * n_valid).long(), n_valid - 1)
    donors = torch.gather(vals, -1, torch.gather(order, -1, pick))
    return torch.where(valid, vals, donors), dead


def meta_regress(stats, weights, covariate, treatment):
    """Weighted slope of each statistic on the treatment, both residualized
    on the covariates (with intercept).

    Args:
      stats: ``[G, R, M]``; weights: ``[G, R]``; covariate ``[R, K]`` and
      treatment ``[R]`` as float64 numpy.

    Returns:
      ``[G, M]`` in ``stats``' dtype; NaN where the treatment has no
      contrast among the weighted groups, the weighted average where every
      weighted group is treated (one sample).
    """
    dt, dev = stats.dtype, stats.device
    work = torch.float32 if dt == torch.bfloat16 else dt
    C = torch.as_tensor(np.column_stack([np.ones(len(treatment)), covariate]),
                        device=dev, dtype=work)
    t = torch.as_tensor(treatment, device=dev, dtype=work)
    w = weights.to(work)
    # projection onto the covariates under each gene's weights
    A = torch.einsum("rk,gr,rl->gkl", C, w, C)
    P = torch.linalg.pinv(A)  # [G, K, K]
    H = torch.einsum("rk,gkl,sl,gs->grs", C, P, C, w)  # [G, R, R] hat
    H = H.to(dt)
    t_res = (t.to(dt)[None, :] - torch.einsum("grs,s->gr", H, t.to(dt)))
    y_res = stats - torch.einsum("grs,gsm->grm", H, stats)
    wd = weights.to(dt)
    wsum = wd.sum(-1)
    ss = (wd * t_res * t_res).sum(-1)
    num = torch.einsum("gr,gr,grm->gm", wd, t_res, y_res)
    coef = num / ss[:, None]
    raw = (wd * t.to(dt)[None, :] ** 2).sum(-1)
    dead = ss.float() <= 1e-9 * raw.float()
    live = wd > 0
    one_sample = dead & (live & (t.to(dt)[None, :] == 1) | ~live).all(-1) \
        & live.any(-1)
    avg = (wd[..., None] * stats).sum(1) / wsum[:, None]
    nan = torch.full_like(coef, float("nan"))
    return torch.where(one_sample[:, None], avg,
                       torch.where(dead[:, None], nan, coef))


@dataclass
class TestResult:
    """One statistic's results per item: observed coefficient, bootstrap SE
    and the counting p-value."""

    coef: np.ndarray
    se: np.ndarray
    pval: np.ndarray


def finish(full) -> TestResult:
    """SE (population standard deviation of the finite replicates) and the
    two-sided counting p-value: ``(1 + #{|null| > |stat|}) / (1 + #finite)``
    over the replicates centred on the observed coefficient, NaN where every
    coefficient is equal."""
    full = full.to(torch.float64)
    stat, boot = full[:, 0], full[:, 1:]
    ok = torch.isfinite(boot)
    k = ok.sum(-1)
    zeros = torch.zeros_like(boot)
    mean = torch.where(ok, boot, zeros).sum(-1) / k.clamp_min(1)
    se = torch.sqrt(torch.where(ok, (boot - mean[:, None]) ** 2, zeros)
                    .sum(-1) / k.clamp_min(1))
    se = torch.where(k > 0, se, torch.full_like(se, float("nan")))
    null = boot - stat[:, None]
    finite = torch.isfinite(null)
    n = finite.sum(-1)
    a = stat.abs()[:, None]
    ec = (((null > a) | (null < -a)) & finite).sum(-1)
    p = (ec + 1.0) / (n + 1.0)
    degenerate = (full == full.mean(-1, keepdim=True)).all(-1)
    p = torch.where(degenerate, torch.full_like(p, float("nan")), p)
    return TestResult(stat.cpu().numpy(), se.cpu().numpy(), p.cpu().numpy())


def test_1d(X, prep: Prepared, covariate, treatment, *, num_boot: int,
            seed: int, device_dtype=torch.float64, device="cpu",
            gene_block: int = 4096):
    """The differential mean (DE) and variability (DV) tests of every tested
    gene: ``(de, dv)`` ``TestResult``s in ``prep.genes``' order.

    ``covariate`` ``[R, K]`` and ``treatment`` ``[R]`` are per group, in
    ``prep.groups``' order."""
    dt = device_dtype
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cols = np.nonzero(prep.tested)[0]
    n_genes = cols.size
    c = 1.0 - prep.q
    fit = [float(x) for x in prep.fit]
    boot_m = []
    boot_v = []
    for rows in prep.group_rows:
        n = rows.size
        w = resample_weights(n, num_boot, gen, device, dt)
        inv = torch.as_tensor(1.0 / prep.approx_sf[rows], device=device)
        sub = X[rows][:, cols]
        mg, vg = [], []
        for lo in range(0, n_genes, gene_block):
            x = torch.as_tensor(sub[:, lo:lo + gene_block].toarray(),
                                device=device).to(torch.float64)
            a1 = (x * inv[:, None]).to(dt)
            a2 = ((x * x - c * x) * (inv * inv)[:, None]).to(dt)
            m1 = (w @ a1) / n
            m2 = (w @ a2) / n
            mg.append(m1.T)
            vg.append((m2 - m1 * m1).T)
        boot_m.append(torch.cat(mg))  # [Gt, B]
        boot_v.append(torch.cat(vg))
    boot_m = torch.stack(boot_m)  # [R, Gt, B]
    boot_v = torch.stack(boot_v)
    ok = (boot_m > 0) & (boot_v > 0)
    lm = torch.log(torch.where(ok, boot_m, torch.ones_like(boot_m)))
    rv = torch.exp(torch.log(torch.where(ok, boot_v, torch.ones_like(boot_v)))
                   - (fit[0] * lm * lm + fit[1] * lm + fit[2]))
    rv = torch.where(ok, rv, torch.full_like(rv, float("nan")))
    fm, m_dead = fill_invalid(boot_m, torch.isfinite(boot_m) & (boot_m > 0),
                              gen)
    fv, v_dead = fill_invalid(rv, torch.isfinite(rv) & (rv > 0), gen)
    mean = prep.mean.to(device=device, dtype=dt)
    res_var = prep.res_var.to(device=device, dtype=dt)
    good = (torch.isfinite(mean) & torch.isfinite(res_var) & (mean != 0)
            & (res_var > 0) & ~m_dead & ~v_dead)  # [R, Gt]
    one = torch.ones_like(mean)
    zero = torch.zeros((), dtype=dt, device=device)
    s_m = torch.cat([torch.log(torch.where(good, mean, one))[..., None],
                     torch.log(fm.clamp_min(0))], -1)
    s_v = torch.cat([torch.log(torch.where(good, res_var, one))[..., None],
                     torch.log(fv.clamp_min(0))], -1)
    s_m = torch.where(good[..., None], s_m, zero).transpose(0, 1)
    s_v = torch.where(good[..., None], s_v, zero).transpose(0, 1)
    n_obs = torch.as_tensor([r.size for r in prep.group_rows], device=device,
                            dtype=dt)
    weights = torch.where(good, n_obs[:, None], zero).T  # [Gt, R]
    any_good = good.any(0)
    out = []
    for s in (s_m, s_v):
        coef = meta_regress(s, weights, covariate, treatment)
        coef = torch.where(any_good[:, None], coef,
                           torch.full_like(coef, float("nan")))
        out.append(finish(coef))
    return tuple(out)


def test_2d(X, prep: Prepared, idx1, idx2, covariate, treatment, *,
            num_boot: int, seed: int, device_dtype=torch.float64,
            device="cpu"):
    """The differential correlation test of the gene pairs ``(idx1,
    idx2)`` (positions among ``prep.genes``, distinct genes): a
    ``TestResult`` in the pairs' order."""
    dt = device_dtype
    host = prep.mean.dtype
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cols = np.nonzero(prep.tested)[0]
    idx1 = np.asarray(idx1)
    idx2 = np.asarray(idx2)
    genes = np.unique(np.concatenate([idx1, idx2]))
    pos = {g: k for k, g in enumerate(genes)}
    p1 = torch.as_tensor([pos[g] for g in idx1], device=device)
    p2 = torch.as_tensor([pos[g] for g in idx2], device=device)
    c = 1.0 - prep.q
    sf = prep.sf
    obs, boot = [], []
    for r, rows in enumerate(prep.group_rows):
        n = rows.size
        x = dense_columns(X, rows, cols[genes], host, device)
        inv = torch.as_tensor(1.0 / sf[rows], device=device).to(host)
        # observed covariance with the exact factors; variances of the 1D
        # moments
        xs = x * inv[:, None]
        cov = (xs[:, p1] * xs[:, p2]).sum(0) / n \
            - (xs[:, p1].sum(0) / n) * (xs[:, p2].sum(0) / n)
        var = prep.var[r, torch.as_tensor(genes)].to(device)
        obs.append(corr(cov, var[p1], var[p2]))
        # replicates with the binned factors
        x = x.to(torch.float64)
        inv_b = torch.as_tensor(1.0 / prep.approx_sf[rows], device=device)
        w = resample_weights(n, num_boot, gen, device, dt)
        a1 = (x * inv_b[:, None]).to(dt)
        a2 = ((x * x - c * x) * (inv_b * inv_b)[:, None]).to(dt)
        ax = (x[:, p1] * x[:, p2] * (inv_b * inv_b)[:, None]).to(dt)
        m1 = (w @ a1) / n  # [B, g]
        v = (w @ a2) / n - m1 * m1
        cv = (w @ ax) / n - m1[:, p1] * m1[:, p2]
        boot.append(corr(cv, v[:, p1], v[:, p2]).T)  # [P, B]
    obs = torch.stack(obs).to(dt)  # [R, P]
    boot = torch.stack(boot)  # [R, P, B]
    filled, dead = fill_invalid(boot, torch.isfinite(boot), gen)
    good = torch.isfinite(obs) & (obs.abs() != 1.0) & ~dead
    zero = torch.zeros((), dtype=dt, device=device)
    s = torch.cat([torch.where(good, obs, zero)[..., None], filled], -1)
    s = torch.where(good[..., None], s, zero).transpose(0, 1)
    n_obs = torch.as_tensor([r.size for r in prep.group_rows], device=device,
                            dtype=dt)
    weights = torch.where(good, n_obs[:, None], zero).T
    coef = meta_regress(s, weights, covariate, treatment)
    coef = torch.where(good.any(0)[:, None], coef,
                       torch.full_like(coef, float("nan")))
    return finish(coef)


def corr(cov, var_1, var_2):
    """Covariance to correlation: 1.0 where a variance is not positive, NaN
    where the covariance is NaN, else clipped to [-1, 1]."""
    bad = ~(var_1 > 0) | ~(var_2 > 0)
    one = torch.ones((), dtype=cov.dtype, device=cov.device)
    r = cov / torch.sqrt(torch.where(bad, one, var_1)
                         * torch.where(bad, one, var_2))
    return torch.where(bad, one, torch.clamp(r, -1.0, 1.0))


__all__ = ["precisions", "supported", "prepare", "test_1d", "test_2d", "bin_factors",
           "moments", "polyfit2", "meta_regress", "finish", "Prepared",
           "TestResult"]
