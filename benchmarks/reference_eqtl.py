"""The plain reference of the eQTL cell: memento's 1D test with a covariate
table and per-gene treatments, written out directly.

It extends ``benchmarks/reference.py`` (whose set-up, replicate weights,
invalid-value fill and p-values it imports) to memento's eQTL mode: an
``[R, K]`` table of per-group covariates and, for each gene, its own
``[R, Kt]`` treatment columns (the gene's cis-SNP dosages), of which the
first ``n_cols[g]`` are tested.  Each column is regressed on its own, after
the covariates and an intercept are taken out under the gene's group
weights (memento's meta-regression, one slope per column).  A gene whose
every tested column is 1 on every weighted group is one-sample: each of its
columns gets the weighted average.  Like ``reference.py`` it imports
nothing of the program nor JAX, and does not refit the tails (GEV).

Genes run in blocks of ``gene_block``, so that 120 groups at B = 5,000
fit on the card: each group's replicate weights are drawn once, before the
first block, and serve every block; the invalid-value fill draws from the
same generator block after block.  With one block (``gene_block`` at least
the number of tested genes) the draws are ``reference.test_1d``'s, in its
order.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import TestResult, fill_invalid, finish, resample_weights


def meta_regress(stats, weights, covariate, treatment, n_cols):
    """Weighted slope of each statistic on each tested treatment column,
    both residualized on the covariates (with intercept).

    Args:
      stats: ``[G, R, M]``; weights: ``[G, R]``; covariate: ``[R, K]``
        float64 numpy; treatment: ``[G, R, Kt]``; n_cols: ``[G]`` tested
        columns of each gene (the rest is padding).

    Returns:
      ``[G, Kt, M]`` in ``stats``' dtype; NaN where a column has no
      contrast among the weighted groups and in the padding, the weighted
      average in every column of a one-sample gene.
    """
    dt, dev = stats.dtype, stats.device
    work = torch.float32 if dt == torch.bfloat16 else dt
    r = stats.shape[1]
    C = torch.as_tensor(np.column_stack([np.ones(r), covariate]),
                        device=dev, dtype=work)
    t = torch.as_tensor(treatment, device=dev, dtype=work)
    w = weights.to(work)
    A = torch.einsum("rk,gr,rl->gkl", C, w, C)
    P = torch.linalg.pinv(A)  # [G, K+1, K+1]
    H = torch.einsum("rk,gkl,sl,gs->grs", C, P, C, w).to(dt)  # [G, R, R]
    t = t.to(dt)
    t_res = t - torch.einsum("grs,gsk->grk", H, t)
    y_res = stats - torch.einsum("grs,gsm->grm", H, stats)
    wd = weights.to(dt)
    ss = torch.einsum("gr,grk->gk", wd, t_res * t_res)
    num = torch.einsum("gr,grk,grm->gkm", wd, t_res, y_res)
    coef = num / ss[..., None]
    raw = torch.einsum("gr,grk->gk", wd, t * t)
    dead = ss.float() <= 1e-9 * raw.float()
    kt = t.shape[-1]
    tested = torch.arange(kt, device=dev)[None, :] \
        < torch.as_tensor(np.asarray(n_cols), device=dev)[:, None]  # [G, Kt]
    live = wd > 0
    ones = ((t == 1) | ~live[..., None]).all(1)  # [G, Kt]
    one_sample = (ones | ~tested).all(-1) & tested.any(-1) & live.any(-1)
    avg = (wd[..., None] * stats).sum(1) / wd.sum(-1)[:, None]  # [G, M]
    nan = torch.full_like(coef, float("nan"))
    coef = torch.where(dead[..., None] | ~tested[..., None], nan, coef)
    return torch.where(one_sample[:, None, None], avg[:, None, :]
                       .expand_as(coef), coef)


def _dense(X, rows, cols, device):
    """``X[rows][:, cols]`` as a dense float64 ``[n, len(cols)]`` tensor."""
    return torch.as_tensor(X[rows][:, cols].toarray(),
                           device=device).to(torch.float64)


def test_1d(X, prep, covariate, treatment, n_cols, *, num_boot: int,
            seed: int, device_dtype=torch.float64, device="cpu",
            gene_block: int = 256):
    """The DE and DV tests of every tested gene and each of its tested
    columns.

    Args:
      X: the cell type's CSR counts; prep: ``reference.prepare``'s result.
      covariate: ``[R, K]`` per group, in ``prep.groups``' order, without
        an intercept (one is added).
      treatment: ``[Gt, R, Kt]`` per tested gene (``prep.genes``' order) and
        group; n_cols: ``[Gt]``.

    Returns:
      ``(de, dv)`` ``TestResult``s of ``[Gt, Kt]`` arrays (NaN beyond each
      gene's tested columns).
    """
    dt = device_dtype
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cols = np.nonzero(prep.tested)[0]
    n_genes = cols.size
    c = 1.0 - prep.q
    fit = [float(x) for x in prep.fit]
    sizes = [rows.size for rows in prep.group_rows]
    w_all = [resample_weights(n, num_boot, gen, device, dt) for n in sizes]
    inv = [torch.as_tensor(1.0 / prep.approx_sf[rows], device=device)
           for rows in prep.group_rows]
    x_all = [_dense(X, rows, cols, device) for rows in prep.group_rows]
    n_obs = torch.as_tensor(sizes, device=device, dtype=dt)
    zero = torch.zeros((), dtype=dt, device=device)
    treatment = np.asarray(treatment, np.float64)
    n_cols = np.asarray(n_cols)
    parts = {"de": [], "dv": []}
    for lo in range(0, n_genes, gene_block):
        hi = min(lo + gene_block, n_genes)
        boot_m, boot_v = [], []
        for w, iv, x, n in zip(w_all, inv, x_all, sizes):
            x = x[:, lo:hi]
            a1 = (x * iv[:, None]).to(dt)
            a2 = ((x * x - c * x) * (iv * iv)[:, None]).to(dt)
            m1 = (w @ a1) / n
            m2 = (w @ a2) / n
            boot_m.append(m1.T)
            boot_v.append((m2 - m1 * m1).T)
        boot_m = torch.stack(boot_m)  # [R, g, B]
        boot_v = torch.stack(boot_v)
        ok = (boot_m > 0) & (boot_v > 0)
        lm = torch.log(torch.where(ok, boot_m, torch.ones_like(boot_m)))
        rv = torch.exp(torch.log(torch.where(ok, boot_v,
                                             torch.ones_like(boot_v)))
                       - (fit[0] * lm * lm + fit[1] * lm + fit[2]))
        rv = torch.where(ok, rv, torch.full_like(rv, float("nan")))
        del boot_v, lm, ok
        fm, m_dead = fill_invalid(
            boot_m, torch.isfinite(boot_m) & (boot_m > 0), gen)
        del boot_m
        fv, v_dead = fill_invalid(rv, torch.isfinite(rv) & (rv > 0), gen)
        del rv
        mean = prep.mean[:, lo:hi].to(device=device, dtype=dt)
        res_var = prep.res_var[:, lo:hi].to(device=device, dtype=dt)
        good = (torch.isfinite(mean) & torch.isfinite(res_var)
                & (mean != 0) & (res_var > 0) & ~m_dead & ~v_dead)  # [R, g]
        one = torch.ones_like(mean)
        weights = torch.where(good, n_obs[:, None], zero).T  # [g, R]
        any_good = good.any(0)
        for name, obs, filled in (("de", mean, fm), ("dv", res_var, fv)):
            s = torch.cat([torch.log(torch.where(good, obs, one))[..., None],
                           torch.log(filled.clamp_min(0))], -1)
            s = torch.where(good[..., None], s, zero).transpose(0, 1)
            coef = meta_regress(s, weights, covariate, treatment[lo:hi],
                                n_cols[lo:hi])  # [g, Kt, B+1]
            del s
            coef = torch.where(any_good[:, None, None], coef,
                               torch.full_like(coef, float("nan")))
            g, kt, m = coef.shape
            res = finish(coef.reshape(g * kt, m))
            parts[name].append(TestResult(res.coef.reshape(g, kt),
                                          res.se.reshape(g, kt),
                                          res.pval.reshape(g, kt)))
        del fm, fv
    out = []
    for name in ("de", "dv"):
        kt = treatment.shape[-1]
        if parts[name]:
            out.append(TestResult(*(np.concatenate([getattr(p, k)
                                                    for p in parts[name]])
                                    for k in ("coef", "se", "pval"))))
        else:
            empty = np.zeros((0, kt))
            out.append(TestResult(empty, empty, empty))
    return tuple(out)


__all__ = ["meta_regress", "test_1d"]
