"""Public API of the 1D slice.

Counterpart of ``memento_tpu/api.py`` for the differential mean /
variability test: ``setup_memento -> create_groups -> compute_1d_moments ->
ht_1d_moments -> get_1d_ht_result`` (plus ``get_groups`` and
``get_1d_moments``), over the pandas-free ``containers.AnnData`` with the
same ``adata.uns['memento']`` keys as the JAX package.  Tables come back as
``ColumnTable``s with the JAX DataFrames' column names and order.

Host stages are numpy/scipy in float64; the tests run on the device given to
``ht_1d_moments`` (default ``cuda``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sparse

from .containers import ColumnTable
from .device import fold_seed
from .inference.ht import run_ht_1d
from .ops import estimators as est
from .ops.mv_regression import fit_mv_regressor
from .ops.size_factor import bin_size_factor, estimate_size_factor

__all__ = [
    "setup_memento",
    "create_groups",
    "get_groups",
    "compute_1d_moments",
    "ht_1d_moments",
    "get_1d_moments",
    "get_1d_ht_result",
]

RESULT_COLUMNS = ["gene", "tx", "de_coef", "de_se", "de_pval", "dv_coef",
                  "dv_se", "dv_pval"]


def _residual_variance_np(mean, var, coeffs):
    """Host residual variance, NaN where mean<=0 or var<=0."""
    mean = np.asarray(mean, dtype=np.float64)
    var = np.asarray(var, dtype=np.float64)
    rv = np.full(mean.shape, np.nan)
    cond = (mean > 0) & (var > 0)
    c2, c1, c0 = coeffs
    lm = np.log(mean[cond])
    rv[cond] = np.exp(np.log(var[cond]) - (c2 * lm * lm + c1 * lm + c0))
    return rv


def _model(uns) -> est.NoiseModel:
    model = est.get_noise_model(uns["estimator_type"])
    if model is None:
        raise NotImplementedError(
            "custom (fn_1d, fn_cov) estimators are not ported yet")
    return model


def _observed_moments(uns, X, n_obs, q, size_factor):
    model = _model(uns)
    if not model.relative:
        size_factor = np.ones(n_obs)
    m, v = est.mean_var_sparse(X, size_factor, q, model)
    return [np.asarray(m), np.asarray(v)]


def _table_values(table):
    """(float64 ``[R, K]`` values, column names) of a table-like input: a
    ColumnTable, anything with ``.values``/``.columns``, or a 2-D array
    (columns named 0..K-1)."""
    if hasattr(table, "values") and hasattr(table, "columns"):
        return np.asarray(table.values, dtype=np.float64), list(table.columns)
    arr = np.asarray(table, dtype=np.float64)
    if arr.ndim != 2:
        raise ValueError(f"expected a 2-D table, got shape {arr.shape}")
    return arr, list(range(arr.shape[1]))


def setup_memento(
    adata,
    q_column,
    inplace=True,
    filter_mean_thresh=0.07,
    trim_percent=0.1,
    shrinkage=0.5,
    num_bins=30,
    estimator_type="hyper_relative",
):
    """Size factors and the overall mean-variance regressor."""
    if not inplace:
        adata = adata.copy()

    q_all = np.asarray(adata.obs[q_column], dtype=np.float64)
    if not q_all.max() < 1:
        raise ValueError(f"capture efficiencies in {q_column!r} must be < 1")
    if not sparse.issparse(adata.X):
        adata.X = sparse.csr_matrix(adata.X)
    adata.X = adata.X.tocsr()

    uns = adata.uns["memento"] = {}
    uns["q_column"] = q_column
    uns["all_q"] = float(q_all.mean())
    uns["estimator_type"] = estimator_type
    uns["filter_mean_thresh"] = filter_mean_thresh
    uns["num_bins"] = num_bins

    # naive total-count size factor, residual variance over all cells
    naive_sf = estimate_size_factor(adata.X, estimator_type, total=True,
                                    shrinkage=0.0)
    all_m, all_v = est.mean_var_sparse(adata.X, naive_sf, uns["all_q"],
                                       "hyper_relative")
    obs_mean = np.asarray(adata.X.mean(axis=0)).ravel()
    all_m = np.asarray(all_m).copy()
    all_m[obs_mean < filter_mean_thresh] = 0  # mean filter
    all_res_var = _residual_variance_np(all_m, all_v,
                                        fit_mv_regressor(all_m, all_v))

    # least-variable genes for normalization; with no finite residual
    # variance (degenerate tiny inputs) take every expressed gene
    finite_rv = all_res_var[np.isfinite(all_res_var)]
    if finite_rv.size:
        rv_ulim = np.quantile(finite_rv, trim_percent)
        all_res_var = np.where(np.isfinite(all_res_var), all_res_var, np.inf)
        mask = all_res_var < rv_ulim
    else:
        mask = obs_mean > 0
    if not mask.any():
        mask = obs_mean > 0
    uns["least_variable_genes"] = adata.var.index[mask].tolist()

    # masked + shrunk size factor; zero-total cells get the smallest factor
    size_factor = estimate_size_factor(adata.X, estimator_type, mask=mask,
                                       shrinkage=shrinkage)
    if np.any(size_factor <= 0):
        floor = size_factor[size_factor > 0].min() \
            if (size_factor > 0).any() else 1.0
        size_factor = np.where(size_factor > 0, size_factor, floor)
    adata.obs["memento_size_factor"] = size_factor

    uns["all_1d_moments"] = _observed_moments(
        uns, adata.X, adata.shape[0], uns["all_q"], size_factor)
    if not inplace:
        return adata


def create_groups(adata, label_columns, label_delimiter="^", inplace=True):
    """Discrete cell groups from obs columns (``sg^<col1>^<col2>...``)."""
    if not inplace:
        adata = adata.copy()

    labels = np.full(adata.n_obs, "sg" + label_delimiter, dtype=object)
    for idx, col in enumerate(label_columns):
        labels = labels + np.asarray(adata.obs[col]).astype(str).astype(object)
        if idx != len(label_columns) - 1:
            labels = labels + label_delimiter
    labels = labels.astype(str)
    adata.obs["memento_group"] = labels

    uns = adata.uns["memento"]
    uns["label_columns"] = list(label_columns)
    uns["label_delimiter"] = label_delimiter
    _, first = np.unique(labels, return_index=True)
    uns["groups"] = labels[np.sort(first)].tolist()  # order of appearance
    uns["q"] = np.asarray(adata.obs[uns["q_column"]])

    X_csc = adata.X.tocsc()
    group_masks = {g: labels == g for g in uns["groups"]}
    uns["group_cells"] = {g: X_csc[m, :] for g, m in group_masks.items()}
    uns["group_q"] = {
        g: float(np.asarray(uns["q"][m], dtype=np.float64).mean())
        for g, m in group_masks.items()
    }
    if not inplace:
        return adata


def _bin_size_factor_uns(adata):
    """Quantize size factors and split them per group."""
    uns = adata.uns["memento"]
    size_factor = np.asarray(adata.obs["memento_size_factor"])
    groups = np.asarray(adata.obs["memento_group"])
    approx_sf = bin_size_factor(size_factor, num_bins=uns["num_bins"])
    uns["all_approx_size_factor"] = approx_sf
    uns["approx_size_factor"] = {g: approx_sf[groups == g]
                                 for g in uns["groups"]}
    uns["size_factor"] = {g: size_factor[groups == g] for g in uns["groups"]}


def _to_numeric(col: np.ndarray) -> np.ndarray:
    for dtype in (np.int64, np.float64):
        try:
            return col.astype(dtype)
        except ValueError:
            continue
    return col


def get_groups(adata) -> ColumnTable:
    """Group labels split back into their columns, indexed by group name
    (numeric where every label parses)."""
    uns = adata.uns["memento"]
    rows = np.array([g.split(uns["label_delimiter"])[1:]
                     for g in uns["groups"]], dtype=str)
    rows = rows.reshape(len(uns["groups"]), len(uns["label_columns"]))
    return ColumnTable(
        {col: _to_numeric(rows[:, j])
         for j, col in enumerate(uns["label_columns"])},
        index=np.array(uns["groups"]))


def compute_1d_moments(adata, inplace=True, min_perc_group=0.7,
                       filter_genes=True, gene_list=None):
    """Mean, variance and residual variance per group."""
    if "memento" not in adata.uns:
        raise ValueError("run setup_memento first")
    if not inplace:
        adata = adata.copy()
    uns = adata.uns["memento"]

    if "size_factor" not in uns:
        _bin_size_factor_uns(adata)

    groups = uns["groups"]
    uns["1d_moments"] = {
        g: _observed_moments(uns, uns["group_cells"][g],
                             uns["group_cells"][g].shape[0],
                             uns["group_q"][g], uns["size_factor"][g])
        for g in groups
    }

    uns["gene_filter"] = {}
    uns["gene_rv_filter"] = {}
    for g in groups:
        cells = uns["group_cells"][g]
        obs_mean = np.asarray(cells.mean(axis=0)).ravel()
        uns["gene_filter"][g] = (obs_mean > uns["filter_mean_thresh"]) & (
            uns["1d_moments"][g][1] > 0)
        obs_max = cells.max(axis=0).toarray().ravel() \
            if sparse.issparse(cells) else cells.max(axis=0)
        uns["gene_rv_filter"][g] = obs_max >= 2

    gene_masks = np.vstack([uns["gene_filter"][g] for g in groups])
    overall_gene_mask = gene_masks.mean(axis=0) > min_perc_group
    uns["overall_gene_filter"] = overall_gene_mask
    uns["gene_list"] = adata.var.index[overall_gene_mask].tolist()

    if filter_genes:
        uns["group_cells"] = {
            g: uns["group_cells"][g][:, overall_gene_mask] for g in groups}
        uns["1d_moments"] = {
            g: [uns["1d_moments"][g][0][overall_gene_mask],
                uns["1d_moments"][g][1][overall_gene_mask]]
            for g in groups
        }
        uns["gene_rv_filter"] = {
            g: uns["gene_rv_filter"][g][overall_gene_mask] for g in groups}
        adata._inplace_subset_var(overall_gene_mask)

    # one shared mv-regressor fit on the concatenated filtered moments
    mean_concat = np.concatenate(
        [uns["1d_moments"][g][0][uns["gene_rv_filter"][g]] for g in groups])
    var_concat = np.concatenate(
        [uns["1d_moments"][g][1][uns["gene_rv_filter"][g]] for g in groups])
    shared_fit = fit_mv_regressor(mean_concat, var_concat)
    uns["mv_regressor"] = {"all": shared_fit}
    for g in groups:
        uns["mv_regressor"][g] = shared_fit

    for g in groups:
        uns["1d_moments"][g].append(_residual_variance_np(
            uns["1d_moments"][g][0], uns["1d_moments"][g][1],
            uns["mv_regressor"][g]))

    if gene_list is not None:
        given = np.isin(adata.var.index, list(gene_list))
        uns["group_cells"] = {g: uns["group_cells"][g][:, given]
                              for g in groups}
        uns["1d_moments"] = {g: [m[given] for m in uns["1d_moments"][g]]
                             for g in groups}
        uns["gene_rv_filter"] = {g: uns["gene_rv_filter"][g][given]
                                 for g in groups}
        adata._inplace_subset_var(given)

    if not inplace:
        return adata


def ht_1d_moments(
    adata,
    covariate,
    treatment,
    treatment_for_gene=None,
    inplace=True,
    num_boot=10000,
    verbose=1,
    num_cpus=1,  # accepted for API parity; execution is device-parallel
    resampling="bootstrap",
    approx=False,
    resample_rep=False,
    sampler="auto",
    tile_size=None,
    seed=0,
    checkpoint_dir=None,
    device=None,
    **kwargs,
):
    """Differential mean / variability tests for every gene.

    ``covariate`` and ``treatment`` are per-group tables aligned to
    ``uns['memento']['groups']``: ColumnTables, anything with
    ``.values``/``.columns`` (a pandas DataFrame), or 2-D arrays.  The tests
    run on ``device`` (default ``cuda``; ``'cpu'`` runs the plain tensor
    path on the CPU).
    """
    if treatment_for_gene is not None or checkpoint_dir is not None:
        raise NotImplementedError(
            "treatment_for_gene and checkpoint_dir are not ported yet")
    if not inplace:
        adata = adata.copy()
    uns = adata.uns["memento"]
    model = _model(uns)
    groups = uns["groups"]
    g = adata.n_vars

    true_mean = np.stack([uns["1d_moments"][grp][0] for grp in groups])
    true_res_var = np.stack([uns["1d_moments"][grp][2] for grp in groups])
    mv_coeffs = np.stack([np.asarray(uns["mv_regressor"][grp], np.float64)
                          for grp in groups])
    q = np.array([uns["group_q"][grp] for grp in groups])
    cov_values, _ = _table_values(covariate)
    treat_values, _ = _table_values(treatment)

    res = run_ht_1d(
        seed=fold_seed(seed, 0),  # gene block start 0
        groups=[uns["group_cells"][grp] for grp in groups],
        approx_sf=[uns["approx_size_factor"][grp] for grp in groups],
        true_mean=true_mean,
        true_res_var=true_res_var,
        mv_coeffs=mv_coeffs,
        q=q,
        covariate=cov_values,
        treatment=treat_values,
        num_boot=num_boot,
        model=model,
        sampler=sampler,
        resampling=resampling,
        approx=approx,
        resample_rep=resample_rep,
        tile_size=tile_size,
        verbose=verbose > 0,
        device=device,
    )

    # [G, Kt] results -> flat per-test arrays, gene-major
    kt = treat_values.shape[1]
    key_map = {"mean_asl": "mean_pval", "var_asl": "var_pval"}
    uns["1d_ht"] = {"treatment": treatment, "covariate": covariate}
    for name in ["mean_coef", "mean_se", "mean_asl", "var_coef", "var_se",
                 "var_asl"]:
        src = np.broadcast_to(res[key_map.get(name, name)], (g, kt))
        uns["1d_ht"][name] = np.array(src, dtype=np.float64).reshape(-1)
    if not inplace:
        return adata


def get_1d_moments(adata, groupby=None):
    """Per-group log mean and log residual variance tables (and cell counts
    per group), or their cell-weighted averages over the values of
    ``groupby`` (``'ALL'`` for every group)."""
    uns = adata.uns["memento"]
    genes = np.asarray(adata.var.index)
    moment_mean = ColumnTable({"gene": genes})
    moment_var = ColumnTable({"gene": genes})
    cell_counts = {k: v.shape[0] for k, v in uns["group_cells"].items()}
    with np.errstate(divide="ignore", invalid="ignore"):
        for group, val in uns["1d_moments"].items():
            if group == "all":
                continue
            moment_mean[group] = np.log(val[0])
            moment_var[group] = np.log(val[2])

    if groupby is None:
        return moment_mean, moment_var, cell_counts

    if groupby != "ALL":
        labels = np.asarray(adata.obs[groupby]).astype(str)
        _, first = np.unique(labels, return_index=True)
        unique_groupby = labels[np.sort(first)]
    else:
        unique_groupby = ["sg"]

    groupby_mean = ColumnTable({"gene": genes})
    groupby_var = ColumnTable({"gene": genes})
    for key in unique_groupby:
        gm = gv = 0
        gmc = gvc = 0
        with np.errstate(divide="ignore", invalid="ignore"):
            for group, val in uns["1d_moments"].items():
                if group == "all" or key not in group:
                    continue
                m = np.log(val[0])
                v = np.log(val[2])
                m[np.isnan(m)] = 0
                v[np.isnan(v)] = 0
                gm = gm + m * cell_counts[group]
                gmc = gmc + (val[0] > 0) * cell_counts[group]
                gv = gv + v * cell_counts[group]
                gvc = gvc + (val[2] > 0) * cell_counts[group]
            groupby_mean[groupby + "_" + key] = gm / gmc
            groupby_var[groupby + "_" + key] = gv / gvc
    return groupby_mean, groupby_var


def get_1d_ht_result(adata) -> ColumnTable:
    """1D test results: one row per (gene, treatment column) with columns
    ``gene, tx, de_coef, de_se, de_pval, dv_coef, dv_se, dv_pval``."""
    uns = adata.uns["memento"]
    ht = uns["1d_ht"]
    _, tx_names = _table_values(ht["treatment"])
    genes = np.asarray(adata.var.index)
    return ColumnTable({
        "gene": np.repeat(genes, len(tx_names)),
        "tx": np.tile(np.asarray(tx_names), len(genes)),
        "de_coef": ht["mean_coef"],
        "de_se": ht["mean_se"],
        "de_pval": ht["mean_asl"],
        "dv_coef": ht["var_coef"],
        "dv_se": ht["var_se"],
        "dv_pval": ht["var_asl"],
    })
