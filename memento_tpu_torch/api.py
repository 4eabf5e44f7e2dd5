"""Public API of the port.

Counterpart of ``memento_tpu/api.py``: the differential mean / variability
test, ``setup_memento -> create_groups -> compute_1d_moments ->
ht_1d_moments -> get_1d_ht_result`` (plus ``get_groups`` and
``get_1d_moments``); the differential correlation test on gene pairs,
``compute_2d_moments -> ht_2d_moments -> get_2d_ht_result`` (plus
``get_2d_moments``); and ``get_corr_matrix``.  All run over the pandas-free
``containers.AnnData`` with the same ``adata.uns['memento']`` keys as the
JAX package.  Tables come back as ``ColumnTable``s with the JAX DataFrames'
column names and order.

Host stages are float64, through the native C++ layer (``native/``) where
the JAX package takes it, else numpy/scipy; the tests and the correlation
matrix run on the device given to ``ht_1d_moments`` / ``ht_2d_moments`` /
``get_corr_matrix`` (default ``cuda``).

Every option of the JAX package's tests is here: every sampler, custom
``(fn_1d, fn_cov)`` estimator tuples (the reference's calling convention),
per-gene and per-pair treatments (``treatment_for_gene``, eQTL mode),
block-wise checkpoint/resume (``checkpoint_dir``), a ``mesh`` of devices
(a tuple of ``torch.device``s, ``parallel/mesh.py``: tiles round-robin over
it, the correlation matrix split over it; the moments stay the native host
pass) and ``distributed=True`` in a ``torch.distributed`` process group
(``parallel/distributed.py``).  ``prepare_to_save`` makes
``uns['memento']`` serializable.

Every public call is a request of ``utils/profiling``: a root span named
after the function with a new request id, whose child spans
(``<function>.<stage>``) cover its host stages one stretch of code each.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import warnings

import numpy as np
import scipy.sparse as sparse

from . import native
from .containers import ColumnTable
from .device import fold_seed
from .inference.ht import run_ht_1d, run_ht_2d
from .ops import estimators as est
from .ops.corr import corr_matrix_device, cov_sparse_pairs
from .ops.mv_regression import fit_mv_regressor
from .ops.size_factor import bin_size_factor, estimate_size_factor
from .parallel.mesh import as_mesh
from .utils import profiling
from .utils.blocks import run_blocks

__all__ = [
    "setup_memento",
    "create_groups",
    "get_groups",
    "compute_1d_moments",
    "ht_1d_moments",
    "get_1d_moments",
    "get_1d_ht_result",
    "get_corr_matrix",
    "compute_2d_moments",
    "ht_2d_moments",
    "get_2d_moments",
    "get_2d_ht_result",
    "prepare_to_save",
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


def _obs_mean(X):
    """Per-gene observed mean: one native pass over a CSR matrix (no extra
    scipy pass over the whole matrix), else scipy's mean."""
    if sparse.issparse(X) and X.format == "csr":
        res = native.col_sums_csr_native(X)
        if res is not None:
            return res[0] / X.shape[0]
    return np.asarray(X.mean(axis=0)).ravel()


def _require_model(uns):
    """``(model, custom_1d)``: the registry model and None, or, for a custom
    ``(fn_1d, fn_cov)`` tuple, ``HYPER_RELATIVE`` (unused on the custom
    path) and ``fn_1d``."""
    et = uns["estimator_type"]
    model = est.get_noise_model(et)
    if model is None:
        return est.HYPER_RELATIVE, et[0]
    return model, None


def _observed_moments(uns, X, n_obs, q, size_factor):
    """Observed ``[mean, var]`` per gene: the registry model's, or a custom
    tuple's ``fn_1d`` on the sparse matrix (the reference's convention)."""
    et = uns["estimator_type"]
    model = est.get_noise_model(et)
    if model is None:
        m, v = et[0](data=X.tocsc(), n_obs=n_obs, q=q,
                     size_factor=size_factor)[:2]
    else:
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


@profiling.traced
def setup_memento(
    adata,
    q_column,
    inplace=True,
    filter_mean_thresh=0.07,
    trim_percent=0.1,
    shrinkage=0.5,
    num_bins=30,
    estimator_type="hyper_relative",
    mesh=None,
):
    """Size factors and the overall mean-variance regressor.

    ``mesh`` (a tuple of devices) is taken for the JAX package's signature
    and checked, but the moments stay the native host float64 pass with or
    without one: streaming the cells through a mesh
    (``parallel.streaming.stream_mean_var``, the same sums) took 2.1-2.4 s
    where the native pass took 0.026 s, on 200,000 x 1,024 cells with one
    H100 (``chip_smoke.py`` phase (i2))."""
    with profiling.phase("setup_memento.layout"):
        if mesh is not None:
            as_mesh(mesh)
        if not inplace:
            adata = adata.copy()

        q_all = np.asarray(adata.obs[q_column], dtype=np.float64)
        if not q_all.max() < 1:
            raise ValueError(
                f"capture efficiencies in {q_column!r} must be < 1")
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
    with profiling.phase("setup_memento.size_factor"):
        naive_sf = estimate_size_factor(adata.X, estimator_type, total=True,
                                        shrinkage=0.0)
    with profiling.phase("setup_memento.moments"):
        all_m, all_v = est.mean_var_sparse(adata.X, naive_sf, uns["all_q"],
                                           "hyper_relative")
        obs_mean = _obs_mean(adata.X)
    with profiling.phase("setup_memento.fit"):
        all_m = np.asarray(all_m).copy()
        all_m[obs_mean < filter_mean_thresh] = 0  # mean filter
        all_res_var = _residual_variance_np(all_m, all_v,
                                            fit_mv_regressor(all_m, all_v))

        # least-variable genes for normalization; with no finite residual
        # variance (degenerate tiny inputs) take every expressed gene
        finite_rv = all_res_var[np.isfinite(all_res_var)]
        if finite_rv.size:
            rv_ulim = np.quantile(finite_rv, trim_percent)
            all_res_var = np.where(np.isfinite(all_res_var), all_res_var,
                                   np.inf)
            mask = all_res_var < rv_ulim
        else:
            mask = obs_mean > 0
        if not mask.any():
            mask = obs_mean > 0
        uns["least_variable_genes"] = adata.var.index[mask].tolist()

    # masked + shrunk size factor; zero-total cells get the smallest factor
    with profiling.phase("setup_memento.size_factor"):
        size_factor = estimate_size_factor(adata.X, estimator_type, mask=mask,
                                           shrinkage=shrinkage)
        if np.any(size_factor <= 0):
            floor = size_factor[size_factor > 0].min() \
                if (size_factor > 0).any() else 1.0
            size_factor = np.where(size_factor > 0, size_factor, floor)
        adata.obs["memento_size_factor"] = size_factor

    with profiling.phase("setup_memento.moments"):
        uns["all_1d_moments"] = _observed_moments(
            uns, adata.X, adata.shape[0], uns["all_q"], size_factor)
    if not inplace:
        return adata


@profiling.traced
def create_groups(adata, label_columns, label_delimiter="^", inplace=True):
    """Discrete cell groups from obs columns (``sg^<col1>^<col2>...``)."""
    with profiling.phase("create_groups.labels"):
        if not inplace:
            adata = adata.copy()

        labels = np.full(adata.n_obs, "sg" + label_delimiter, dtype=object)
        for idx, col in enumerate(label_columns):
            labels = labels + np.asarray(adata.obs[col]).astype(str).astype(
                object)
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

    with profiling.phase("create_groups.split"):
        # each group's rows gathered from the CSR matrix, in their order:
        # a pass over the group's own nonzeros (a row mask of a CSC matrix
        # passes over all of them, once a group)
        names, code = np.unique(labels, return_inverse=True)
        order = np.argsort(code, kind="stable")
        bounds = np.searchsorted(code[order], np.arange(len(names) + 1))
        rows = {g: order[lo:hi]
                for g, lo, hi in zip(names, bounds[:-1], bounds[1:])}
        X = adata.X.tocsr()
        q = np.asarray(uns["q"], dtype=np.float64)
        uns["group_cells"] = {g: X[rows[g]].tocsc() for g in uns["groups"]}
        uns["group_q"] = {g: float(q[rows[g]].mean()) for g in uns["groups"]}
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


@profiling.traced
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


@profiling.traced
def compute_1d_moments(adata, inplace=True, min_perc_group=0.7,
                       filter_genes=True, gene_list=None, mesh=None):
    """Mean, variance and residual variance per group.  ``mesh`` is checked
    and otherwise changes nothing, as in ``setup_memento``."""
    with profiling.phase("compute_1d_moments.sf_bins"):
        if mesh is not None:
            as_mesh(mesh)
        if "memento" not in adata.uns:
            raise ValueError("run setup_memento first")
        if not inplace:
            adata = adata.copy()
        uns = adata.uns["memento"]

        if "size_factor" not in uns:
            _bin_size_factor_uns(adata)

    groups = uns["groups"]
    with profiling.phase("compute_1d_moments.observed"):
        uns["1d_moments"] = {
            g: _observed_moments(uns, uns["group_cells"][g],
                                 uns["group_cells"][g].shape[0],
                                 uns["group_q"][g], uns["size_factor"][g])
            for g in groups
        }

    with profiling.phase("compute_1d_moments.filter"):
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
        with profiling.phase("compute_1d_moments.subset"):
            uns["group_cells"] = {
                g: uns["group_cells"][g][:, overall_gene_mask]
                for g in groups}
            uns["1d_moments"] = {
                g: [uns["1d_moments"][g][0][overall_gene_mask],
                    uns["1d_moments"][g][1][overall_gene_mask]]
                for g in groups
            }
            uns["gene_rv_filter"] = {
                g: uns["gene_rv_filter"][g][overall_gene_mask]
                for g in groups}
            adata._inplace_subset_var(overall_gene_mask)

    # one shared mv-regressor fit on the concatenated filtered moments
    with profiling.phase("compute_1d_moments.fit"):
        mean_concat = np.concatenate(
            [uns["1d_moments"][g][0][uns["gene_rv_filter"][g]]
             for g in groups])
        var_concat = np.concatenate(
            [uns["1d_moments"][g][1][uns["gene_rv_filter"][g]]
             for g in groups])
        shared_fit = fit_mv_regressor(mean_concat, var_concat)
        uns["mv_regressor"] = {"all": shared_fit}
        for g in groups:
            uns["mv_regressor"][g] = shared_fit

        for g in groups:
            uns["1d_moments"][g].append(_residual_variance_np(
                uns["1d_moments"][g][0], uns["1d_moments"][g][1],
                uns["mv_regressor"][g]))

    if gene_list is not None:
        with profiling.phase("compute_1d_moments.subset"):
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


# Rows of the Gram matrix finished at a time on the host by
# ``get_corr_matrix`` (the mesh path's default too).  Finished whole, a
# 20,000-gene matrix held 33 GiB of host memory for its 3.2 GB of float64
# output (``chip_smoke.py`` phase (k3)); in slices the temporaries are those
# of one slice.
CORR_ROW_BLOCK = 4096


@profiling.traced
def get_corr_matrix(adata, group, mesh=None, device=None):
    """All-by-all ``[G, G]`` correlation matrix of one group, as blocked
    float32 matrix products on ``device`` (default ``cuda``) finished in
    host float64 in slices of ``CORR_ROW_BLOCK`` rows; with ``mesh`` (a
    tuple of devices) the Gram matrix's columns are split over its devices
    (``parallel.sharded.corr_matrix_sharded``)."""
    uns = adata.uns["memento"]
    model = est.get_noise_model(uns["estimator_type"])
    if model is None:
        raise NotImplementedError(
            "get_corr_matrix requires a registry estimator_type")
    args = (uns["group_cells"][group], uns["size_factor"][group],
            uns["group_q"][group], uns["1d_moments"][group][1], model)
    if mesh is not None:
        from .parallel.sharded import corr_matrix_sharded

        return corr_matrix_sharded(mesh, *args, row_block=CORR_ROW_BLOCK)
    return corr_matrix_device(*args, row_block=CORR_ROW_BLOCK, device=device)


def _corr_from_cov_np(cov, var_1, var_2):
    """Host covariance -> correlation with the sentinel semantics of
    ``ops.estimators.corr_from_cov``: an entry with a non-positive or NaN
    variance comes out as 1.0 (not NaN); |corr| == 1 is invalid downstream."""
    invalid = ~(var_1 > 0) | ~(var_2 > 0)
    with np.errstate(invalid="ignore", divide="ignore"):
        corr = cov / np.sqrt(np.where(invalid, 1.0, var_1)
                             * np.where(invalid, 1.0, var_2))
    return np.where(invalid, 1.0, np.clip(corr, -1.0, 1.0))


@profiling.traced
def compute_2d_moments(adata, gene_pairs, inplace=True):
    """Observed covariance and correlation of each ``(gene_1, gene_2)`` name
    pair in every group (a custom tuple's ``fn_cov`` on the sparse matrix,
    with ``idx1``/``idx2``, for a custom estimator)."""
    with profiling.phase("compute_2d_moments.cov"):
        if not inplace:
            adata = adata.copy()
        uns = adata.uns["memento"]
        if "size_factor" not in uns:
            _bin_size_factor_uns(adata)
        et = uns["estimator_type"]
        model = est.get_noise_model(et)

        mapping = {name: i for i, name in enumerate(adata.var.index)}
        idx1 = np.array([mapping[a] for a, _ in gene_pairs], dtype=int)
        idx2 = np.array([mapping[b] for _, b in gene_pairs], dtype=int)
        uns["2d_moments"] = {"gene_pairs": gene_pairs, "gene_idx_1": idx1,
                             "gene_idx_2": idx2}

        covs = {}
        for g in uns["groups"]:
            cells = uns["group_cells"][g]
            if model is None:
                covs[g] = np.asarray(et[1](
                    data=cells.tocsc(), n_obs=cells.shape[0],
                    q=uns["group_q"][g], size_factor=uns["size_factor"][g],
                    idx1=idx1, idx2=idx2))
            else:
                sf = uns["size_factor"][g] if model.relative \
                    else np.ones(cells.shape[0])
                covs[g] = cov_sparse_pairs(cells, sf, uns["group_q"][g], idx1,
                                           idx2, model)

    with profiling.phase("compute_2d_moments.corr"):
        for g, cov in covs.items():
            var_1 = uns["1d_moments"][g][1][idx1]
            var_2 = uns["1d_moments"][g][1][idx2]
            uns["2d_moments"][g] = {
                "cov": cov, "corr": _corr_from_cov_np(cov, var_1, var_2),
                "var_1": var_1, "var_2": var_2}
    if not inplace:
        return adata


def _ckpt_meta(uns, item_key: str, seed, num_boot, resampling, approx):
    """Run fingerprint stored in checkpoint blocks: a resumed block from a
    different dataset, item list, seed or bootstrap setting raises."""
    h = hashlib.sha256()
    h.update(item_key.encode())
    h.update(",".join(map(str, uns["groups"])).encode())
    h.update(str([uns["group_cells"][g].shape
                  for g in uns["groups"]]).encode())
    return {
        "seed": int(seed),
        "num_boot": int(num_boot),
        "resampling": str(resampling),
        "approx": bool(approx),
        "data": h.hexdigest()[:16],
    }


def _per_item_treatment(treatment, treatment_for_item, keys, n_groups):
    """Zero-padded per-item treatments ``[I, R, Kmax]`` and the number of
    tested columns of each item, from ``treatment_for_item[key]`` (the
    treatment column names of that gene or gene pair); a key or a column
    name that is not there raises ``KeyError`` naming it."""
    values, names = _table_values(treatment)
    column = {name: j for j, name in enumerate(names)}
    kmax = max(len(v) for v in treatment_for_item.values())
    tens = np.zeros((len(keys), n_groups, kmax))
    nt = np.zeros(len(keys), dtype=int)
    for i, key in enumerate(keys):
        cols = [column[c] for c in treatment_for_item[key]]
        nt[i] = len(cols)
        tens[i, :, :nt[i]] = values[:, cols]
    return tens, nt


def _distributed_checkpoint(checkpoint_dir, distributed):
    """``(directory, resume_filter)`` of a checkpointed run.

    With ``distributed=True`` in a process group of more than one process,
    each process writes its blocks into its own ``proc{rank}/`` (no two
    processes write one file; every process holds each block's merged
    result, so each copy is whole), and a block is resumed only if every
    process has it: an all-reduced intersection of the have-vectors.  A
    block that any process lacks is then recomputed by all of them, so all
    stay in the same collectives (the row merge of each block)."""
    from .parallel.distributed import (allreduce_hostsums, process_count,
                                       process_index)

    nproc = process_count() if distributed else 1
    if nproc <= 1:
        return checkpoint_dir, None

    def resume_filter(have):
        total = allreduce_hostsums(np.asarray(have, np.float64))[0]
        return np.rint(total) >= nproc

    return os.path.join(checkpoint_dir, f"proc{process_index()}"), \
        resume_filter


def _run_items(n_items, run_block, checkpoint_dir, checkpoint_block, name,
               verbose, meta, distributed):
    """All items in one block, or in checkpointed blocks of
    ``checkpoint_block``; block ``b``'s seed folds its start (the caller's
    ``run_block``), so a resumed run equals an uninterrupted one."""
    if checkpoint_dir is None:
        return run_block(0, n_items)
    ckpt_dir, resume_filter = _distributed_checkpoint(checkpoint_dir,
                                                      distributed)
    return run_blocks(n_items, checkpoint_block, run_block,
                      checkpoint_dir=ckpt_dir, name=name,
                      verbose=verbose, meta=meta(),
                      resume_filter=resume_filter)


@profiling.traced
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
    boot_chunk=1024,
    seed=0,
    checkpoint_dir=None,
    checkpoint_block=4096,
    mesh=None,
    distributed=False,
    device=None,
    **kwargs,
):
    """Differential mean / variability tests for every gene.

    ``covariate`` and ``treatment`` are per-group tables aligned to
    ``uns['memento']['groups']``: ColumnTables, anything with
    ``.values``/``.columns`` (a pandas DataFrame), or 2-D arrays.
    ``treatment_for_gene`` optionally maps each gene name to the treatment
    columns tested for it (eQTL mode).  With ``checkpoint_dir``, genes run in
    blocks of ``checkpoint_block`` saved as ``.npz``; a later call resumes at
    the first missing block.  The tests run on ``device`` (default ``cuda``;
    ``'cpu'`` runs the plain tensor path on the CPU), or with ``mesh`` (a
    tuple of devices) round-robin over its devices.  With
    ``distributed=True`` in a ``torch.distributed`` process group each
    process runs its share of the gene tiles and every process gets the
    whole result (the default device is then the process's own card,
    ``cuda:{LOCAL_RANK % device_count}``); checkpoint blocks then go to
    ``checkpoint_dir/proc{rank}/``.
    """
    if not inplace:
        adata = adata.copy()
    uns = adata.uns["memento"]
    model, custom_1d = _require_model(uns)
    groups = uns["groups"]
    gene_names = np.asarray(adata.var.index)
    g = len(gene_names)

    true_mean = np.stack([uns["1d_moments"][grp][0] for grp in groups])
    true_res_var = np.stack([uns["1d_moments"][grp][2] for grp in groups])
    mv_coeffs = np.stack([np.asarray(uns["mv_regressor"][grp], np.float64)
                          for grp in groups])
    q = np.array([uns["group_q"][grp] for grp in groups])
    cov_values, _ = _table_values(covariate)
    with profiling.phase("ht_1d_moments.treatment"):
        if treatment_for_gene is None:
            treat_arg, tx_names = _table_values(treatment)
            nt_per_gene = np.full(g, len(tx_names))
        else:
            treat_arg, nt_per_gene = _per_item_treatment(
                treatment, treatment_for_gene, gene_names, len(groups))
    profiling.count("ht1d.treat_cols", g * treat_arg.shape[-1])
    profiling.count("ht1d.tests", int(nt_per_gene.sum()))

    def run_gene_block(start, stop):
        sl = slice(start, stop)
        full = start == 0 and stop == g  # no column copy for one block
        return run_ht_1d(
            seed=fold_seed(seed, start),
            groups=[uns["group_cells"][grp] if full
                    else uns["group_cells"][grp][:, sl] for grp in groups],
            approx_sf=[uns["approx_size_factor"][grp] for grp in groups],
            true_mean=true_mean[:, sl],
            true_res_var=true_res_var[:, sl],
            mv_coeffs=mv_coeffs,
            q=q,
            covariate=cov_values,
            treatment=treat_arg[sl] if treat_arg.ndim == 3 else treat_arg,
            num_boot=num_boot,
            model=model,
            sampler=sampler,
            resampling=resampling,
            approx=approx,
            resample_rep=resample_rep,
            tile_size=tile_size,
            boot_chunk=boot_chunk,
            verbose=verbose > 0,
            custom_1d=custom_1d,
            mesh=mesh,
            distributed=distributed,
            device=device,
        )

    res = _run_items(
        g, run_gene_block, checkpoint_dir, checkpoint_block, "1d_ht",
        verbose > 0, lambda: _ckpt_meta(uns, ",".join(map(str, gene_names)),
                                        seed, num_boot, resampling, approx),
        distributed)

    # [G, Kt] results -> flat per-test arrays, gene-major, each gene's
    # tested columns only
    tested = np.arange(treat_arg.shape[-1])[None, :] < nt_per_gene[:, None]
    key_map = {"mean_asl": "mean_pval", "var_asl": "var_pval"}
    uns["1d_ht"] = {}
    if treatment_for_gene is not None:
        uns["1d_ht"]["treatment_for_gene"] = treatment_for_gene
    uns["1d_ht"].update(treatment=treatment, covariate=covariate)
    for name in ["mean_coef", "mean_se", "mean_asl", "var_coef", "var_se",
                 "var_asl"]:
        uns["1d_ht"][name] = np.asarray(res[key_map.get(name, name)],
                                        dtype=np.float64)[tested]
    if not inplace:
        return adata


@profiling.traced
def ht_2d_moments(
    adata,
    covariate,
    treatment,
    treatment_for_gene=None,
    inplace=True,
    num_boot=10000,
    verbose=3,
    num_cpus=1,  # accepted for API parity; execution is device-parallel
    resampling="bootstrap",
    approx=False,
    resample_rep=False,
    sampler="auto",
    tile_size=None,
    boot_chunk=1024,
    seed=0,
    checkpoint_dir=None,
    checkpoint_block=4096,
    mesh=None,
    distributed=False,
    device=None,
    **kwargs,
):
    """Differential correlation tests for the pairs of
    ``compute_2d_moments``.

    Unordered duplicates of a pair are tested once and every duplicate row
    gets the result; a pair of a gene with itself is skipped (NaN).  The
    result holds one statistic per pair: of a treatment with several columns
    only the first is tested.  ``treatment_for_gene`` maps the unordered
    gene-name pair (a ``frozenset``) to its treatment columns, of which the
    first is reported.  Checkpoint blocks run over the deduplicated pairs.
    ``covariate``, ``treatment``, ``checkpoint_*``, ``mesh``,
    ``distributed`` and ``device`` as in ``ht_1d_moments``.
    """
    if not inplace:
        adata = adata.copy()
    uns = adata.uns["memento"]
    model, custom_1d = _require_model(uns)
    custom_est = (custom_1d, uns["estimator_type"][1]) \
        if custom_1d is not None else None
    groups = uns["groups"]

    gene_idx_1 = uns["2d_moments"]["gene_idx_1"]
    gene_idx_2 = uns["2d_moments"]["gene_idx_2"]
    n_conv = gene_idx_1.shape[0]

    # dedup unordered pairs; skip self-pairs
    idx_mapping = {}
    uniq_pairs = []  # (idx1, idx2, first row that names the pair)
    for conv_idx in range(n_conv):
        i1, i2 = int(gene_idx_1[conv_idx]), int(gene_idx_2[conv_idx])
        if i1 == i2:
            continue
        key = frozenset((i1, i2))
        if key in idx_mapping:
            idx_mapping[key].append(conv_idx)
            continue
        idx_mapping[key] = [conv_idx]
        uniq_pairs.append((i1, i2, conv_idx))

    out = {name: np.full(n_conv, np.nan)
           for name in ("corr_coef", "corr_se", "corr_asl")}
    if uniq_pairs:
        p_idx1 = np.array([pair[0] for pair in uniq_pairs])
        p_idx2 = np.array([pair[1] for pair in uniq_pairs])
        conv_of_pair = [pair[2] for pair in uniq_pairs]
        true_corr = np.stack([uns["2d_moments"][grp]["corr"][conv_of_pair]
                              for grp in groups])
        cov_values, _ = _table_values(covariate)
        if treatment_for_gene is not None:
            # keyed by the unordered gene-name pair
            names = np.asarray(adata.var.index)
            treat_arg, _ = _per_item_treatment(
                treatment, treatment_for_gene,
                [frozenset((names[i1], names[i2]))
                 for i1, i2, _ in uniq_pairs], len(groups))
        else:
            treat_arg, _ = _table_values(treatment)
            if treat_arg.shape[1] > 1:
                # the regression treats columns independently, so column
                # 0's coefficient, SE and p-value do not depend on the others
                warnings.warn(
                    f"ht_2d_moments received a {treat_arg.shape[1]}-column "
                    "treatment but the 2D result reports only the FIRST "
                    "treatment column; run it once per column",
                    UserWarning, stacklevel=2)
                treat_arg = treat_arg[:, :1]

        def run_pair_block(start, stop):
            sl = slice(start, stop)
            return run_ht_2d(
                seed=fold_seed(seed, start),
                groups=[uns["group_cells"][grp] for grp in groups],
                approx_sf=[uns["approx_size_factor"][grp] for grp in groups],
                idx1=p_idx1[sl],
                idx2=p_idx2[sl],
                true_corr=true_corr[:, sl],
                q=np.array([uns["group_q"][grp] for grp in groups]),
                covariate=cov_values,
                treatment=treat_arg[sl] if treat_arg.ndim == 3 else treat_arg,
                num_boot=int(num_boot),
                model=model,
                sampler=sampler,
                resampling=resampling,
                approx=approx,
                resample_rep=resample_rep,
                tile_size=tile_size,
                boot_chunk=boot_chunk,
                verbose=verbose > 0,
                custom_est=custom_est,
                mesh=mesh,
                distributed=distributed,
                device=device,
            )

        res = _run_items(
            len(uniq_pairs), run_pair_block, checkpoint_dir, checkpoint_block,
            "2d_ht", verbose > 0, lambda: _ckpt_meta(
                uns, ",".join(f"{a}:{b}" for a, b, _ in uniq_pairs), seed,
                num_boot, resampling, approx), distributed)
        # broadcast each unique pair's result to all its duplicates
        for u, (i1, i2, _) in enumerate(uniq_pairs):
            rows = idx_mapping[frozenset((i1, i2))]
            out["corr_coef"][rows] = res["corr_coef"][u, 0]
            out["corr_se"][rows] = res["corr_se"][u, 0]
            out["corr_asl"][rows] = res["corr_pval"][u, 0]

    uns["2d_ht"] = {}
    if treatment_for_gene is not None:
        uns["2d_ht"]["treatment_for_gene"] = treatment_for_gene
    uns["2d_ht"].update(treatment=treatment, covariate=covariate, **out)
    if not inplace:
        return adata


def _groupby_keys(adata, groupby):
    """The values of obs column ``groupby`` in order of appearance, as
    strings (``'ALL'``: the prefix every group label shares)."""
    if groupby == "ALL":
        return ["sg"]
    labels = np.asarray(adata.obs[groupby]).astype(str)
    _, first = np.unique(labels, return_index=True)
    return labels[np.sort(first)]


@profiling.traced
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

    groupby_mean = ColumnTable({"gene": genes})
    groupby_var = ColumnTable({"gene": genes})
    for key in _groupby_keys(adata, groupby):
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


@profiling.traced
def get_1d_ht_result(adata) -> ColumnTable:
    """1D test results: one row per (gene, treatment column) with columns
    ``gene, tx, de_coef, de_se, de_pval, dv_coef, dv_se, dv_pval``; with
    ``treatment_for_gene``, each gene's own columns."""
    uns = adata.uns["memento"]
    ht = uns["1d_ht"]
    genes = np.asarray(adata.var.index)
    if "treatment_for_gene" in ht:
        tx = [list(ht["treatment_for_gene"][gene]) for gene in genes]
    else:
        tx = [_table_values(ht["treatment"])[1]] * len(genes)
    return ColumnTable({
        "gene": np.repeat(genes, [len(cols) for cols in tx]),
        "tx": np.array([c for cols in tx for c in cols]),
        "de_coef": ht["mean_coef"],
        "de_se": ht["mean_se"],
        "de_pval": ht["mean_asl"],
        "dv_coef": ht["var_coef"],
        "dv_se": ht["var_se"],
        "dv_pval": ht["var_asl"],
    })


def _pair_table(uns) -> ColumnTable:
    pairs = uns["2d_moments"]["gene_pairs"]
    return ColumnTable({"gene_1": np.array([a for a, _ in pairs]),
                        "gene_2": np.array([b for _, b in pairs])})


@profiling.traced
def get_2d_moments(adata, groupby=None):
    """Per-group observed correlations of every pair (and cell counts per
    group), or their cell-weighted averages over the values of ``groupby``
    (``'ALL'`` for every group)."""
    uns = adata.uns["memento"]
    cell_counts = {k: v.shape[0] for k, v in uns["group_cells"].items()}
    group_corr = {group: val["corr"]
                  for group, val in uns["2d_moments"].items()
                  if isinstance(group, str) and "sg^" in group}

    if groupby is None:
        moment_corr = _pair_table(uns)
        for group, corr in group_corr.items():
            moment_corr[group] = corr
        return moment_corr, cell_counts

    groupby_corr = _pair_table(uns)
    for key in _groupby_keys(adata, groupby):
        gc = gcc = 0
        for group, corr in group_corr.items():
            if key not in group:
                continue
            c = np.array(corr, dtype=float)
            valid = ~np.isnan(c)
            c[~valid] = 0
            gc = gc + c * cell_counts[group]
            gcc = gcc + valid * cell_counts[group]
        with np.errstate(divide="ignore", invalid="ignore"):
            groupby_corr[groupby + "_" + key] = gc / gcc
    return groupby_corr


@profiling.traced
def get_2d_ht_result(adata) -> ColumnTable:
    """2D test results: one row per pair with columns ``gene_1, gene_2,
    corr_coef, corr_se, corr_pval``."""
    uns = adata.uns["memento"]
    result = _pair_table(uns)
    result["corr_coef"] = uns["2d_ht"]["corr_coef"]
    result["corr_se"] = uns["2d_ht"]["corr_se"]
    result["corr_pval"] = uns["2d_ht"]["corr_asl"]
    return result


@profiling.traced
def prepare_to_save(adata, keep=False):
    """Make ``uns['memento']`` serializable: drop the mv-regressor fits, or
    with ``keep`` store each as the string of its pickle."""
    uns = adata.uns["memento"]
    for group in uns["groups"] + ["all"]:
        if not keep:
            del uns["mv_regressor"][group]
        else:
            uns["mv_regressor"][group] = str(
                pickle.dumps(uns["mv_regressor"][group]))
