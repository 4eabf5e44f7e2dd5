"""What both request kinds share: the program's AnnData of a cell type, the
per-group design, the harness's spans and the reference's side of a check.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from . import compare, reference
from .data import derive


@contextlib.contextmanager
def span(spans: dict, name: str):
    """The harness's own span around a call into the program: its seconds
    into ``spans`` and a profiler range of the same name."""
    with torch.profiler.record_function(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0


def adata_of(program, ctype, genes, q: float):
    """A fresh AnnData of one cell type; the counts are shared, not
    copied (the program replaces, and does not write into, ``X``)."""
    obs = program.ColumnTable({
        "capture_q": np.full(ctype.n_cells, q),
        "condition": np.where(ctype.condition == 1, "stim", "ctrl"),
        "donor": np.array([f"d{k}" for k in ctype.donor]),
    })
    return program.AnnData(ctype.X, obs=obs,
                           var=program.ColumnTable(index=genes))


def design(program, adata):
    """Intercept covariate and the stimulated condition as treatment, one
    row per group, in the program's group order."""
    groups = program.get_groups(adata)
    covariate = program.ColumnTable({"intercept": np.ones(len(groups))},
                                    index=groups.index)
    treatment = program.ColumnTable(
        {"stim": (groups["condition"] == "stim").astype(np.float64)},
        index=groups.index)
    return covariate, treatment


def counters(program) -> dict:
    """The program's own counters, for the log."""
    from memento_tpu_torch.ops import cuda_kernels

    return {"cascade_launches": dict(cuda_kernels.LAUNCHES),
            "warm_launches": dict(cuda_kernels.WARM_LAUNCHES),
            "native_calls": {k: v for k, v in program.native.CALLS.items()
                             if v}}


# the random stream of the reference's replicates, and of the control's,
# which answers in the program's place and so draws its own
STREAMS = {"reference": 6, "control": 7}


def prepare(ctype, genes, q, config, traffic, precision):
    """The reference's set-up of one cell type, on the host (as the
    program's host stages are)."""
    reference.supported(config, traffic)
    return reference.prepare(
        ctype.X, ctype.condition, ctype.donor, q, genes,
        filter_mean_thresh=traffic["filter_mean_thresh"],
        host=reference.precisions(config)[precision]["host"], device="cpu")


def ref_design(prep):
    """The reference's covariate (none besides its intercept) and treatment
    per group."""
    treatment = np.array([float(c) for c, _ in prep.groups])
    return np.zeros((len(prep.groups), 0)), treatment


def as_table(items, results: dict) -> dict:
    """``compare.numbers``' form of reference results."""
    out = {"items": np.asarray(items)}
    for s, r in results.items():
        out[f"{s}_coef"], out[f"{s}_se"], out[f"{s}_pval"] = \
            r.coef, r.se, r.pval
    return out


def sample_records(records, n: int, seed: int, key=None) -> list:
    """Up to ``n`` completed requests drawn from ``seed``; with ``key``, the
    one of the largest key first."""
    done = [r for r in records if r.error is None]
    if not done:
        return []
    rng = np.random.default_rng(derive(seed, 5))
    first = max(done, key=key) if key else None
    rest = [r for r in done if r is not first]
    pick = list(rng.permutation(len(rest))[:max(0, n - (first is not None))])
    return ([first] if first else []) + [rest[i] for i in sorted(pick)]


def check(runner, records, checks, answer=None) -> dict:
    """Compare a sample of the window's requests with the reference.

    ``answer(request)``, where given, answers in the program's place (the
    control); otherwise each record's own result is judged."""
    tr = runner.traffic
    prep = runner.prepare("reference")
    per_request = []
    for rec in sample_records(records, tr["check_requests"], runner.seed,
                              key=runner.sample_key):
        table = runner.reference_results(rec.request, prep)
        got = rec.result if answer is None else answer(rec.request)
        per_request.append(compare.numbers(got, table, runner.STATS))
    out = compare.judge(per_request, checks["limits"])
    out["compared"] = len(per_request)
    return out


__all__ = ["STREAMS", "span", "adata_of", "design", "counters", "prepare",
           "ref_design", "as_table", "sample_records", "check"]
