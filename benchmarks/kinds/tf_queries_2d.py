"""Kind ``tf_queries_2d``: transcription-factor queries of the 2D test.

Set-up takes the largest cell type through
``setup_memento``, ``create_groups`` and ``compute_1d_moments``.  A query is
one TF against ``T`` targets: ``compute_2d_moments -> ht_2d_moments ->
get_2d_ht_result`` on the pairs (TF, target).  The TF and its targets are
drawn among the ``candidate_genes`` genes of the highest mean count (the
benchmark's own ranking of its counts).  The ``T`` of a cycle of ``cycle``
queries are fixed, log-spaced from ``targets_min`` to ``targets_max`` (the
midpoints of ``cycle`` equal slices of the log range); the seed draws the
genes and the order, so every seed runs the same sizes.  A run does whole
cycles, and a traced run profiles the first ``trace_queries`` queries.  Its
work is the pairs tested.  The traffic file's other parameters:
``filter_mean_thresh``, ``num_boot``, ``sampler``, ``resampling``,
``approx`` and ``check_requests`` (queries compared with the reference
after the window).
"""

from __future__ import annotations

import itertools

import numpy as np

from benchmarks import reference, session
from benchmarks.data import derive

STATS = ("dc",)


def cycle_sizes(traffic) -> np.ndarray:
    n = int(traffic["cycle"])
    lo, hi = np.log(traffic["targets_min"]), np.log(traffic["targets_max"])
    return np.rint(np.exp(lo + (np.arange(n) + 0.5) / n * (hi - lo))
                   ).astype(int)


def plan(dataset, traffic, seed):
    """The cell type of the queries and the cycle of queries, from the
    benchmark's own data: the candidates are the genes of the highest mean
    count in that type."""
    t = int(np.argmax([ct.n_cells for ct in dataset.types]))
    ctype = dataset.types[t]
    means = np.asarray(ctype.X.sum(0)).ravel() / ctype.n_cells
    top = np.argsort(-means, kind="stable")[:traffic["candidate_genes"]]
    cands = dataset.genes[np.sort(top)]
    rng = np.random.default_rng(derive(seed, 3))
    sizes = cycle_sizes(traffic)[rng.permutation(int(traffic["cycle"]))]
    queries = []
    for k, n_t in enumerate(sizes):
        tf = rng.integers(cands.size)
        others = np.delete(np.arange(cands.size), tf)
        targets = rng.choice(others, int(n_t), replace=False)
        queries.append({"query": k, "tf": cands[tf],
                        "targets": cands[targets]})
    return t, cands, queries


class Runner:
    kind = "2d"
    unit = "pairs"
    STATS = STATS

    def __init__(self, program, dataset, config, traffic, seed, device):
        self.program = program
        self.ds = dataset
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.config = config
        self.t, cands, self.queries = plan(dataset, traffic, seed)
        self.cycle = len(self.queries)
        self.prec = reference.precisions(config)
        self.adata = None
        if program is None:  # the reference's side only
            return
        p = program
        self.adata = session.adata_of(p, dataset.types[self.t],
                                      dataset.genes, dataset.q)
        p.setup_memento(self.adata, q_column="capture_q",
                        estimator_type=config["estimator"],
                        filter_mean_thresh=traffic["filter_mean_thresh"])
        p.create_groups(self.adata, label_columns=["condition", "donor"])
        p.compute_1d_moments(self.adata)
        self.covariate, self.treatment = session.design(p, self.adata)
        tested = set(np.asarray(self.adata.var.index))
        missing = [g for g in cands if g not in tested]
        if missing:
            raise RuntimeError(f"{len(missing)} candidate genes are not "
                               "tested by the program")

    def traced(self, index):
        """A traced run profiles the first ``trace_queries`` queries."""
        return index < self.traffic["trace_queries"]

    def requests(self):
        for i, q in enumerate(itertools.cycle(self.queries)):
            yield dict(q, seed=derive(self.seed, 2, i))

    def run(self, request, spans):
        p = self.program
        pairs = [(request["tf"], t) for t in request["targets"]]
        with session.span(spans, "api.compute_2d_moments"):
            p.compute_2d_moments(self.adata, pairs)
        with session.span(spans, "api.ht_2d_moments"):
            p.ht_2d_moments(self.adata, covariate=self.covariate,
                            treatment=self.treatment,
                            num_boot=self.traffic["num_boot"],
                            resampling=self.traffic["resampling"],
                            sampler=self.traffic["sampler"],
                            approx=self.traffic["approx"], verbose=0,
                            seed=request["seed"], device=self.device)
        with session.span(spans, "api.get_2d_ht_result"):
            res = p.get_2d_ht_result(self.adata)
        table = {"items": np.array([f"{a}:{b}" for a, b in
                                    zip(res["gene_1"], res["gene_2"])])}
        for k in ("coef", "se", "pval"):
            table[f"dc_{k}"] = np.asarray(res[f"corr_{k}"], np.float64)
        return table, len(pairs)

    def warm(self):
        """One query of the cycle's middle size, not counted."""
        q = sorted(self.queries, key=lambda q: q["targets"].size)[
            len(self.queries) // 2]
        self.run(dict(q, seed=derive(self.seed, 4)), {})

    def release(self):
        self.adata = None

    def counters(self):
        return session.counters(self.program)

    def reference_results(self, request, prep, precision="reference"):
        pos = {g: k for k, g in enumerate(prep.genes)}
        idx1 = np.array([pos[request["tf"]]] * request["targets"].size)
        idx2 = np.array([pos[g] for g in request["targets"]])
        covariate, treatment = session.ref_design(prep)
        dc = reference.test_2d(
            self.ds.types[self.t].X, prep, idx1, idx2, covariate, treatment,
            num_boot=self.traffic["num_boot"],
            seed=derive(request["seed"], session.STREAMS[precision]),
            device_dtype=self.prec[precision]["device"],
            device=self.device)
        items = [f"{request['tf']}:{g}" for g in request["targets"]]
        return session.as_table(items, {"dc": dc})

    def prepare(self, precision="reference"):
        return session.prepare(self.ds.types[self.t], self.ds.genes,
                               self.ds.q, self.config, self.traffic,
                               precision)

    def sample_key(self, record):
        return record.request["targets"].size

    def check(self, records, checks):
        return session.check(self, records, checks)
