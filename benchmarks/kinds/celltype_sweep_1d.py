"""Kind ``celltype_sweep_1d``: one request per cell type, the whole 1D
analysis on it.

A request runs ``setup_memento -> create_groups -> compute_1d_moments ->
ht_1d_moments -> get_1d_ht_result`` on a fresh AnnData of one cell type,
with groups of (condition, donor), an intercept covariate and the
stimulated condition as treatment.  The types come smallest first,
cycling; a run does whole sweeps, and a traced run profiles the largest
type of the first.  Its work is the result's rows: one test per gene and
treatment column, DE and DV together.

The traffic file's parameters: ``filter_mean_thresh``, ``num_boot``,
``sampler``, ``resampling``, ``approx`` and ``check_requests`` (requests
compared with the reference after the window).
"""

from __future__ import annotations

import itertools

import numpy as np

from benchmarks import reference, session
from benchmarks.data import derive

STATS = ("de", "dv")


class Runner:
    kind = "1d"
    unit = "tests"
    STATS = STATS

    def __init__(self, program, dataset, config, traffic, seed, device):
        self.program = program
        self.ds = dataset
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.device = device
        sizes = [t.n_cells for t in dataset.types]
        self.order = sorted(range(len(sizes)), key=lambda t: sizes[t])
        self.cycle = len(self.order)
        self.prec = reference.precisions(config)

    def traced(self, index):
        """A traced run profiles the largest type of the first sweep."""
        return index == self.cycle - 1

    def requests(self):
        for i, t in enumerate(itertools.cycle(self.order)):
            yield {"type": t, "seed": derive(self.seed, 2, i)}

    def run(self, request, spans):
        p = self.program
        tr = self.traffic
        adata = session.adata_of(p, self.ds.types[request["type"]],
                                 self.ds.genes, self.ds.q)
        with session.span(spans, "api.setup_memento"):
            p.setup_memento(adata, q_column="capture_q",
                            estimator_type=self.config["estimator"],
                            filter_mean_thresh=tr["filter_mean_thresh"])
        with session.span(spans, "api.create_groups"):
            p.create_groups(adata, label_columns=["condition", "donor"])
        with session.span(spans, "api.compute_1d_moments"):
            p.compute_1d_moments(adata)
        covariate, treatment = session.design(p, adata)
        with session.span(spans, "api.ht_1d_moments"):
            p.ht_1d_moments(adata, covariate=covariate, treatment=treatment,
                            num_boot=tr["num_boot"],
                            resampling=tr["resampling"], approx=tr["approx"],
                            sampler=tr["sampler"],
                            verbose=0, seed=request["seed"],
                            device=self.device)
        with session.span(spans, "api.get_1d_ht_result"):
            res = p.get_1d_ht_result(adata)
        table = {"items": np.asarray(res["gene"])}
        for s in STATS:
            for k in ("coef", "se", "pval"):
                table[f"{s}_{k}"] = np.asarray(res[f"{s}_{k}"], np.float64)
        return table, len(table["items"])

    def warm(self):
        """One request of the smallest type, not counted."""
        self.run({"type": self.order[0], "seed": derive(self.seed, 4)}, {})

    def release(self):
        pass  # a request's AnnData is freed when the request returns

    def counters(self):
        return session.counters(self.program)

    def prepare(self, precision="reference"):
        reference.supported(self.config, self.traffic)
        return None  # each request's cell type is prepared on its own

    def reference_results(self, request, prep=None, precision="reference"):
        """The reference's (or, with ``precision="control"``, the control's)
        results for ``request``, as ``compare.numbers`` takes them."""
        ctype = self.ds.types[request["type"]]
        prep = session.prepare(ctype, self.ds.genes, self.ds.q, self.config,
                               self.traffic, precision)
        covariate, treatment = session.ref_design(prep)
        de, dv = reference.test_1d(
            ctype.X, prep, covariate, treatment,
            num_boot=self.traffic["num_boot"],
            seed=derive(request["seed"], session.STREAMS[precision]),
            device_dtype=self.prec[precision]["device"],
            device=self.device)
        return session.as_table(prep.genes, {"de": de, "dv": dv})

    def sample_key(self, record):
        return self.ds.types[record.request["type"]].n_cells

    def check(self, records, checks):
        return session.check(self, records, checks)
