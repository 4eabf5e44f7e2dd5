"""Kind ``eqtl_sweep_1d``: one request per cell type, a whole cis-eQTL scan
of it, donors as groups.

A request runs ``setup_memento -> create_groups(label_columns=["donor"]) ->
compute_1d_moments -> ht_1d_moments(covariate, treatment,
treatment_for_gene=...) -> get_1d_ht_result`` on a fresh AnnData of one
cell type: memento's eQTL mode, each gene tested against its own cis-SNPs,
after donor covariates.  The types come smallest first, cycling; a run does
whole sweeps, and a traced run profiles the largest type of the first.
Its work is the result's rows: one test per gene and SNP, DE and DV
together.

The design (``design``) is the run's, drawn once at set-up:

- each gene has ``snps_min``-``snps_max`` SNPs, uniform, from
  ``layout_seed``: the number of columns is fixed by the files, not by the
  seed;
- each SNP has a minor-allele frequency uniform in ``maf_low``-``maf_high``
  and Hardy-Weinberg dosage counts over the donors (``hw_counts``), dealt
  to the donors at random;
- for ``planted_share`` of the genes the first SNP is an eQTL: its dosages
  follow the rank of the gene's donor factor (``data.gene_laws``), the
  counts kept;
- the covariates are an intercept, sex (half the donors each), age
  (uniform 20-80 years, standardized) and three genotype PCs (standard
  normal).

The traffic file's parameters: those above, ``filter_mean_thresh``,
``num_boot``, ``sampler``, ``resampling``, ``approx`` and
``check_requests`` (requests compared with ``benchmarks/reference_eqtl.py``
after the window).

A program without the device's tile budget (``inference.ht.tile_budget``)
looks SNPs up by a scan of every column name and tiles 120 groups at 64
genes: its requests would run for minutes.  The runner refuses it at once.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np

from benchmarks import data, reference, reference_eqtl, session
from benchmarks.data import derive

STATS = ("de", "dv")
# what the program has to have for this cell (see the module's docstring)
NEEDS = ("inference.ht", "tile_budget")
COVARIATES = ("intercept", "sex", "age", "pc1", "pc2", "pc3")


class Design(NamedTuple):
    """The run's per-donor tables and each gene's SNPs."""

    snp_names: np.ndarray  # [S]
    dosage: np.ndarray  # [D, S] float64 in {0, 1, 2}
    maf: np.ndarray  # [S]
    snps_of: dict  # gene name -> list of its SNP names
    first_snp: np.ndarray  # [G] column of each gene's first SNP
    n_snps: np.ndarray  # [G]
    planted: np.ndarray  # [G] bool: the first SNP is an eQTL
    covariate: np.ndarray  # [D, K] float64, COVARIATES' columns


def hw_counts(n: int, maf: float):
    """Donors with 0, 1 and 2 minor alleles under Hardy-Weinberg:
    ``round(n 2 p (1 - p))`` heterozygotes, ``round(n p^2)`` homozygotes,
    the rest with none."""
    n2 = int(round(n * maf * maf))
    n1 = int(round(n * 2.0 * maf * (1.0 - maf)))
    return n - n1 - n2, n1, n2


def design(config, traffic, seed, genes) -> Design:
    """The SNPs, their dosages, the planted eQTLs and the covariates."""
    n_genes = len(genes)
    d = int(config["n_donors"])
    layout = np.random.default_rng(int(traffic["layout_seed"]))
    n_snps = layout.integers(int(traffic["snps_min"]),
                             int(traffic["snps_max"]) + 1, n_genes)
    first = np.concatenate([[0], np.cumsum(n_snps)[:-1]])
    names = np.array([f"{genes[j]}.snp{k}" for j in range(n_genes)
                      for k in range(n_snps[j])])
    rng = np.random.default_rng(derive(seed, 8))
    maf = rng.uniform(traffic["maf_low"], traffic["maf_high"], names.size)
    planted = np.zeros(n_genes, bool)
    planted[rng.choice(n_genes, int(round(traffic["planted_share"]
                                          * n_genes)), replace=False)] = True
    _, _, donor_fac, _ = data.gene_laws(config, seed)
    # each SNP's dosages in ascending order, dealt to the donors in a random
    # order, or for a planted SNP in the order of its gene's donor factor
    n0, n1, _ = np.vectorize(hw_counts)(d, maf)
    rank = np.arange(d)[None, :]
    ascending = ((rank >= n0[:, None]).astype(np.float64)
                 + (rank >= (n0 + n1)[:, None]))  # [S, D]
    order = np.argsort(rng.random((names.size, d)), axis=1)
    order[first[planted]] = np.argsort(donor_fac[:, planted].T, axis=1,
                                       kind="stable")
    dosage = np.empty((names.size, d))
    np.put_along_axis(dosage, order, ascending, axis=1)
    dosage = np.ascontiguousarray(dosage.T)
    sex = np.zeros(d)
    sex[rng.permutation(d)[:d // 2]] = 1.0
    age = rng.uniform(20.0, 80.0, d)
    covariate = np.column_stack([np.ones(d), sex,
                                 (age - age.mean()) / age.std(),
                                 rng.standard_normal((d, 3))])
    snps_of = {genes[j]: list(names[first[j]:first[j] + n_snps[j]])
               for j in range(n_genes)}
    return Design(snp_names=names, dosage=dosage, maf=maf, snps_of=snps_of,
                  first_snp=first, n_snps=n_snps, planted=planted,
                  covariate=covariate)


def require(program) -> None:
    """Refuse, at set-up, a program that lacks what this cell needs."""
    mod, name = NEEDS
    found = program
    for part in mod.split("."):
        found = getattr(found, part, None)
    if found is None or not hasattr(found, name):
        raise SystemExit(
            f"eqtl_sweep_1d: the program has no {mod}.{name} (the device's "
            "tile budget, with the column lookup by name): at 120 groups "
            "and B = 5,000 its requests would run for minutes; refused "
            "before the first request")


class Runner:
    kind = "1d"
    unit = "tests"
    STATS = STATS

    def __init__(self, program, dataset, config, traffic, seed, device):
        if program is not None:  # the control runs without the program
            require(program)
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
        self.design = design(config, traffic, seed, dataset.genes)
        self.gene_pos = {g: j for j, g in enumerate(dataset.genes)}

    def traced(self, index):
        """A traced run profiles the largest type of the first sweep."""
        return index == self.cycle - 1

    def requests(self):
        for i, t in enumerate(itertools.cycle(self.order)):
            yield {"type": t, "seed": derive(self.seed, 2, i)}

    def donors_of(self, groups) -> np.ndarray:
        """The donor of each of the program's groups, in its order."""
        return np.array([int(str(d)[1:]) for d in groups["donor"]])

    def tables(self, groups):
        """The program's covariate and treatment tables, one row per
        group."""
        p = self.program
        rows = self.donors_of(groups)
        cov = self.design.covariate[rows]
        covariate = p.ColumnTable(dict(zip(COVARIATES, cov.T)),
                                  index=groups.index)
        treatment = p.ColumnTable(
            dict(zip(self.design.snp_names, self.design.dosage[rows].T)),
            index=groups.index)
        return covariate, treatment

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
            p.create_groups(adata, label_columns=["donor"])
        with session.span(spans, "api.compute_1d_moments"):
            p.compute_1d_moments(adata)
        covariate, treatment = self.tables(p.get_groups(adata))
        with session.span(spans, "api.ht_1d_moments"):
            p.ht_1d_moments(adata, covariate=covariate, treatment=treatment,
                            treatment_for_gene=self.design.snps_of,
                            num_boot=tr["num_boot"],
                            resampling=tr["resampling"], approx=tr["approx"],
                            sampler=tr["sampler"],
                            verbose=0, seed=request["seed"],
                            device=self.device)
        with session.span(spans, "api.get_1d_ht_result"):
            res = p.get_1d_ht_result(adata)
        table = {"items": np.asarray(res["tx"])}
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
        out = session.counters(self.program)
        from memento_tpu_torch.utils import profiling

        out["program"] = {k: v for k, v in profiling.counters().items()
                          if k.startswith("ht1d.")
                          and not k.startswith("ht1d.gev")}
        return out

    def prepare(self, precision="reference"):
        reference.supported(self.config, self.traffic)
        return None  # each request's cell type is prepared on its own

    def reference_results(self, request, prep=None, precision="reference"):
        """The reference's (or, with ``precision="control"``, the control's)
        results for ``request``, as ``compare.numbers`` takes them: one item
        per gene and SNP."""
        ctype = self.ds.types[request["type"]]
        reference.supported(self.config, self.traffic)
        prep = reference.prepare(
            ctype.X, np.zeros_like(ctype.condition), ctype.donor, self.ds.q,
            self.ds.genes, filter_mean_thresh=self.traffic[
                "filter_mean_thresh"],
            host=self.prec[precision]["host"], device="cpu")
        dz = self.design
        donors = np.array([donor for _, donor in prep.groups])
        pos = np.array([self.gene_pos[g] for g in prep.genes], np.int64)
        kt = int(dz.n_snps.max())
        dosage = dz.dosage[donors]
        treatment = np.zeros((pos.size, donors.size, kt))
        for i, j in enumerate(pos):
            k = dz.n_snps[j]
            treatment[i, :, :k] = dosage[:, dz.first_snp[j]:
                                         dz.first_snp[j] + k]
        de, dv = reference_eqtl.test_1d(
            ctype.X, prep, dz.covariate[donors][:, 1:], treatment,
            dz.n_snps[pos], num_boot=self.traffic["num_boot"],
            seed=derive(request["seed"], session.STREAMS[precision]),
            device_dtype=self.prec[precision]["device"], device=self.device)
        tested = np.arange(kt)[None, :] < dz.n_snps[pos][:, None]
        items = np.array([name for j in pos
                          for name in dz.snps_of[self.ds.genes[j]]])
        out = {"items": items}
        for s, r in (("de", de), ("dv", dv)):
            out[f"{s}_coef"], out[f"{s}_se"], out[f"{s}_pval"] = \
                r.coef[tested], r.se[tested], r.pval[tested]
        return out

    def sample_key(self, record):
        return self.ds.types[record.request["type"]].n_cells

    def check(self, records, checks):
        return session.check(self, records, checks)
