"""The port's eQTL mode on the CPU: donors as groups, a covariate table and
per-gene SNP treatments (``treatment_for_gene``), through the public API,
against the plain reference ``benchmarks/reference_eqtl.py``; the
per-gene treatment's construction, the tile budget, and the spans and
counters of the 1D tile loop."""

import numpy as np
import pytest
import torch

import memento_tpu_torch as mtt
from benchmarks import compare, data, reference, reference_eqtl
from memento_tpu_torch import api
from memento_tpu_torch.inference import ht
from memento_tpu_torch.utils import profiling

SEED = 2**31 + 1515
N_DONORS = 12
B = 300
CONFIG = {"n_cells": 600, "n_genes": 60, "n_donors": N_DONORS,
          "celltype_shares": [1.0], "capture_q": 0.1, "base_mean_low": 5.0,
          "base_mean_high": 30.0, "type_sd": 0.5, "donor_sd": 0.3,
          "effect": 1.0, "effect_share": 0.0}

# Limits of the comparison at this size (B = 300, about 110-125 tests of 12
# groups of 50 cells): the program's and the reference's bootstraps draw
# independently, so the median log SE ratio and the median z difference
# scatter by a few percent; read over seeds 0-7 and SEED of this design
# (largest se_shift 0.021, se_shift_top 0.060, pval_shift 0.065: the
# program refits the planted tests' tails, the reference counts) and set
# with room for other seeds; a replicate spread scaled by 1.5 gives
# se_shift log 1.5 = 0.41.  The genes are well expressed (base
# means 5-30): at this size a group of a barely expressed gene, all of
# whose counts are 0 or 1 on cells whose size factors are small multiples
# of one value, can have a variance of exactly zero, whose sign each
# side's rounding decides (seed 4 at base means 0.5-6 has one).
SE_SHIFT = 0.06
SE_SHIFT_TOP = 0.12
PVAL_SHIFT = 0.15
# Observed coefficients: the program regresses in float32, the reference in
# float64; float32's rounding moves a coefficient by less than 1e-5 of its
# SE (0.0 to five places on every seed above), a bfloat16 regression by
# more than 0.01.
COEF_GAP = 1e-3


def eqtl_case(seed):
    """One cell type of 12 donors: counts, the AnnData, each gene's 1-3
    SNPs (the first of every fifth gene an eQTL on the donor factor) and a
    K = 3 covariate table (intercept and two standard normal columns)."""
    ds = data.draw(CONFIG, seed, "cpu")
    ct = ds.types[0]
    _, _, donor_fac, _ = data.gene_laws(CONFIG, seed)
    rng = np.random.default_rng(seed)
    n_snps = rng.integers(1, 4, CONFIG["n_genes"])
    snps_of, dosage = {}, {}
    for j, gene in enumerate(ds.genes):
        snps_of[gene] = [f"{gene}.snp{k}" for k in range(n_snps[j])]
        for k, name in enumerate(snps_of[gene]):
            if k == 0 and j % 5 == 0:
                rank = np.argsort(np.argsort(donor_fac[:, j]))
                dosage[name] = (rank * 3 // N_DONORS).astype(np.float64)
            else:
                dosage[name] = rng.integers(0, 3, N_DONORS).astype(np.float64)
    cov = np.column_stack([np.ones(N_DONORS),
                           rng.standard_normal((N_DONORS, 2))])
    return ds, ct, snps_of, dosage, cov


def program_table(ds, ct, snps_of, dosage, cov, seed):
    adata = mtt.AnnData(ct.X, obs=mtt.ColumnTable({
        "capture_q": np.full(ct.n_cells, ds.q),
        "donor": np.array([f"d{k}" for k in ct.donor])}),
        var=mtt.ColumnTable(index=ds.genes))
    mtt.setup_memento(adata, q_column="capture_q",
                      estimator_type="hyper_relative", filter_mean_thresh=0.07)
    mtt.create_groups(adata, label_columns=["donor"])
    mtt.compute_1d_moments(adata)
    groups = mtt.get_groups(adata)
    donors = np.array([int(d[1:]) for d in groups["donor"]])
    covariate = mtt.ColumnTable({f"c{k}": cov[donors, k] for k in range(3)},
                                index=groups.index)
    treatment = mtt.ColumnTable({n: v[donors] for n, v in dosage.items()},
                                index=groups.index)
    mtt.ht_1d_moments(adata, covariate=covariate, treatment=treatment,
                      treatment_for_gene=snps_of, num_boot=B,
                      sampler="multinomial", verbose=0, seed=seed,
                      device="cpu")
    res = mtt.get_1d_ht_result(adata)
    out = {"items": np.asarray(res["tx"])}
    for s in ("de", "dv"):
        for k in ("coef", "se", "pval"):
            out[f"{s}_{k}"] = np.asarray(res[f"{s}_{k}"], np.float64)
    return out


def reference_table(ds, ct, snps_of, dosage, cov, seed):
    prep = reference.prepare(ct.X, np.zeros_like(ct.condition), ct.donor,
                             ds.q, ds.genes, filter_mean_thresh=0.07)
    donors = np.array([d for _, d in prep.groups])
    kt = max(len(v) for v in snps_of.values())
    n_cols = np.array([len(snps_of[g]) for g in prep.genes])
    treat = np.zeros((len(prep.genes), len(donors), kt))
    for i, g in enumerate(prep.genes):
        for k, name in enumerate(snps_of[g]):
            treat[i, :, k] = dosage[name][donors]
    de, dv = reference_eqtl.test_1d(ct.X, prep, cov[donors][:, 1:], treat,
                                    n_cols, num_boot=B, seed=seed,
                                    gene_block=16)
    tested = np.arange(kt)[None, :] < n_cols[:, None]
    out = {"items": np.array([n for g in prep.genes for n in snps_of[g]])}
    for s, r in (("de", de), ("dv", dv)):
        out[f"{s}_coef"], out[f"{s}_se"], out[f"{s}_pval"] = \
            r.coef[tested], r.se[tested], r.pval[tested]
    return out


@pytest.fixture(scope="module")
def compared():
    case = eqtl_case(SEED)
    prog = program_table(*case, seed=SEED)
    ref = reference_table(*case, seed=SEED + 1)
    return prog, ref, compare.numbers(prog, ref, ("de", "dv"))


def test_items_equal(compared):
    prog, ref, nums = compared
    assert len(prog["items"]) >= 100
    assert sorted(prog["items"]) == sorted(ref["items"])
    assert nums["items_differ"] == 0


@pytest.mark.parametrize("stat", ["de", "dv"])
def test_observed_coefficients(compared, stat):
    assert compared[2][f"coef_gap.{stat}"] < COEF_GAP


@pytest.mark.parametrize("number,limit", [
    ("se_shift", SE_SHIFT), ("se_shift_top", SE_SHIFT_TOP),
    ("pval_shift", PVAL_SHIFT)])
@pytest.mark.parametrize("stat", ["de", "dv"])
def test_bootstrap_in_distribution(compared, number, limit, stat):
    assert compared[2][f"{number}.{stat}"] < limit


def test_planted_eqtls_are_found(compared):
    prog = compared[0]
    planted = np.array([n.endswith(".snp0") and int(n[1:].split(".")[0])
                        % 5 == 0 for n in prog["items"]])
    assert np.median(prog["de_pval"][planted]) < 0.05
    assert np.median(prog["de_pval"][~planted]) > 0.2


def test_one_column_without_covariates_is_the_1d_reference():
    """One treatment column equal to the condition and no covariates:
    ``reference_eqtl`` gives ``reference.test_1d``'s numbers, draws and
    all."""
    cfg = dict(CONFIG, effect=1.6, effect_share=0.2, n_donors=4)
    ds = data.draw(cfg, SEED, "cpu")
    ct = ds.types[0]
    prep = reference.prepare(ct.X, ct.condition, ct.donor, ds.q, ds.genes)
    cond = np.array([float(c) for c, _ in prep.groups])
    none = np.zeros((len(cond), 0))
    want = reference.test_1d(ct.X, prep, none, cond, num_boot=B, seed=SEED)
    n = len(prep.genes)
    got = reference_eqtl.test_1d(
        ct.X, prep, none, np.broadcast_to(cond[None, :, None], (n, len(cond),
                                                                1)),
        np.ones(n, int), num_boot=B, seed=SEED, gene_block=n)
    for w, g in zip(want, got):
        for k in ("coef", "se", "pval"):
            np.testing.assert_allclose(getattr(g, k)[:, 0], getattr(w, k),
                                       rtol=1e-9, atol=1e-12)


def _old_per_item_treatment(treatment, treatment_for_item, keys, n_groups):
    """The construction by ``list.index`` that the lookup table replaced."""
    values, names = api._table_values(treatment)
    kmax = max(len(v) for v in treatment_for_item.values())
    tens = np.zeros((len(keys), n_groups, kmax))
    nt = np.zeros(len(keys), dtype=int)
    for i, key in enumerate(keys):
        cols = [names.index(c) for c in treatment_for_item[key]]
        nt[i] = len(cols)
        tens[i, :, :nt[i]] = values[:, cols]
    return tens, nt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_item_treatment_matches_the_list_lookup(seed):
    rng = np.random.default_rng(seed)
    n_groups, n_cols, n_genes = 7, 40, 25
    names = [f"snp{rng.integers(10**6)}_{k}" for k in range(n_cols)]
    table = mtt.ColumnTable({n: rng.integers(0, 3, n_groups).astype(float)
                             for n in names})
    genes = [f"g{j}" for j in range(n_genes)]
    snps_of = {g: list(rng.choice(names, rng.integers(1, 6), replace=False))
               for g in genes + ["unused"]}
    keys = list(rng.permutation(genes))
    got = api._per_item_treatment(table, snps_of, keys, n_groups)
    want = _old_per_item_treatment(table, snps_of, keys, n_groups)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_per_item_treatment_names_a_missing_gene_or_column():
    table = mtt.ColumnTable({"s0": np.zeros(3), "s1": np.ones(3)})
    with pytest.raises(KeyError, match="g2"):
        api._per_item_treatment(table, {"g0": ["s0"], "g1": ["s1"]},
                                ["g0", "g2"], 3)
    with pytest.raises(KeyError, match="s7"):
        api._per_item_treatment(table, {"g0": ["s0", "s7"]}, ["g0"], 3)


def _old_tile_size(r, num_boot, budget_elems=1 << 28):
    t = budget_elems // max(1, r * num_boot * 12)
    t = max(64, min(8192, t))
    return (t // 64) * 64


@pytest.mark.parametrize("r", [1, 2, 8, 16, 120])
@pytest.mark.parametrize("num_boot", [100, 1000, 5000, 10000])
def test_tile_size_on_the_cpu_is_unchanged(r, num_boot):
    want = _old_tile_size(r, num_boot)
    assert ht.default_tile_size(r, num_boot) == want
    for dev in ("cpu", torch.device("cpu")):
        assert ht.default_tile_size(r, num_boot, ht.tile_budget(dev)) == want


def test_tile_size_on_a_card_follows_its_total_memory(monkeypatch):
    """On a card the budget is a share of its total memory: free memory is
    never read, so a seed gives the same tiles whatever else holds the
    card."""
    from types import SimpleNamespace

    total = 80 * 10**9
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: SimpleNamespace(
                            total_memory=total))

    def unread(*a, **kw):
        raise AssertionError("the tile budget read the free memory")
    for name in ("mem_get_info", "memory_reserved", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, unread)
    for card in (torch.device("cuda", 0), "cuda"):
        assert ht.tile_budget(card) == int(ht.TILE_MEMORY_SHARE * total) // 4
    budget = ht.tile_budget("cuda")
    assert ht.default_tile_size(120, 5000, budget) >= 1024
    assert ht.default_tile_size(8, 1000, budget) == 8192


TILE_WORKER = r'''
import sys
pid, port = int(sys.argv[1]), sys.argv[2]
import numpy as np
import scipy.sparse as sparse
import torch
torch.set_num_threads(1)
import memento_tpu_torch as mtt
from memento_tpu_torch.inference import ht
from memento_tpu_torch.models.simulate import simulate_two_groups
from memento_tpu_torch.parallel import distributed as dist
from memento_tpu_torch.utils import profiling

dist.initialize("localhost:" + port, 2, pid, timeout=60)
# the two processes see budgets of 128- and of 64-gene tiles (2 groups,
# B = 100: 12 [R, T, B] float32 buffers)
ht.tile_budget = lambda device: (128, 64)[pid] * 2 * 100 * 12
X, cond, _, qs = simulate_two_groups(
    n_cells_per_group=200, n_genes=200, q=0.1, de_genes=np.arange(4),
    de_lfc=0.8, rng=np.random.default_rng(5))
adata = mtt.AnnData(sparse.csr_matrix(X.astype(np.float64)),
                    obs={"condition": cond.astype(str), "capture_q": qs},
                    var=mtt.ColumnTable(
                        index=[f"G{i}" for i in range(X.shape[1])]))
mtt.setup_memento(adata, q_column="capture_q", filter_mean_thresh=0.01)
mtt.create_groups(adata, label_columns=["condition"])
mtt.compute_1d_moments(adata, min_perc_group=0.5)
groups = mtt.get_groups(adata)
kw = dict(covariate=mtt.ColumnTable({"one": np.ones(2)}, index=groups.index),
          treatment=mtt.ColumnTable({"tx": groups["condition"].astype(float)},
                                    index=groups.index),
          num_boot=100, seed=0, verbose=0, device="cpu")
assert adata.n_vars > 128
profiling.reset_timings()
mtt.ht_1d_moments(adata, distributed=True, **kw)
rows = {sp["attrs"]["T"] for sp in profiling.spans()
        if sp["name"] == "ht1d.launch"}
assert rows == {64}, rows
got = mtt.get_1d_ht_result(adata)
mtt.ht_1d_moments(adata, tile_size=64, **kw)
want = mtt.get_1d_ht_result(adata)
for col in ("de_coef", "de_se", "de_pval", "dv_coef", "dv_se", "dv_pval"):
    np.testing.assert_array_equal(got[col], want[col], err_msg=col)
print(f"proc {pid} ok", flush=True)
'''


def test_processes_with_different_budgets_cut_the_same_tiles():
    """Under ``distributed=True`` two gloo processes whose cards give
    different budgets take the smaller tile, and merge the one-process
    rows bit for bit (without the agreement the row partition would not
    merge)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from conftest import free_port

    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("LOCAL_RANK", "RANK", "WORLD_SIZE",
                                "MASTER_"))}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", TILE_WORKER, str(pid), port],
        cwd=Path(__file__).resolve().parent.parent, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid}\n{out}\n{err[-3000:]}"
        assert f"proc {pid} ok" in out


def test_cpu_run_records_the_new_spans_and_counters():
    """Two tiles of 3 chunks: ``ht1d.group_calls`` is R x chunks x the
    tiles run (a warm-up tile included)."""
    ds, ct, snps_of, dosage, cov = eqtl_case(SEED)
    adata = mtt.AnnData(ct.X, obs=mtt.ColumnTable({
        "capture_q": np.full(ct.n_cells, ds.q),
        "donor": np.array([f"d{k}" for k in ct.donor])}),
        var=mtt.ColumnTable(index=ds.genes))
    mtt.setup_memento(adata, q_column="capture_q",
                      estimator_type="hyper_relative")
    mtt.create_groups(adata, label_columns=["donor"])
    mtt.compute_1d_moments(adata)
    groups = mtt.get_groups(adata)
    donors = np.array([int(d[1:]) for d in groups["donor"]])
    treatment = mtt.ColumnTable({n: v[donors] for n, v in dosage.items()},
                                index=groups.index)
    covariate = mtt.ColumnTable({"c0": cov[donors, 0]}, index=groups.index)
    profiling.reset_timings()
    mtt.ht_1d_moments(adata, covariate=covariate, treatment=treatment,
                      treatment_for_gene=snps_of, num_boot=B,
                      boot_chunk=128, tile_size=32, sampler="multinomial",
                      verbose=0, seed=3, device="cpu")
    found = profiling.counters()
    genes = np.asarray(adata.var.index)
    assert len(genes) > 32  # two tiles at least
    r, chunks = len(groups.index), 3
    assert found["ht1d.tiles"] >= 2
    assert found["ht1d.group_calls"] == r * chunks * found["ht1d.tiles"]
    assert found["ht1d.tests"] == sum(len(snps_of[g]) for g in genes)
    assert found["ht1d.treat_cols"] == len(genes) * max(
        len(v) for v in snps_of.values())
    spans = profiling.timings()
    assert spans["ht_1d_moments.treatment"]["count"] == 1
    assert spans["ht1d.regress"]["count"] == found["ht1d.tiles"]


@pytest.mark.parametrize("n_cells,n_donors", [(500, 7), (3000, 120), (90, 1)])
def test_group_cells_are_the_row_mask_slices(n_cells, n_donors):
    """``create_groups`` cuts each group's matrix out of one row gather;
    it is the boolean row mask's slice of the CSC matrix, array for array,
    and the group's capture rate is the masked mean."""
    import scipy.sparse as sparse

    rng = np.random.default_rng(n_cells)
    X = sparse.random(n_cells, 40, density=0.3, format="csr", dtype=np.float32,
                      random_state=n_donors)
    X.data = np.ceil(X.data * 5)
    donor = rng.integers(0, n_donors, n_cells)
    adata = mtt.AnnData(X, obs=mtt.ColumnTable({
        "capture_q": rng.uniform(0.05, 0.2, n_cells),
        "donor": donor.astype(str), "cond": (donor % 2).astype(str)}),
        var=mtt.ColumnTable(index=np.array([f"g{j}" for j in range(40)])))
    mtt.setup_memento(adata, q_column="capture_q")
    mtt.create_groups(adata, label_columns=["cond", "donor"])
    uns = adata.uns["memento"]
    labels = np.asarray(adata.obs["memento_group"])
    X_csc = adata.X.tocsc()
    assert list(uns["group_cells"]) == uns["groups"]
    for g in uns["groups"]:
        mask = labels == g
        want, got = X_csc[mask, :], uns["group_cells"][g]
        assert got.format == "csc" and got.shape == want.shape
        for k in ("data", "indices", "indptr"):
            assert getattr(got, k).dtype == getattr(want, k).dtype
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        assert uns["group_q"][g] == float(
            np.asarray(uns["q"][mask], dtype=np.float64).mean())
