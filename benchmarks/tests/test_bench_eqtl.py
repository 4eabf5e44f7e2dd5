"""The eQTL cell's request kind (``kinds/eqtl_sweep_1d.py``): its design,
deterministic by seed with sizes fixed by the files; the readers of its
per-layer metrics; and the comparison that decides ``correct``, which the
control and each 1D fault of ``benchmarks/faults.py`` have to fail."""

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import control, data, faults, run
from conftest import SEED, TINY_LIMITS

WORKLOAD = "eqtl-donors"


def eqtl_tiny(n_cells=3000, n_genes=300, n_donors=12):
    """The cell at a size the CPU runs in seconds: 12 donors, B = 200 and
    the bootstrap's limits for that size (``conftest.TINY_LIMITS``)."""
    cell = run.find_cell(run.ROOT, WORKLOAD)
    cell.config = dict(cell.config, n_cells=n_cells, n_genes=n_genes,
                       n_donors=n_donors)
    cell.traffic = dict(cell.traffic, num_boot=200)
    cell.checks = {"limits": {
        k: TINY_LIMITS.get(k.split(".")[0], v)
        for k, v in cell.checks["limits"].items()}}
    return cell


@pytest.fixture(scope="module")
def kind():
    return run.find_cell(run.ROOT, WORKLOAD).kind()


def _design(kind, cell, seed):
    genes = np.array([f"g{j}" for j in range(cell.config["n_genes"])])
    return kind.design(cell.config, cell.traffic, seed, genes), genes


def test_design_is_deterministic_by_seed(kind):
    cell = eqtl_tiny()
    a, genes = _design(kind, cell, SEED)
    b, _ = _design(kind, cell, SEED)
    c, _ = _design(kind, cell, SEED + 1)
    for x, y in zip(a, b):
        if isinstance(x, dict):
            assert x == y
        else:
            np.testing.assert_array_equal(x, y)
    # another seed: other values, the same sizes and columns
    np.testing.assert_array_equal(a.snp_names, c.snp_names)
    np.testing.assert_array_equal(a.n_snps, c.n_snps)
    assert a.dosage.shape == c.dosage.shape
    assert (a.dosage != c.dosage).any()
    assert (a.covariate != c.covariate).any()
    assert a.planted.sum() == c.planted.sum()


def test_snps_per_gene_and_covariates(kind):
    cell = eqtl_tiny()
    dz, genes = _design(kind, cell, SEED)
    tr = cell.traffic
    assert dz.n_snps.min() >= tr["snps_min"]
    assert dz.n_snps.max() == tr["snps_max"]
    assert len(set(dz.snp_names)) == dz.snp_names.size == dz.n_snps.sum()
    d = cell.config["n_donors"]
    assert dz.covariate.shape == (d, len(kind.COVARIATES))
    np.testing.assert_array_equal(dz.covariate[:, 0], 1.0)
    assert dz.covariate[:, 1].sum() == d // 2
    assert abs(dz.covariate[:, 2].mean()) < 1e-12


@pytest.mark.parametrize("seed", [SEED, 7])
def test_planted_share_and_hardy_weinberg(kind, seed):
    cell = eqtl_tiny(n_genes=400, n_donors=120)
    dz, genes = _design(kind, cell, seed)
    assert dz.planted.sum() == round(0.1 * len(genes)) == 40
    d = cell.config["n_donors"]
    want = np.array([kind.hw_counts(d, p) for p in dz.maf])
    got = np.stack([(dz.dosage == v).sum(0) for v in (0, 1, 2)], 1)
    np.testing.assert_array_equal(got, want)
    assert ((dz.maf >= 0.05) & (dz.maf <= 0.5)).all()
    # a planted SNP's dosage rises with its gene's donor factor
    _, _, donor_fac, _ = data.gene_laws(cell.config, seed)
    for j in np.nonzero(dz.planted)[0]:
        dos = dz.dosage[np.argsort(donor_fac[:, j]), dz.first_snp[j]]
        assert (np.diff(dos) >= 0).all()


def test_every_gene_of_every_type_has_its_snps(kind):
    cell = eqtl_tiny()
    ds = data.draw(cell.config, SEED, "cpu")
    runner = kind.Runner(None, ds, cell.config, cell.traffic, SEED, "cpu")
    assert set(runner.design.snps_of) == set(ds.genes)
    for t in ds.types:
        assert set(t.donor) == set(range(cell.config["n_donors"]))
    for gene, snps in runner.design.snps_of.items():
        assert snps and all(s.startswith(f"{gene}.snp") for s in snps)


def test_a_program_without_the_tile_budget_is_refused(kind):
    import memento_tpu_torch as program

    kind.require(program)

    class Old:
        class inference:
            ht = object()

    with pytest.raises(SystemExit, match="tile_budget"):
        kind.require(Old)


def reader(name):
    return run.load_module(run.ROOT / "benchmarks" / "metrics"
                           / f"{name}.py", "e_" + name.replace(".", "_"))


def view(phases, kind="1d", traced=True):
    summary = {"window_s": 4.0, "busy_s": 0.5, "device_events": 1, "ops": [],
               "top_ops": 10, "gaps": [], "bytes": 1}
    t = run.Traced(phases=phases, spans={}, n=2, kind=kind, summary=summary,
                   n_profiled=1)
    return run.RunView(kind=kind, records=[], window_s=3.5, setup_s=1.0,
                       peak_host_bytes=1, traced=t if traced else None)


@pytest.mark.parametrize("name,phase", [
    ("treatment_s.1d", "ht_1d_moments.treatment"),
    ("regress_s.1d", "ht1d.regress")])
def test_span_readers(name, phase):
    read = reader(name).read
    assert read(view({phase: 0.75, "ht1d.launch": 2.0})) == \
        pytest.approx(0.375)
    assert read(view({phase: 0.75}, traced=False)) is None
    assert read(view({phase: 0.75}, kind="2d")) is None
    assert read(view({"ht1d.launch": 2.0})) is None  # a program without it


def test_group_calls_per_tile(monkeypatch):
    from memento_tpu_torch.utils import profiling

    read = reader("group_calls_per_tile.1d").read
    monkeypatch.setattr(profiling, "counters", lambda: {
        "ht1d.group_calls": 3000, "ht1d.tiles": 5, "ht1d.tests": 9})
    assert read(view({})) == pytest.approx(600.0)
    assert read(view({}, traced=False)) is None
    assert read(view({}, kind="2d")) is None
    monkeypatch.setattr(profiling, "counters", lambda: {"ht1d.gev.rows": 4})
    assert read(view({})) is None  # a program that keeps no such counters
    monkeypatch.delattr(profiling, "counters")
    assert read(view({})) is None


def _run(cell):
    return run.run_cell(cell, SEED, 1.0, False, "cpu",
                        Path(tempfile.gettempdir()))


def test_sound_run_is_correct_and_counts_the_tests():
    out = _run(eqtl_tiny())
    assert out["correct"] is True, out["compared"]
    assert out["failed"] == 0
    assert out["compared"]["items_differ"][0] == 0


def test_control_is_not_correct():
    out = control.run_seed(eqtl_tiny(), SEED, 6, torch.device("cpu"))
    assert out["compared"] >= 1
    assert out["correct"] is False, out


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_not_correct(fault):
    cell = eqtl_tiny()
    undo = faults.plant(fault, cell.kind().Runner.kind)
    try:
        out = _run(cell)
    finally:
        undo()
    assert out["correct"] is False, out["compared"]
