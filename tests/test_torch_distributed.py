"""The port's multi-process path (``memento_tpu_torch/parallel/distributed``)
in 2 and 4 gloo processes on the CPU.

The cases are those of the JAX package's ``tests/test_distributed.py``,
``test_distributed_ht.py``, ``test_distributed_checkpoint.py`` and
``test_parallel.py::test_merge_disjoint_rows_detects_bad_partition``:

- ``allreduce_hostsums``: ``'high'`` exact; ``'fast'`` within
  ``n_processes x 1e-7`` relative of the float64 sums (the hi halves are
  summed in float32);
- ``merge_disjoint_rows``: rows merged bit for bit, NaN kept; a row owned by
  no process or by two raises on every process;
- ``stream_*_multihost`` over row ranges against the one-process stream:
  rtol 1e-12;
- ``ht_1d_moments`` / ``ht_2d_moments`` with ``distributed=True`` (also with
  per-gene treatments) bit for bit equal to the one-process run in the same
  process, each process running only its round-robin share of the tiles;
- a checkpointed distributed run resumed after rank 0 lost a block: the
  block is recomputed by every process, the results are bit for bit those
  before the loss, and intact blocks are loaded (mtime unchanged).

In one process, with the ranks given explicitly, the partition helpers,
``allreduce_hostsums`` and ``merge_disjoint_rows`` are also held against the
JAX package's functions on the same inputs.

Each worker is a fresh interpreter (``subprocess`` of ``sys.executable``)
that imports only the port, joins the group with a 60 s timeout and runs
with one torch thread; each ``communicate`` has a timeout and a worker that
times out takes the others down with it.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from conftest import free_port
from memento_tpu_torch.parallel import distributed as dist

REPO = Path(__file__).resolve().parent.parent

WORKER = r'''
import os, sys
case, pid, nproc, port, tmp = (sys.argv[1], int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4], sys.argv[5])
import numpy as np
import scipy.sparse as sparse
import torch
torch.set_num_threads(1)
from memento_tpu_torch.parallel import distributed as dist

dist.initialize("localhost:" + port, nproc, pid, timeout=60)
assert (dist.process_index(), dist.process_count()) == (pid, nproc)
CPU = ("cpu",)


def collectives():
    rng = np.random.default_rng(1)
    # dyadic values: every order of addition gives the exact sum
    parts = [rng.integers(-2**20, 2**20, size=(3, 5)) / 1024.0
             for _ in range(nproc)]
    got, = dist.allreduce_hostsums(parts[pid])
    np.testing.assert_array_equal(got, np.sum(parts, axis=0))
    real = [rng.normal(size=40) * 10.0 ** rng.integers(-3, 4, 40)
            for _ in range(nproc)]
    hi, = dist.allreduce_hostsums(real[pid])
    fast, = dist.allreduce_hostsums(real[pid], precision="fast")
    exact = np.sum(real, axis=0)
    np.testing.assert_allclose(hi, exact, rtol=1e-15)
    scale = np.sum(np.abs(real), axis=0)
    assert np.all(np.abs(fast - exact) <= nproc * 1e-7 * scale)

    # rows merged bit for bit (NaN rows kept); tiles round-robin
    full = rng.normal(size=(10, 2))
    full[3, 1] = np.nan
    mine = dist.process_tile_starts(range(0, 10, 3))
    owned = np.zeros(10, bool)
    for s in mine:
        owned[s:s + 3] = True
    local = np.where(owned[:, None], full, np.nan)
    merged = dist.merge_disjoint_rows({"a": local, "b": -local}, owned)
    np.testing.assert_array_equal(merged["a"], full)
    np.testing.assert_array_equal(merged["b"], -full)
    for bad in (owned & (np.arange(10) != 2),       # row 2 owned by none
                owned | (np.arange(10) == 2)):      # ... or by several
        try:
            dist.merge_disjoint_rows({"a": local}, bad)
        except RuntimeError as err:
            assert "partition" in str(err), err
        else:
            raise AssertionError("a bad partition merged")

    # sufficient statistics of per-process row ranges
    from memento_tpu_torch.ops.estimators import HYPER_RELATIVE
    from memento_tpu_torch.parallel.streaming import (stream_mean_var,
                                                      stream_suffstats)
    X = sparse.csr_matrix(rng.poisson(0.8, size=(701, 23)).astype(float))
    sf = np.asarray(X.sum(1)).ravel() + 1.0
    sf /= sf.mean()
    lo, hi = dist.process_row_range(X.shape[0])
    sums = dist.stream_suffstats_multihost(X[lo:hi], sf[lo:hi], block=64,
                                           mesh=CPU)
    for a, b in zip(sums, stream_suffstats(CPU, X, sf, block=64)):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    m, v = dist.stream_mean_var_multihost(X[lo:hi], sf[lo:hi], X.shape[0],
                                          0.1, HYPER_RELATIVE, block=64,
                                          mesh=CPU)
    mw, vw = stream_mean_var(CPU, X, sf, 0.1, HYPER_RELATIVE, block=64)
    np.testing.assert_allclose(m, mw, rtol=1e-12)
    np.testing.assert_allclose(v, vw, rtol=1e-12)


def prepared():
    import memento_tpu_torch as mtt
    from memento_tpu_torch.models.simulate import simulate_two_groups

    # every process builds the same dataset from the seed: the gene axis
    # is split over the processes, not the cells
    X, cond, _, qs = simulate_two_groups(
        n_cells_per_group=400, n_genes=32, q=0.1, de_genes=np.arange(4),
        de_lfc=0.8, rng=np.random.default_rng(5))
    adata = mtt.AnnData(sparse.csr_matrix(X.astype(np.float64)),
                        obs={"condition": cond.astype(str), "capture_q": qs},
                        var=mtt.ColumnTable(
                            index=[f"G{i}" for i in range(X.shape[1])]))
    mtt.setup_memento(adata, q_column="capture_q", filter_mean_thresh=0.01,
                      trim_percent=0.3)
    mtt.create_groups(adata, label_columns=["condition"])
    mtt.compute_1d_moments(adata, min_perc_group=0.5)
    groups = mtt.get_groups(adata)
    cov = mtt.ColumnTable({"one": np.ones(len(groups))}, index=groups.index)
    tx = mtt.ColumnTable({"tx": groups["condition"].astype(float),
                          "snp": np.array([0.0, 2.0])}, index=groups.index)
    return mtt, adata, cov, tx


def tests():
    from memento_tpu_torch.device import is_warming
    from memento_tpu_torch.inference import ht

    mtt, adata, cov, tx = prepared()
    tiles = []
    for name in ("ht_1d_tile", "ht_2d_tile"):
        orig = getattr(ht, name)

        def counted(*a, _orig=orig, **kw):
            if not is_warming():  # the first-use warm-up is not a tile
                tiles.append(1)
            return _orig(*a, **kw)
        setattr(ht, name, counted)

    genes = list(adata.var.index)
    tx1 = mtt.ColumnTable({"tx": tx["tx"]}, index=tx.index)
    tfg = {g: ["tx"] if i % 2 else ["tx", "snp"] for i, g in enumerate(genes)}
    runs = [
        (mtt.ht_1d_moments, mtt.get_1d_ht_result, len(genes), 8,
         dict(treatment=tx1), ("de_coef", "de_se", "de_pval", "dv_coef",
                               "dv_se", "dv_pval")),
        (mtt.ht_1d_moments, mtt.get_1d_ht_result, len(genes), 8,
         dict(treatment=tx, treatment_for_gene=tfg),
         ("de_coef", "de_se", "de_pval")),
        (mtt.ht_2d_moments, mtt.get_2d_ht_result, 8, 2,
         dict(treatment=tx1), ("corr_coef", "corr_se", "corr_pval")),
    ]
    mtt.compute_2d_moments(adata, [(genes[i], genes[i + 1])
                                   for i in range(0, 16, 2)])
    for test, result, n_items, tile, opts, cols in runs:
        kw = dict(covariate=cov, num_boot=320, tile_size=tile, seed=0,
                  verbose=0, device="cpu", **opts)
        tiles.clear()
        test(adata, distributed=True, **kw)
        dist_res = result(adata)
        n_tiles = len(dist.process_tile_starts(range(0, n_items, tile)))
        assert len(tiles) == n_tiles, (len(tiles), n_tiles)
        test(adata, distributed=False, **kw)
        one = result(adata)
        for col in cols:
            np.testing.assert_array_equal(dist_res[col], one[col],
                                          err_msg=col)
        assert np.isfinite(np.asarray(one[cols[-1]], float)).mean() > 0.8


def checkpoint():
    mtt, adata, cov, tx = prepared()
    tx1 = mtt.ColumnTable({"tx": tx["tx"]}, index=tx.index)
    kw = dict(covariate=cov, treatment=tx1, num_boot=240, tile_size=8,
              seed=0, verbose=0, device="cpu", distributed=True,
              checkpoint_dir=os.path.join(tmp, "ckpt"), checkpoint_block=8)
    cols = ("de_coef", "de_se", "de_pval", "dv_coef", "dv_se", "dv_pval")
    mtt.ht_1d_moments(adata, **kw)
    first = mtt.get_1d_ht_result(adata)
    mine = os.path.join(tmp, "ckpt", f"proc{pid}")
    files = sorted(f for f in os.listdir(mine) if f.endswith(".npz"))
    assert len(files) == -(-adata.n_vars // 8) >= 3, files
    assert np.isfinite(first["de_pval"]).sum() >= 20
    # rank 0 lost its last block, as in a crash before it was written
    if pid == 0:
        os.remove(os.path.join(mine, files[-1]))
    mtimes = [os.path.getmtime(os.path.join(mine, f)) for f in files[:-1]]
    mtt.ht_1d_moments(adata, **kw)
    resumed = mtt.get_1d_ht_result(adata)
    for col in cols:
        np.testing.assert_array_equal(resumed[col], first[col], err_msg=col)
    # every process recomputed the lost block, and loaded the others
    assert os.path.exists(os.path.join(mine, files[-1]))
    assert [os.path.getmtime(os.path.join(mine, f))
            for f in files[:-1]] == mtimes


{"collectives": collectives, "tests": tests, "checkpoint": checkpoint}[case]()
print(f"proc {pid} {case} ok", flush=True)
'''


def _run_workers(case: str, nproc: int, tmp_path, timeout: int = 180):
    port = free_port()
    env = {k: v for k, v in __import__("os").environ.items()
           if not k.startswith(("LOCAL_RANK", "RANK", "WORLD_SIZE",
                                "MASTER_"))}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, case, str(pid), str(nproc), port,
         str(tmp_path)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {pid} failed\n{out}\n{err[-3000:]}"
        assert f"proc {pid} {case} ok" in out


def test_row_range_and_tile_starts():
    """Balanced contiguous row ranges covering every row once; round-robin
    tile starts keeping their global offsets; 0 and 1 outside a group."""
    for n, nproc in ((10, 3), (7, 4), (3, 4), (0, 2)):
        ranges = [dist.process_row_range(n, pid, nproc)
                  for pid in range(nproc)]
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        sizes = [b - a for a, b in ranges]
        assert max(sizes) - min(sizes) <= 1
    starts = list(range(0, 100, 16))
    shares = [dist.process_tile_starts(starts, pid, 3) for pid in range(3)]
    assert shares[0] == [0, 48, 96] and shares[1] == [16, 64]
    assert sorted(sum(shares, [])) == starts
    assert (dist.process_index(), dist.process_count()) == (0, 1)
    assert dist.process_row_range(9) == (0, 9)
    assert dist.process_tile_starts(starts) == starts


def test_merge_disjoint_rows_detects_bad_partition():
    """One process: a row that no mask owns raises; a whole mask merges and
    keeps NaN sentinels; outside a group the sums are the partials."""
    res = {"a": np.arange(12.0).reshape(6, 2)}
    with pytest.raises(RuntimeError, match="partition"):
        dist.merge_disjoint_rows(res, np.array([1, 1, 0, 1, 1, 1], bool))
    res["a"][1, 0] = np.nan
    got = dist.merge_disjoint_rows(res, np.ones(6, bool))
    assert np.isnan(got["a"][1, 0]) and got["a"][5, 1] == 11.0
    x = np.array([1.0 / 3.0, 1e10 + 0.5])
    np.testing.assert_array_equal(dist.allreduce_hostsums(x)[0], x)
    np.testing.assert_allclose(dist.allreduce_hostsums(x, precision="fast")[0],
                               x, rtol=1e-14)
    with pytest.raises(ValueError, match="together"):
        dist.initialize("localhost:1", None, None)


def test_partition_helpers_match_jax():
    """One process, ranks given explicitly: the row ranges, the tile shares,
    the host sums (both precisions), the merged rows and the bad-partition
    error equal the JAX package's on the same inputs.  The JAX sums spread
    each partial over the local devices (``partial / n``); with one device
    that is exact, so they are held bit for bit."""
    import jax

    from memento_tpu.parallel import distributed as j_dist

    for n, nproc in ((10, 3), (7, 4), (3, 4), (0, 2), (200_001, 8)):
        for pid in range(nproc):
            assert dist.process_row_range(n, pid, nproc) == \
                j_dist.process_row_range(n, pid, nproc)
    starts = range(0, 1000, 96)
    for nproc in (1, 2, 3, 5):
        for pid in range(nproc):
            assert dist.process_tile_starts(starts, pid, nproc) == \
                j_dist.process_tile_starts(starts, pid, nproc)

    n_local = len(jax.local_devices())
    rng = np.random.default_rng(3)
    parts = tuple(rng.normal(size=(6, 4)) * 10.0 ** rng.integers(-3, 4, (6, 4))
                  for _ in range(2))
    full = rng.normal(size=(10, 3))
    full[4, 1] = np.nan
    rows = {"a": full, "b": -full}
    for precision in ("high", "fast"):
        # the JAX docstring's error of its per-device spread, 0 on one device
        rtol = (n_local - 1) * {"high": 1e-15, "fast": 1e-7}[precision]
        got = dist.allreduce_hostsums(*parts, precision=precision)
        want = j_dist.allreduce_hostsums(*parts, precision=precision)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0)
        got = dist.merge_disjoint_rows(rows, np.ones(10, bool), precision)
        want = j_dist.merge_disjoint_rows(rows, np.ones(10, bool), precision)
        assert sorted(got) == sorted(want)
        for key in got:
            np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                       atol=0, equal_nan=True)

    bad = np.ones(10, bool)
    bad[2] = False
    messages = []
    for module in (dist, j_dist):
        with pytest.raises(RuntimeError, match="partition") as err:
            module.merge_disjoint_rows(rows, bad)
        messages.append(str(err.value).split(";")[0])
    assert messages[0] == messages[1]


@pytest.mark.parametrize("nproc", [2, 4])
def test_collectives_in_a_group(tmp_path, nproc):
    _run_workers("collectives", nproc, tmp_path)


@pytest.mark.parametrize("nproc", [2, 4])
def test_distributed_tests_equal_one_process(tmp_path, nproc):
    _run_workers("tests", nproc, tmp_path)


@pytest.mark.parametrize("nproc", [2, 4])
def test_distributed_checkpoint_crash_resume(tmp_path, nproc):
    _run_workers("checkpoint", nproc, tmp_path)
