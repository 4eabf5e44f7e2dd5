"""The GEV tail refits on the card (``csrc/gev_refine.cu``) and the host's
share of them.

On the CPU: the kernel's KS gate (two bounds per tail length) decides as
``kstwo.sf(D, L) > 0.05`` wherever it decides; rows on the CPU still take
the numpy worker, bit for bit the JAX package's ``gev_refine_batch``; the
accepted stages count the fits; the card path's bookkeeping (its launches
in ``cuda_kernels.LAUNCHES``, the counters ``gev.host_rows`` and
``gev.fit_rows``, and the p-values it writes) on a stand-in for the launch;
the kernel's cost model.  On the card
(skipped without one): the kernel against ``gev_refine_batch`` on the same
rows, a relaunch bit for bit, ptxas without spills, and the tile loop's
refit through the kernel.  This file imports JAX only inside the one test
that compares with the JAX package (skipped where it is missing), so it also
runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -s tests/test_torch_gev_kernel.py
"""

import warnings

import numpy as np
import pytest
import torch
from scipy import stats as sstats

from memento_tpu_torch.inference import gev
from memento_tpu_torch.ops import cuda_kernels
from memento_tpu_torch.utils import profiling, roofline

torch.set_num_threads(1)

# what the card's refits must reach against numpy's on the same rows
SAME_STAGE_SHARE = 0.99  # of (row, side): the same accepted stage
P_RTOL = 1e-6  # where the stages agree ...
P_RTOL_SHARE = 0.995  # ... on this share of the rows, and
P_RTOL_ALL = 1e-4  # on every row: where two likelihoods of a Nelder-Mead
# step nearly tie, the last bits decide the step and the fit ends elsewhere
# within the convergence test's 1e-5 (the numpy path moves a p-value of
# such a row by up to 7e-6 when its own start moves by one ulp)
MAX_DECADES = 1.0  # any row


@pytest.fixture
def cuda_device():
    """The card, or a skip: the kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


def _rows(rng, m, num_boot, shape="normal", degenerate=0, non_finite=0):
    """Coefficient rows ``[m, B + 1]`` float32: a statistic in the tail of
    its null (so the counting p-value is at its floor), normal or
    GEV-shaped (Gumbel) nulls, some degenerate (constant) and some with a
    non-finite replicate."""
    rows = np.empty((m, num_boot + 1), np.float32)
    if shape == "normal":
        rows[:, 1:] = rng.standard_normal((m, num_boot))
    else:
        rows[:, 1:] = rng.gumbel(size=(m, num_boot))
    rows[:, 0] = (np.abs(rng.standard_normal(m)) + 3.0) * rng.choice(
        [-1.0, 1.0], m)
    rows[:degenerate, 1:] = 0.5
    for i in range(degenerate, degenerate + non_finite):
        rows[i, 1 + i % num_boot] = (np.nan, np.inf, -np.inf)[i % 3]
    return rows


# --- the KS gate (CPU) -------------------------------------------------------

SCHEDULE_LENGTHS = sorted({min(n, b) for b in (1000, 250, 100, 40)
                           for n in gev.TAIL_SCHEDULE})


@pytest.mark.parametrize("length", SCHEDULE_LENGTHS)
def test_ks_gate_decides_as_kstwo(length):
    """On a fine grid of D around the critical value (parts in 1e9 to
    1e5) and a coarse one out to 30%, every D the gate decides is decided
    as ``kstwo.sf(D, L) > 0.05``, and the host's band is narrow."""
    crit = float(sstats.kstwo.isf(gev.KS_GATE, length))
    rel = np.concatenate([np.linspace(-1e-5, 1e-5, 4001),
                          np.linspace(-1e-7, 1e-7, 2001),
                          np.linspace(-0.3, 0.3, 601)])
    d = np.clip(crit * (1.0 + rel), 0.0, 1.0)
    want = sstats.kstwo.sf(d, length) > gev.KS_GATE
    got = np.array([gev.ks_gate(x, length) for x in d])
    decided = got != gev.HOST
    assert np.array_equal(got[decided] == gev.REFINED, want[decided])
    band = rel[~decided]
    assert band.size > 0 and np.abs(band).max() <= 10 * gev.KS_GUARD
    assert gev.ks_gate(float("nan"), length) == gev.FALLBACK


def test_kernel_schedule_clips_the_tails_to_b():
    """Per stage: n_exec, L = min(n_exec, B), the gate's bounds at L and
    n_exec / B; then pwm_start's constants, as numpy computes them."""
    n = len(gev.TAIL_SCHEDULE)
    sched = gev.kernel_schedule(100)
    assert sched.dtype == np.float64 and sched.shape == (5 * n + 2,)
    assert list(sched[:n]) == list(gev.TAIL_SCHEDULE)
    assert list(sched[n:2 * n]) == [min(x, 100) for x in gev.TAIL_SCHEDULE]
    for i, length in enumerate(sched[n:2 * n].astype(int)):
        assert (sched[2 * n + i], sched[3 * n + i]) == \
            gev.ks_gate_bounds(length)
    assert list(sched[4 * n:5 * n]) == [x / 100 for x in gev.TAIL_SCHEDULE]
    assert sched[-2] == np.log(2) / np.log(3) and sched[-1] == np.log(2)


# --- rows on the CPU: the numpy worker, bit for bit (CPU) ----------------------

CPU_CASES = {
    "normal_b1000": dict(m=40, num_boot=1000, shape="normal"),
    "gev_b1000": dict(m=40, num_boot=1000, shape="gev"),
    "mixed_b600": dict(m=40, num_boot=600, shape="gev", degenerate=3,
                       non_finite=3),
    "clipped_b200": dict(m=24, num_boot=200, shape="normal", degenerate=2),
}


@pytest.mark.parametrize("resampling", ["bootstrap", "permutation"])
@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_cpu_rows_take_the_numpy_worker_bit_for_bit(case, resampling):
    """``DeferredGEV`` on CPU rows: the worker's numpy refit, equal bit for
    bit to the JAX package's ``gev_refine_batch``; no kernel launch."""
    j_gev = pytest.importorskip("memento_tpu.inference.gev")
    rng = np.random.default_rng(sorted(CPU_CASES).index(case))
    rows = _rows(rng, **CPU_CASES[case])
    m = rows.shape[0]
    fallbacks = rng.uniform(1e-4, 2e-3, m)
    out = np.full((m + 3, 2), np.nan)
    gi, gk = np.arange(m) + 2, np.arange(m) % 2
    out[gi, gk] = fallbacks
    profiling.reset_timings()
    cuda_kernels.reset_launches()
    worker = gev.DeferredGEV("t")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        worker.submit(torch.as_tensor(rows), gi, gk, out, resampling)
        worker.finish()
        stats, nulls = gev.split_rows(rows, resampling)
        want = j_gev.gev_refine_batch(stats, nulls, fallbacks)
    assert np.array_equal(out[gi, gk], want)
    found = profiling.counters()
    assert found["t.gev.rows"] == m and found["t.gev.fit_rows"] >= m
    assert cuda_kernels.LAUNCHES[cuda_kernels.GEV] == 0
    assert "t.gev.host_rows" not in found
    names = {name for name in profiling.timings()}
    assert {"t.gev.refine", "t.gev.refine.wait", "t.gev.fit"} <= names
    assert "t.gev.host" not in names


def test_accepted_stages_count_the_fits():
    """``gev_refine_batch(accepted=...)`` leaves the p-values as they were,
    and ``stage_fits`` of its stages is the counter of fits."""
    rng = np.random.default_rng(11)
    rows = _rows(rng, 48, 800, "gev", degenerate=2, non_finite=2)
    stats, nulls = gev.split_rows(rows, "bootstrap")
    fallbacks = np.full(48, 1.0 / 801)
    profiling.reset_timings()
    accepted = np.zeros((48, 2), np.int64)
    got = gev.gev_refine_batch(stats, nulls, fallbacks, counter="c",
                               accepted=accepted)
    assert np.array_equal(got, gev.gev_refine_batch(stats, nulls, fallbacks))
    finite = np.isfinite(nulls).all(1) & np.isfinite(stats)
    assert gev.stage_fits(accepted[finite]) == profiling.counters()["c"]
    assert not accepted[~finite].any()
    refined = got != fallbacks
    assert (accepted[refined & finite] > 0).all()
    assert not (accepted[~refined] > 0).all(1).any()


# --- the card path's bookkeeping, on a stand-in for the launch (CPU) ---------

def _stand_in(rows, resampling):
    """What the kernel would return for ``rows``: row i refined (stages 2
    and 3), kept at its counting p-value (the left side tried every stage,
    or the right side every stage after the left took stage 5) or left to
    the host, by i % 4; rows with a non-finite entry to the host."""
    m = rows.shape[0]
    out = np.zeros((m, cuda_kernels.GEV_OUT_COLS))
    out[:, 0] = np.nan
    for i in range(m):
        kind = i % 4
        if kind == 0:
            out[i, :4] = (1e-6 * (i + 1), gev.REFINED, 2, 3)
        elif kind == 1:
            out[i, 1:4] = (gev.FALLBACK, 0, 0)
        elif kind == 2:
            out[i, 1:4] = (gev.FALLBACK, 5, 0)
        else:
            out[i, 1] = gev.HOST
    finite = torch.isfinite(rows).all(1).numpy()
    out[~finite, :4] = (np.nan, gev.HOST, 0, 0)
    out[:, 4] = 1000.0
    cuda_kernels.count_launch(0, cuda_kernels.GEV)  # as the launch counts
    return torch.as_tensor(out)


def test_card_path_counters_add_up(monkeypatch):
    """Two tiles through the card's path: one launch each (``LAUNCHES``),
    the refined rows' p-values written at ``finish``, the others' counting
    p-values kept, the host's rows (``gev.host_rows``) refit by numpy, and
    ``gev.fit_rows`` the card's stages plus the host's fits."""
    monkeypatch.setattr(cuda_kernels, "on_card", lambda device: True)
    monkeypatch.setattr(gev, "launch_refine", _stand_in)
    rng = np.random.default_rng(4)
    tiles = [_rows(rng, 18, 700, "gev", non_finite=2),
             _rows(rng, 13, 700, "normal", degenerate=1)]
    out = np.full((40, 3), np.nan)
    profiling.reset_timings()
    cuda_kernels.reset_launches()
    worker = gev.DeferredGEV("t")
    spots, fallbacks = [], []
    at = 0
    for rows in tiles:
        m = rows.shape[0]
        gi, gk = np.arange(at, at + m), np.full(m, at % 3)
        at += m
        fb = rng.uniform(1e-4, 2e-3, m)
        out[gi, gk] = fb
        spots.append((gi, gk))
        fallbacks.append(fb)
        worker.submit(torch.as_tensor(rows), gi, gk, out, "bootstrap")
    assert np.array_equal(out[spots[0]], fallbacks[0])  # nothing before finish
    worker.finish()
    assert cuda_kernels.LAUNCHES[cuda_kernels.GEV] == len(tiles)

    host_rows, host_fits, card_fits = 0, 0, 0
    for rows, (gi, gk), fb in zip(tiles, spots, fallbacks):
        want = _stand_in(torch.as_tensor(rows), "bootstrap").numpy()
        status = want[:, 1]
        got = out[gi, gk]
        refined = status == gev.REFINED
        assert np.array_equal(got[refined], want[refined, 0])
        kept = status == gev.FALLBACK
        assert np.array_equal(got[kept], fb[kept])
        host = status == gev.HOST
        stats, nulls = gev.split_rows(rows[host], "bootstrap")
        profiling.count("scratch", 0)
        before = profiling.counters()["scratch"]
        assert np.array_equal(got[host], gev.gev_refine_batch(
            stats, nulls, fb[host], counter="scratch"))
        host_fits += profiling.counters()["scratch"] - before
        host_rows += int(host.sum())
        card_fits += gev.stage_fits(want[~host, 2:4].astype(np.int64))
    found = profiling.counters()
    assert found["t.gev.rows"] == sum(len(s[0]) for s in spots)
    assert found["t.gev.host_rows"] == host_rows > 0
    assert found["t.gev.fit_rows"] == card_fits + host_fits
    names = set(profiling.timings())
    assert {"t.gev.refine", "t.gev.fit", "t.gev.host"} <= names
    assert "t.gev.refine.wait" not in names


# --- the cost model (CPU) ------------------------------------------------------

def test_gev_cost_counts_the_fitted_values_and_one_read_of_the_tails():
    cost = roofline.gev_refine_cost(1e6, 10, 300)
    assert cost["ops"] == roofline.OPS_GEV_VALUE * 1e6
    assert cost["hbm_bytes"] == 10 * (2 * 300 * 8 + 8 + 1 + 40)
    assert roofline.OPS_GEV_VALUE == 2 * (15 + 13 + 2 * 5 + 3)


def test_gev_roofline_follows_from_the_peaks():
    r = roofline.gev_refine_roofline(2e7, 100, 300, 1e-3)
    assert r["t_compute_bound_s"] == pytest.approx(
        82 * 2e7 / roofline.PEAK_FP64_S)
    assert r["limiting_resource"] == "fp64"
    assert r["bound_s"] == r["t_compute_bound_s"]
    assert r["fp64_utilization"] == pytest.approx(r["bound_s"] / 1e-3)
    slow_mem = roofline.gev_refine_roofline(10.0, 100000, 300, 1e-3)
    assert slow_mem["limiting_resource"] == "hbm"


# --- the kernel on the card ----------------------------------------------------

def _agreement(rows, resampling, dev):
    """The kernel's refit of ``rows`` (and the host's share) against
    ``gev_refine_batch`` on the same rows: the figures of the agreement."""
    m, num_boot = rows.shape[0], rows.shape[1] - 1
    fallbacks = np.full(m, 1.0 / (num_boot + 1))
    rows_dev = torch.as_tensor(rows, device=dev)
    profiling.reset_timings()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out = gev.launch_refine(rows_dev, resampling).cpu().numpy()
        got, acc_k = gev.settle(out, rows_dev, fallbacks, resampling,
                                counter="card")
        stats, nulls = gev.split_rows(rows, resampling)
        acc_n = np.zeros((m, 2), np.int64)
        want = gev.gev_refine_batch(stats, nulls, fallbacks, counter="host",
                                    accepted=acc_n)
    found = profiling.counters()
    same = acc_k == acc_n
    rows_same = same.all(1)
    rel = np.abs(got - want) / np.abs(want)
    decades = np.abs(np.log10(got) - np.log10(want))
    return {
        "same_stage_share": float(same.mean()),
        "p_rtol_share": float((rel[rows_same] <= P_RTOL).mean()),
        "p_rtol_max": float(rel[rows_same].max()),
        "max_decades": float(decades.max()),
        "fits": (found.get("card", 0), found.get("host", 0)),
        "status": np.bincount(out[:, 1].astype(int), minlength=3),
    }


@pytest.mark.parametrize("resampling", ["bootstrap", "permutation"])
@pytest.mark.parametrize("num_boot, m, shape", [
    (1000, 4000, "normal"), (1000, 1000, "gev"),
    (5000, 1000, "normal"), (5000, 2000, "gev")])
def test_kernel_agrees_with_numpy_on_card(cuda_device, num_boot, m, shape,
                                          resampling):
    rng = np.random.default_rng(num_boot + m)
    rows = _rows(rng, m, num_boot, shape, degenerate=5, non_finite=6)
    a = _agreement(rows, resampling, cuda_device)
    print(f"\nB={num_boot} M={m} {shape} {resampling}: {a}")
    assert a["status"][gev.HOST] >= 6  # the non-finite rows at least
    assert a["same_stage_share"] >= SAME_STAGE_SHARE
    assert a["p_rtol_share"] >= P_RTOL_SHARE
    assert a["p_rtol_max"] <= P_RTOL_ALL
    assert a["max_decades"] <= MAX_DECADES
    assert a["fits"][0] == a["fits"][1]


def test_kernel_relaunch_is_bit_for_bit_on_card(cuda_device):
    rng = np.random.default_rng(2)
    rows = torch.as_tensor(_rows(rng, 300, 1000, "gev", 2, 2),
                           device=cuda_device)
    cuda_kernels.reset_launches()
    first = gev.launch_refine(rows, "bootstrap")
    again = gev.launch_refine(rows, "bootstrap")
    # bit for bit, the NaN p-values of unrefined rows included
    assert torch.equal(first.view(torch.int64), again.view(torch.int64))
    assert cuda_kernels.LAUNCHES[cuda_kernels.GEV] == 2


def test_kernel_builds_without_spills_on_card(cuda_device):
    use = cuda_kernels.ptxas(cuda_kernels.GEV)[0]
    assert use["registers"] is not None
    assert not use["spill_store_bytes"] and not use["spill_load_bytes"]
    assert cuda_kernels.resources(cuda_kernels.GEV)["blocks_per_sm"] >= 1


def test_kernel_refuses_bad_inputs_on_card(cuda_device):
    tails = torch.zeros((2, 2, 300), dtype=torch.float64, device=cuda_device)
    ok = (torch.zeros(2, dtype=torch.float64, device=cuda_device),
          torch.ones(2, dtype=torch.bool, device=cuda_device),
          gev.kernel_schedule(1000), 150)
    with pytest.raises(ValueError):
        cuda_kernels.launch_gev_refine(tails.float(), *ok)
    with pytest.raises(ValueError):
        cuda_kernels.launch_gev_refine(tails[:, :1].contiguous(), *ok)
    with pytest.raises(RuntimeError):  # a tail longer than the kernel's
        cuda_kernels.launch_gev_refine(
            torch.zeros((2, 2, 301), dtype=torch.float64,
                        device=cuda_device), *ok)


def test_tile_loop_refits_through_the_kernel_on_card(cuda_device):
    """``DeferredGEV`` on CUDA rows: one launch a tile, no worker copy,
    the p-values of ``settle`` and the counters that add up."""
    rng = np.random.default_rng(9)
    rows = _rows(rng, 200, 1000, "gev", degenerate=1, non_finite=2)
    out = np.full((200, 1), np.nan)
    gi, gk = np.arange(200), np.zeros(200, np.int64)
    out[gi, gk] = 1.0 / 1001
    cuda_kernels.reset_launches()
    profiling.reset_timings()
    worker = gev.DeferredGEV("t")
    worker.submit(torch.as_tensor(rows, device=cuda_device), gi, gk, out,
                  "bootstrap")
    worker.finish()
    assert cuda_kernels.LAUNCHES[cuda_kernels.GEV] == 1
    found = profiling.counters()
    assert found["t.gev.host_rows"] >= 2
    names = set(profiling.timings())
    assert "t.gev.refine.wait" not in names and "t.gev.fit" in names
    stats, nulls = gev.split_rows(rows, "bootstrap")
    want = gev.gev_refine_batch(stats, nulls, np.full(200, 1.0 / 1001))
    np.testing.assert_allclose(out[gi, gk], want, rtol=P_RTOL_ALL)
