"""The port's native host layer (``memento_tpu_torch/native``) against the
JAX package's own native layer (``memento_tpu/native``) on the CPU.

Both libraries are built from their own copies of the C++ sources and loaded
in this one process (each ctypes handle resolves its own symbols).  Inputs
come from a numpy seed.  The packers must equal the JAX package's native
packers field for field (the group packer also the port's numpy packer as
combos per gene, the pair packer slot for slot); the float64 sums agree to
rtol 1e-12, since their order of addition follows the OpenMP thread split.
"""

import os
import pathlib
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sparse
import torch

import memento_tpu as mt
from memento_tpu import native as j_native
from memento_tpu.models.simulate import simulate_two_groups
from memento_tpu.ops import compress as j_compress
from memento_tpu.ops import corr as j_corr
from memento_tpu.ops import estimators as j_est
from memento_tpu.ops import size_factor as j_sf

import memento_tpu_torch as mtt
from memento_tpu_torch import api as t_api
from memento_tpu_torch import native as t_native
from memento_tpu_torch import build
from memento_tpu_torch.ops import compress as t_compress
from memento_tpu_torch.ops import corr as t_corr
from memento_tpu_torch.ops import estimators as t_est
from memento_tpu_torch.ops import size_factor as t_sf

# tier-1 runs several pytest workers at once: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
GROUP_FIELDS = ("values", "counts", "inv_sf", "inv_sf_sq", "n_unique",
                "sf_bin", "bin_inv_sf")
PAIR_FIELDS = ("values_1", "values_2", "counts", "inv_sf", "inv_sf_sq",
               "n_unique", "sf_bin", "bin_inv_sf")


def _matrix(rng, n=500, g=30, fmt="csc", idx=np.int32, dtype=np.float32):
    """Gamma-Poisson counts with an all-zero gene (3) and a few values
    above 255, in the given sparse format and index / data dtypes."""
    lam = rng.gamma(2.0, rng.uniform(0.1, 4.0, g) / 2.0, size=(n, g))
    X = rng.poisson(lam).astype(np.float64)
    X[:, 3] = 0.0
    X[::37, 5] = 300.0
    X = sparse.csc_matrix(X) if fmt == "csc" else sparse.csr_matrix(X)
    X.data = X.data.astype(dtype)
    X.indices = X.indices.astype(idx)
    X.indptr = X.indptr.astype(idx)
    return X


def _approx(rng, n, num_bins=30):
    return j_sf.bin_size_factor(rng.uniform(0.4, 2.5, n), num_bins)


def _assert_fields(got, want, fields):
    assert got.n_obs == want.n_obs
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f
        else:
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)


def _combos(c, j):
    """Gene j's (value, inv_sf, count, bin) combos, sorted."""
    u = c.n_unique[j]
    arr = np.stack([c.values[j, :u], c.inv_sf[j, :u], c.counts[j, :u],
                    c.sf_bin[j, :u]], axis=1)
    return arr[np.lexsort(arr.T[::-1])]


def _assert_same_combos(got, ref):
    """Equal as combos per gene (the native group packer's nonzero combos
    come in first-seen order), padding inert."""
    np.testing.assert_array_equal(got.n_unique, ref.n_unique)
    assert got.padded_u == ref.padded_u
    for j in range(len(ref.n_unique)):
        np.testing.assert_array_equal(_combos(got, j), _combos(ref, j))
        u = ref.n_unique[j]
        assert not got.counts[j, u:].any()
        assert (got.inv_sf[j, u:] == 1.0).all()
        assert not got.sf_bin[j, u:].any()


def _pairs(rng, g, n):
    """Random pairs plus a duplicate, a reversed pair, a self-pair and pairs
    with the all-zero gene 3."""
    idx1 = rng.integers(0, g, n)
    idx2 = rng.integers(0, g, n)
    return (np.r_[idx1, idx1[0], idx2[1], 5, 3, 7, 3],
            np.r_[idx2, idx2[0], idx1[1], 5, 9, 3, 3])


@pytest.mark.parametrize("cols", [None, (4, 21)])
@pytest.mark.parametrize("fmt,idx,dtype", [
    ("csc", np.int32, np.float32), ("csc", np.int64, np.float64),
    ("csc", np.int32, np.float64), ("csr", np.int32, np.float32),
    ("dense", np.int32, np.float64)])
def test_group_packer_exact(rng, cols, fmt, idx, dtype):
    """CSC takes the zero-copy range path, CSR and dense the compact
    (rounding) path: every field equals the JAX native packer's."""
    X = _matrix(rng, fmt="csr" if fmt == "csr" else "csc", idx=idx,
                dtype=dtype)
    if fmt == "dense":
        X = X.toarray()
    approx = _approx(rng, X.shape[0])
    before = dict(t_native.CALLS)
    got = t_compress.compress_group(X, approx, cols=cols)
    path = "compress_group_range" if fmt == "csc" else "compress_group"
    assert t_native.CALLS[path] == before[path] + 1
    want = j_compress.compress_group(X, approx, backend="native", cols=cols)
    _assert_fields(got, want, GROUP_FIELDS)
    _assert_same_combos(got, t_compress.compress_group(
        X, approx, backend="numpy", cols=cols))


@pytest.mark.parametrize("idx,dtype", [(np.int32, np.float32),
                                       (np.int64, np.float64),
                                       (np.int64, np.float32)])
def test_pair_packer_v2_exact(rng, idx, dtype):
    """Integral data, read as stored: equal to the JAX native packer and to
    the port's numpy packer, slot for slot."""
    X = _matrix(rng, idx=idx, dtype=dtype)
    approx = _approx(rng, X.shape[0])
    idx1, idx2 = _pairs(rng, X.shape[1], 40)
    before = t_native.CALLS["compress_pairs"]
    got = t_compress.compress_pairs(X, approx, idx1, idx2)
    assert t_native.CALLS["compress_pairs"] == before + 1
    _assert_fields(got, j_native.compress_pairs_native(X, approx, idx1, idx2),
                   PAIR_FIELDS)
    _assert_fields(got, t_compress.compress_pairs(X, approx, idx1, idx2,
                                                  backend="numpy"),
                   PAIR_FIELDS)
    np.testing.assert_array_equal(got.counts.sum(1), X.shape[0])


@pytest.mark.parametrize("kind", ["fractional", "int64_data"])
def test_pair_packer_rounding_path_exact(rng, kind):
    """Fractional data (rounded half to even as the C++ reads it), or data
    in an integer dtype (read as stored): still equal to both packers."""
    X = _matrix(rng, dtype=np.float64)
    if kind == "fractional":
        X.data[::3] += 0.3
    else:
        X.data = X.data.astype(np.int64)
    approx = _approx(rng, X.shape[0])
    idx1, idx2 = _pairs(rng, X.shape[1], 30)
    got = t_compress.compress_pairs(X, approx, idx1, idx2, backend="native")
    _assert_fields(got, j_native.compress_pairs_native(X, approx, idx1, idx2),
                   PAIR_FIELDS)
    _assert_fields(got, t_compress.compress_pairs(X, approx, idx1, idx2,
                                                  backend="numpy"),
                   PAIR_FIELDS)


@pytest.mark.parametrize("kind", ["fractional", "int64_data"])
def test_pair_packer_checks_the_data_once_per_matrix(rng, monkeypatch, kind):
    """Data the range prep does not cover gets its verdict once per matrix:
    later tiles of the same matrix reuse it, and an in-place edit is still
    packed as a fresh copy packs it."""
    X = _matrix(rng, dtype=np.float64)
    if kind == "fractional":
        X.data[::3] += 0.3
    else:
        X.data = X.data.astype(np.int64)
    approx = _approx(rng, X.shape[0])
    scans = []
    stats = t_native._rounded_stats
    monkeypatch.setattr(t_native, "_rounded_stats",
                        lambda d: scans.append(d.size) or stats(d))
    idx1, idx2 = _pairs(rng, X.shape[1], 30)
    for lo in range(0, 30, 10):  # three tiles of one matrix
        t_compress.compress_pairs(X, approx, idx1[lo:lo + 10],
                                  idx2[lo:lo + 10], backend="native")
    assert scans == [X.nnz]
    X.data[::2] = X.data[::2] * 2 + 1  # past the cached largest value
    got = t_compress.compress_pairs(X, approx, idx1, idx2, backend="native")
    assert len(scans) == 2
    _assert_fields(got, t_compress.compress_pairs(X.copy(), approx, idx1,
                                                  idx2, backend="numpy"),
                   PAIR_FIELDS)


def test_fractional_data_leaves_the_range_path(rng):
    """Non-integral data is refused by the zero-copy range packer and
    rounded by the compact packer, as in the JAX package: the numpy packer's
    combos; float64 sums of data not exact in float32 take scipy."""
    X = _matrix(rng, dtype=np.float64)
    X.data[::4] += 0.3
    approx = _approx(rng, X.shape[0])
    assert t_native.compress_group_range_native(X, approx, 0, 30) is None
    before = dict(t_native.CALLS)
    got = t_compress.compress_group(X, approx)
    assert t_native.CALLS["compress_group"] == before["compress_group"] + 1
    _assert_fields(got, j_compress.compress_group(X, approx,
                                                  backend="native"),
                   GROUP_FIELDS)
    _assert_same_combos(got, t_compress.compress_group(X, approx,
                                                       backend="numpy"))
    sf = rng.uniform(0.5, 2.0, X.shape[0])
    for w, g in zip(j_est.suffstats_sparse(X, sf),
                    t_est.suffstats_sparse(X, sf)):
        np.testing.assert_allclose(g, w, rtol=1e-12)
    assert t_native.CALLS["suffstats_csc"] == before["suffstats_csc"]


def test_negative_data_is_refused(rng):
    """Negative counts never reach the C++ (its histograms would be indexed
    out of bounds): the wrappers refuse them and ``backend='native'``
    raises."""
    X = _matrix(rng, dtype=np.float64)
    X.data[::9] *= -1
    approx = _approx(rng, X.shape[0])
    assert t_native.compress_group_range_native(X, approx, 0, 30) is None
    assert t_native.compress_group_native(X, approx) is None
    assert t_native.compress_pairs_native(X, approx, [0, 1], [2, 5]) is None
    with pytest.raises(ValueError, match="native packer"):
        t_compress.compress_group(X, approx, backend="native")
    with pytest.raises(ValueError, match="native pair packer"):
        t_compress.compress_pairs(X, approx, [0], [1], backend="native")


@pytest.mark.parametrize("packer", ["group", "pair"])
@pytest.mark.parametrize("edit", ["add_half", "negative"])
def test_in_place_edit_of_the_data_is_seen(rng, packer, edit):
    """The packers cache their verdict on the matrix (integral, non-negative,
    largest value); an in-place edit of ``X.data`` that keeps nnz must pack
    what a fresh copy packs, and negative counts must raise as they do on a
    fresh copy.  The JAX package keeps the same cache, so the references are
    a fresh copy and the port's numpy packer."""
    X = sparse.csc_matrix(rng.poisson(2.0, size=(200, 5)).astype(np.float64))
    approx = _approx(rng, 200)
    idx1, idx2 = np.array([0, 1, 2, 4]), np.array([3, 4, 0, 2])

    def pack(M, backend="native"):
        if packer == "group":
            return t_compress.compress_group(M, approx, backend=backend)
        return t_compress.compress_pairs(M, approx, idx1, idx2,
                                         backend=backend)

    pack(X)  # caches the verdict on the integer data
    nnz = X.nnz
    if edit == "add_half":
        X.data += 0.5
    else:
        X.data[rng.choice(nnz, 5, replace=False)] = -3.0
    assert X.nnz == nnz
    if edit == "negative":
        with pytest.raises(ValueError, match="native"):
            pack(X)
        with pytest.raises(ValueError, match="native"):
            pack(X.copy())
        return
    got = pack(X)
    fields = GROUP_FIELDS if packer == "group" else PAIR_FIELDS
    _assert_fields(got, pack(X.copy()), fields)
    if packer == "group":
        _assert_same_combos(got, pack(X.copy(), "numpy"))
        # k + 0.5 rounds half to even: only even values are packed
        assert not np.any(got.values % 2)
    else:
        _assert_fields(got, pack(X.copy(), "numpy"), fields)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bad", [None, 0.5, -1.0, np.inf, np.nan])
def test_zero_copy_paths_take_the_data_jax_takes(rng, dtype, bad):
    """The integrality check of the zero-copy paths accepts exactly the data
    the JAX package's accepts (finite, integral, non-negative)."""
    X = _matrix(rng, dtype=dtype)
    if bad is not None:
        X.data[7] = bad
    approx = _approx(rng, X.shape[0])
    want = j_native._compress_range_prep(X, approx)
    got = t_native._compress_range_prep(X, approx)
    assert (got is None) == (want is None)
    if got is not None:
        assert got[4] == int(X.data.max())
        for g, w in zip(got[:4], want):
            np.testing.assert_array_equal(g, w)


def test_new_size_factor_array_invalidates_the_range_cache(rng):
    X = _matrix(rng)
    a = _approx(rng, X.shape[0])
    b = _approx(rng, X.shape[0], num_bins=12)
    first = t_compress.compress_group(X, a)
    second = t_compress.compress_group(X, b)
    _assert_fields(second, j_compress.compress_group(X, b, backend="native"),
                   GROUP_FIELDS)
    assert not np.array_equal(first.bin_inv_sf, second.bin_inv_sf)
    # the same values in a new array: a fresh (equal) prep
    _assert_fields(t_compress.compress_group(X, a.copy()), first,
                   GROUP_FIELDS)


def test_more_than_254_bins_leaves_no_compact_form(rng):
    X = _matrix(rng, n=600, g=8)
    approx = rng.uniform(0.5, 2.0, 600)  # every cell its own bin
    got = t_compress.compress_group(X, approx)
    assert got.sf_bin is None and got.bin_inv_sf is None
    _assert_fields(got, j_compress.compress_group(X, approx, backend="native"),
                   GROUP_FIELDS)
    pairs = t_compress.compress_pairs(X, approx, [0, 1, 4], [2, 5, 4])
    assert pairs.sf_bin is None
    _assert_fields(pairs, j_native.compress_pairs_native(
        X, approx, [0, 1, 4], [2, 5, 4]), PAIR_FIELDS)


def test_empty_group_and_empty_pair_list(rng):
    X = _matrix(rng, n=0, g=6)
    approx = np.zeros(0)
    got = t_compress.compress_group(X, approx)
    want = j_compress.compress_group(X, approx, backend="native")
    _assert_fields(got, want, GROUP_FIELDS)
    assert got.n_obs == 0 and not got.n_unique.any()
    Y = _matrix(rng, n=200, g=6)
    a = _approx(rng, 200)
    empty = t_compress.compress_pairs(Y, a, [], [])
    _assert_fields(empty, t_compress.compress_pairs(Y, a, [], [],
                                                    backend="numpy"),
                   PAIR_FIELDS)
    assert empty.counts.shape == (0, 8)


def test_all_zero_gene_is_one_combo_per_bin(rng):
    X = _matrix(rng)
    approx = _approx(rng, X.shape[0])
    got = t_compress.compress_group(X, approx, cols=(3, 4))
    n_bins = len(np.unique(approx))
    assert got.n_unique[0] == n_bins
    assert not got.values.any() and got.counts.sum() == X.shape[0]


def test_pair_indices_are_checked(rng):
    X = _matrix(rng, g=6)
    with pytest.raises(IndexError):
        t_compress.compress_pairs(X, _approx(rng, X.shape[0]), [0], [6])
    with pytest.raises(IndexError):
        t_native.pair_prods_csc_native(X, np.ones(X.shape[0]), [-1], [2])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sums_match_jax_native(rng, dtype):
    """Every float64 sum against the JAX native layer and against scipy:
    rtol 1e-12."""
    Xr = _matrix(rng, n=700, g=40, fmt="csr", dtype=dtype)
    Xc = Xr.tocsc()
    sf = rng.uniform(0.5, 2.0, Xr.shape[0])
    mask = rng.random(Xr.shape[1]) < 0.4
    before = dict(t_native.CALLS)

    for X, want in ((Xr, j_native.suffstats_csr_native(Xr, sf)),
                    (Xc, j_native.suffstats_csc_native(Xc, sf))):
        got = t_est.suffstats_sparse(X, sf)
        for w, g, s in zip(want, got, t_est.suffstats_scipy(X, sf)):
            np.testing.assert_allclose(g, w, rtol=1e-12)
            np.testing.assert_allclose(g, s, rtol=1e-12)

    for m in (None, mask):
        got = t_native.row_sums_csr_native(Xr, mask=m)
        want = j_native.row_sums_csr_native(Xr, mask=m)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
        assert (got[1] is None) == (m is None)
        if m is not None:
            np.testing.assert_allclose(got[1], want[1], rtol=1e-12)
    # CSC takes scipy's sums, in float64 here: scipy sums float32 data in
    # float32, while the native pass reads it into float64 accumulators
    Xc64 = Xc.astype(np.float64)
    np.testing.assert_allclose(
        t_sf.estimate_size_factor(Xr, mask=mask, shrinkage=0.5),
        t_sf.estimate_size_factor(Xc64, mask=mask, shrinkage=0.5),
        rtol=1e-12)
    np.testing.assert_allclose(
        t_sf.estimate_size_factor(Xr, total=True),
        j_sf.estimate_size_factor(Xr, total=True), rtol=1e-12)

    cs, cn = t_native.col_sums_csr_native(Xr)
    jcs, jcn = j_native.col_sums_csr_native(Xr)
    np.testing.assert_allclose(cs, jcs, rtol=1e-12)
    np.testing.assert_array_equal(cn, jcn)
    np.testing.assert_allclose(t_api._obs_mean(Xr), t_api._obs_mean(Xc64),
                               rtol=1e-12)

    idx1, idx2 = _pairs(rng, Xr.shape[1], 50)  # idx1 == idx2 included
    w2 = (1.0 / sf) ** 2
    prod = t_corr.pair_prods(Xc, w2, idx1, idx2)
    np.testing.assert_allclose(
        prod, j_native.pair_prods_csc_native(Xc, w2, idx1, idx2), rtol=1e-12)
    np.testing.assert_allclose(
        prod, t_corr.pair_prods_scipy(Xc, w2, idx1, idx2), rtol=1e-12)
    np.testing.assert_allclose(
        t_corr.cov_sparse_pairs(Xc, sf, 0.1, idx1, idx2, t_est.HYPER_RELATIVE),
        j_corr.cov_sparse_pairs(Xc, sf, 0.1, idx1, idx2, j_est.HYPER_RELATIVE),
        rtol=1e-12, atol=1e-15)
    for name in ("suffstats_csr", "suffstats_csc", "row_sums_csr",
                 "col_sums_csr", "pair_prods_csc"):
        assert t_native.CALLS[name] > before[name], name


def test_zero_size_factor_on_a_nonempty_cell_raises(rng):
    X = _matrix(rng, n=200, g=10, fmt="csr")
    X = sparse.csr_matrix(X.toarray()[np.r_[0:199, 0]])
    X[199, :] = 0.0
    X.eliminate_zeros()  # cell 199 is empty
    sf = rng.uniform(0.5, 2.0, 200)
    sf[199] = 0.0  # valid: an all-zero cell
    for m in (X, X.tocsc()):
        for w, g in zip(j_est.suffstats_sparse(m, sf),
                        t_est.suffstats_sparse(m, sf)):
            np.testing.assert_allclose(g, w, rtol=1e-12)
    sf[3] = 0.0  # cell 3 has counts
    for m in (X, X.tocsc()):
        with pytest.raises(ValueError, match="size_factor contains 0"):
            t_est.suffstats_sparse(m, sf)


def test_failed_build_raises(rng, monkeypatch):
    """A compiler that is missing or fails raises RuntimeError with its
    message, through the packers too: never a quiet numpy result."""
    X = _matrix(rng, g=6)
    approx = _approx(rng, X.shape[0])
    native = build.LIBRARIES["native"]
    monkeypatch.delitem(build._LOADED, "native", raising=False)
    monkeypatch.setitem(build.LIBRARIES, "native", native._replace(
        compiler="no-such-compiler-for-memento"))
    with pytest.raises(RuntimeError, match="no-such-compiler-for-memento"):
        t_compress.compress_group(X, approx)
    monkeypatch.setitem(build.LIBRARIES, "native", native._replace(
        flags=native.flags + ("-fno-such-memento-flag",)))
    with pytest.raises(RuntimeError, match="no-such-memento-flag"):
        t_compress.compress_pairs(X, approx, [0], [1])
    with pytest.raises(RuntimeError, match="native build failed"):
        t_est.suffstats_sparse(X, np.ones(X.shape[0]))
    assert not list(build.BUILD_DIR.glob("libnative-*.tmp"))


def test_library_is_keyed_on_sources_flags_compiler_and_cpu(monkeypatch,
                                                          tmp_path):
    path = build.library_path("native")
    assert path.parent == REPO / "memento_tpu_torch" / "_build"
    assert path.name.startswith("libnative-") and path.suffix == ".so"
    native = build.LIBRARIES["native"]
    monkeypatch.setitem(build.LIBRARIES, "native",
                        native._replace(flags=native.flags[:-1]))
    assert build.library_path("native") != path
    edited = tmp_path / "compress.cpp"
    edited.write_bytes((build.PACKAGE_DIR / native.sources[0]).read_bytes()
                       + b"\n")
    monkeypatch.setitem(build.LIBRARIES, "native", native._replace(
        sources=(str(edited),) + native.sources[1:]))
    assert build.library_path("native") != path
    monkeypatch.setitem(build.LIBRARIES, "native", native)
    assert build.library_path("native") == path
    version = build.compiler_version("g++")
    monkeypatch.setattr(build, "compiler_version", lambda c: version + "x")
    assert build.library_path("native") != path
    monkeypatch.undo()
    monkeypatch.setattr(build, "_cpu_fingerprint", lambda: b"another cpu")
    assert build.library_path("native") != path


def test_kernel_library_is_keyed_on_source_flags_and_nvcc(monkeypatch,
                                                         tmp_path):
    """A CUDA kernel's library name follows its source, its flags and
    ``nvcc --version`` (stubbed here: no nvcc is needed to name it), and
    not the host's CPU."""
    nvcc = ["Cuda compilation tools, release 12.8, V12.8.93\n"]
    monkeypatch.setattr(build, "compiler_version", lambda c: {
        "nvcc": nvcc[0]}[c])
    path = build.library_path("gev_refine")
    assert path.name.startswith("libgev_refine-") and path.suffix == ".so"
    assert path != build.library_path("cascade_bootstrap")
    monkeypatch.setattr(build, "_cpu_fingerprint", lambda: b"another cpu")
    assert build.library_path("gev_refine") == path
    nvcc[0] = "Cuda compilation tools, release 12.9, V12.9.41\n"
    assert build.library_path("gev_refine") != path
    nvcc.pop()
    nvcc.append("Cuda compilation tools, release 12.8, V12.8.93\n")
    lib = build.LIBRARIES["gev_refine"]
    monkeypatch.setitem(build.LIBRARIES, "gev_refine",
                        lib._replace(flags=lib.flags[:-1]))
    assert build.library_path("gev_refine") != path
    edited = tmp_path / "gev_refine.cu"
    edited.write_bytes((build.PACKAGE_DIR / lib.sources[0]).read_bytes()
                       + b"\n")
    monkeypatch.setitem(build.LIBRARIES, "gev_refine",
                        lib._replace(sources=(str(edited),)))
    assert build.library_path("gev_refine") != path
    monkeypatch.setitem(build.LIBRARIES, "gev_refine", lib)
    assert build.library_path("gev_refine") == path


CONCURRENT_BUILD = textwrap.dedent("""
    import sys
    from pathlib import Path
    from memento_tpu_torch import build
    build.BUILD_DIR = Path(sys.argv[1])
    print(build.load("native")._name)
""")

# a compiler for the concurrency test: slow, counts its compiles
STUB_COMPILER = textwrap.dedent("""\
    #!/bin/sh
    if [ "$1" = "--version" ]; then echo "stub compiler 1.0"; exit 0; fi
    echo compiled >> "$(dirname "$0")/compiles"
    sleep 1
    out=""; while [ $# -gt 0 ]; do
      if [ "$1" = "-o" ]; then out="$2"; shift; fi; shift; done
    echo library > "$out"
""")

STUB_BUILD = textwrap.dedent("""
    import sys
    from pathlib import Path
    from memento_tpu_torch import build
    build.BUILD_DIR = Path(sys.argv[1]) / "_build"
    build.LIBRARIES["stub"] = build.Library(
        sys.argv[1] + "/cc", (sys.argv[1] + "/stub.cu",), ("-O3",))
    print(build.build(["stub"])["stub"])
""")


def test_concurrent_builds_of_any_compiler_make_one_library(tmp_path):
    """Two processes building one library at once (a stand-in compiler,
    as for a CUDA kernel's): one compiles under the library's flock, both
    name the same library, and no ``*.tmp`` is left."""
    cc = tmp_path / "cc"
    cc.write_text(STUB_COMPILER)
    cc.chmod(0o755)
    (tmp_path / "stub.cu").write_text("// a kernel\n")
    procs = [subprocess.Popen([sys.executable, "-c", STUB_BUILD,
                               str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    names = {o.strip() for o, _ in outs}
    assert len(names) == 1
    built = tmp_path / "_build"
    assert [p.name for p in built.glob("*.so")] == \
        [pathlib.Path(names.pop()).name]
    assert not list(built.glob("*.tmp"))
    assert (tmp_path / "compiles").read_text().count("compiled") == 1
    assert (built / "libstub.lock").exists()


def test_concurrent_builds_make_one_library(tmp_path):
    """Three processes loading at once into an empty build directory: one
    compiles (under the flock), all load the same complete library."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", CONCURRENT_BUILD,
                               str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    names = {o.strip() for o, _ in outs}
    assert len(names) == 1
    assert [p.name for p in tmp_path.glob("*.so")] == \
        [pathlib.Path(names.pop()).name]
    assert not list(tmp_path.glob("*.tmp"))


def test_threads_share_the_library_and_counts(rng):
    """More threads than cores call the packers and sums at once (ctypes
    releases the interpreter lock): equal results, no lost count."""
    X = _matrix(rng, n=400, g=20)
    approx = _approx(rng, X.shape[0])
    sf = rng.uniform(0.5, 2.0, X.shape[0])
    ref_g = t_compress.compress_group(X, approx)
    ref_s = t_est.suffstats_sparse(X, sf)
    n_threads, reps = (os.cpu_count() or 1) + 4, 4
    before = dict(t_native.CALLS)
    errors = []

    def work():
        try:
            for _ in range(reps):
                _assert_fields(t_compress.compress_group(X, approx), ref_g,
                               GROUP_FIELDS)
                for a, b in zip(t_est.suffstats_sparse(X, sf), ref_s):
                    np.testing.assert_allclose(a, b, rtol=1e-12)
        except AssertionError as exc:  # reported from the main thread
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    for name in ("compress_group_range", "suffstats_csc"):
        assert t_native.CALLS[name] - before[name] == n_threads * reps


ISOLATED = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "memento_tpu", "pandas"):
        sys.modules[name] = None  # any import of these now raises
    import numpy as np
    import scipy.sparse as sparse
    from memento_tpu_torch import build, native
    from memento_tpu_torch.ops import compress

    rng = np.random.default_rng(5)
    X = sparse.csr_matrix(rng.poisson(1.5, (300, 12)).astype(np.float32))
    C = X.tocsc()
    sf = rng.uniform(0.5, 2.0, 300)
    approx = np.round(sf, 1)
    i1, i2 = np.array([0, 3, 5]), np.array([1, 3, 11])
    native.suffstats_csr_native(X, sf)
    native.suffstats_csc_native(C, sf)
    native.row_sums_csr_native(X, mask=np.arange(12) % 2 == 0)
    native.col_sums_csr_native(X)
    native.pair_prods_csc_native(C, 1 / sf**2, i1, i2)
    native.compress_group_native(X, approx)
    native.compress_group_range_native(C, approx, 2, 9)
    native.compress_pairs_native(C, approx, i1, i2)
    for backend in ("native", "numpy"):
        compress.compress_group(C, approx, backend=backend, cols=(0, 6))
        compress.compress_pairs(C, approx, i1, i2, backend=backend)
    assert all(native.CALLS.values()), native.CALLS
    loaded = [m for m in sys.modules if sys.modules[m] is not None
              and m.split(".")[0] in ("jax", "jaxlib", "memento_tpu",
                                      "pandas")]
    assert not loaded, loaded
    maps = open("/proc/self/maps").read()
    assert "_native.so" not in maps
    assert build.load("native")._name in maps
    print("NATIVE_ISOLATED_OK")
""")


def test_native_layer_runs_without_jax_and_its_library():
    """Every native entry point and both slices' packers, with jax,
    ``memento_tpu`` and pandas blocked; the JAX package's ``_native.so`` is
    never mapped, the port's own library is."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", ISOLATED], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NATIVE_ISOLATED_OK" in proc.stdout


@pytest.fixture(scope="module")
def stages():
    """The host stages of both packages on the same data, float32 counts
    (exact, so every native pass is taken)."""
    rng = np.random.default_rng(12)
    X, cond, rep, qs = simulate_two_groups(
        n_cells_per_group=400, n_genes=36, q=0.1, de_genes=np.arange(4),
        de_lfc=0.6, n_replicates=2, rng=rng)
    X = sparse.csr_matrix(X.astype(np.float32))
    obs = pd.DataFrame({"condition": cond.astype(str),
                        "replicate": rep.astype(str), "capture_q": qs})
    var = pd.DataFrame(index=[f"G{i}" for i in range(X.shape[1])])
    out = {}
    t_native.reset_calls()
    for name, pkg in (("jax", mt), ("port", mtt)):
        ad = pkg.AnnData(X.copy(), obs=obs.copy(), var=var.copy())
        pkg.setup_memento(ad, q_column="capture_q", filter_mean_thresh=0.01,
                          trim_percent=0.3)
        pkg.create_groups(ad, label_columns=["condition", "replicate"])
        pkg.compute_1d_moments(ad, min_perc_group=0.5)
        genes = list(ad.var.index)
        pkg.compute_2d_moments(ad, [(genes[i], genes[(3 * i + 1) % len(genes)])
                                    for i in range(len(genes))]
                               + [(genes[2], genes[2])])
        out[name] = ad
    out["calls"] = dict(t_native.CALLS)
    return out


def test_stage_moments_match_jax_through_native_sums(stages):
    ju = stages["jax"].uns["memento"]
    pu = stages["port"].uns["memento"]
    np.testing.assert_allclose(
        np.asarray(stages["port"].obs["memento_size_factor"]),
        stages["jax"].obs["memento_size_factor"].values, rtol=1e-10)
    for a, b in zip(pu["all_1d_moments"], ju["all_1d_moments"]):
        np.testing.assert_allclose(a, b, rtol=1e-10)
    assert pu["least_variable_genes"] == ju["least_variable_genes"]
    for g in ju["groups"]:
        for a, b in zip(pu["1d_moments"][g], ju["1d_moments"][g]):
            np.testing.assert_allclose(a, b, rtol=1e-10, equal_nan=True)
        for key in ("cov", "corr"):
            np.testing.assert_allclose(pu["2d_moments"][g][key],
                                       ju["2d_moments"][g][key], rtol=1e-10,
                                       atol=1e-14)
    calls = stages["calls"]
    for name in ("row_sums_csr", "suffstats_csr", "col_sums_csr",
                 "suffstats_csc", "pair_prods_csc"):
        assert calls[name] > 0, calls
