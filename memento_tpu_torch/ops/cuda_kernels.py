"""Wrappers of the hand-written CUDA kernels.

``fused_bootstrap_sums_cuda`` launches ``csrc/cascade_bootstrap.cu`` (the
port of the TPU kernel ``memento_tpu/ops/pallas_kernels.py::
_cascade_chunk_kernel``).  For a tensor on the CPU it runs the plain version,
``ops/sampling.py::fused_bootstrap_sums``; for a CUDA tensor it launches the
kernel or raises.  ``fused_multinomial_sums_cuda`` does the same for
``csrc/multinomial_bootstrap.cu``, the exact sampler's kernel (plain
version: ``ops/sampling.py::fused_multinomial_sums_philox``).
``launch_gev_refine`` launches ``csrc/gev_refine.cu``, the GEV tail refits
of one tile's flagged rows (its inputs and the host's share of the work are
``inference/gev.py``'s).  ``LAUNCHES`` counts kernel launches by kernel, so a run can show that its
main path went through the kernel; ``LAUNCHES_BY_W`` splits the cascade's
count by the number of weights W (2 or 1 from the 1D test, 5 from the 2D
test).  Launches made inside ``device.warming()`` (the tile loop's
first-use warm-up) count in ``WARM_LAUNCHES`` instead.

What depends on the counts alone stays plain tensor operations here, as the
JAX package computes them outside its Pallas call (``cascade_inputs``): the
conditional ratios and tail sums, each row's last occupied bin, and the order
in which the blocks take the rows (longest first, so that the last wave of
blocks does not wait for one long row).  ``launch_cascade`` and
``launch_multinomial`` are the launches alone.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import is_warming
from ..utils import profiling
from . import kernel_build, sampling

SUPPORTED_W = (1, 2, 5)
CASCADE = "cascade_bootstrap"
MULTINOMIAL = "multinomial_bootstrap"
GEV = "gev_refine"
LAUNCHES = {CASCADE: 0, MULTINOMIAL: 0, GEV: 0}
LAUNCHES_BY_W = {w: 0 for w in SUPPORTED_W}  # the cascade's
WARM_LAUNCHES = {CASCADE: 0, MULTINOMIAL: 0, GEV: 0}
GEV_OUT_COLS = 5  # p-value, status, left stage, right stage, values fitted


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_BY_W, WARM_LAUNCHES):
        for name in counts:
            counts[name] = 0


def count_launch(w_dim: int, kernel: str = CASCADE) -> None:
    """Count one launch of ``kernel`` with ``w_dim`` weights: in
    ``WARM_LAUNCHES`` inside ``device.warming()``, else in ``LAUNCHES`` (and,
    for the cascade, ``LAUNCHES_BY_W``)."""
    if is_warming():
        WARM_LAUNCHES[kernel] += 1
        return
    LAUNCHES[kernel] += 1
    if kernel == CASCADE:
        LAUNCHES_BY_W[w_dim] += 1


def _cascade_library():
    lib = kernel_build.load(CASCADE)
    fn = lib.cascade_bootstrap_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong, p]
        fn.restype = ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.cascade_bootstrap_resources.argtypes = [ctypes.c_int, ip, ip, ip]
        lib.cascade_bootstrap_resources.restype = ctypes.c_int
    return lib


def cascade_ptxas() -> dict:
    """What ptxas reported for each instance when the library was built,
    keyed by W: ``{"registers", "spill_store_bytes", "spill_load_bytes"}``."""
    kernel_build.build([CASCADE])
    usage = kernel_build.ptxas_usage(kernel_build.BUILD_LOG.get(CASCADE, ""))
    return {w: use for w in SUPPORTED_W for entry, use in usage.items()
            if f"ILi{w}E" in entry}


def cascade_resources(w_dim: int) -> dict:
    """Registers per thread, shared memory per block and resident blocks per
    SM of the kernel's instance for ``w_dim`` weights, from the runtime."""
    regs, shared, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = _cascade_library().cascade_bootstrap_resources(
        w_dim, ctypes.byref(regs), ctypes.byref(shared), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"cascade_bootstrap_resources: cudaError {rc}")
    return {"registers": regs.value, "shared_bytes": shared.value,
            "blocks_per_sm": blocks.value}


def cascade_inputs(counts, longest_first: bool = True):
    """What the kernel needs of ``counts [T, U]`` beside them, as plain
    tensor operations with no host synchronisation: ``(ratio, ctail, u_end,
    order)``.  ``u_end [T]`` int32 is 1 + the last occupied bin (0 for an
    empty row); ``order [T]`` int32 is the rows by falling ``u_end``, or in
    index order if ``longest_first`` is false (for timing the difference)."""
    t_dim, u_dim = counts.shape
    ctail, ratio = (x.contiguous() for x in sampling.conditional_ratios(counts))
    bins = torch.arange(1, u_dim + 1, dtype=torch.int32, device=counts.device)
    u_end = torch.where(counts > 0, bins, torch.zeros_like(bins)).amax(dim=1)
    u_end = u_end.to(torch.int32).contiguous()
    if longest_first:
        order = torch.argsort(u_end, descending=True).to(torch.int32)
    else:
        order = torch.arange(t_dim, dtype=torch.int32, device=counts.device)
    return ratio, ctail, u_end, order.contiguous()


def launch_cascade(counts, weights, n_rows, inputs, num_boot: int, seed: int):
    """Launch the kernel on validated CUDA tensors; ``inputs`` is
    ``cascade_inputs(counts)``.  Returns sums ``[T, W, B]``."""
    ratio, ctail, u_end, order = inputs
    t_dim, u_dim = counts.shape
    w_dim = weights.shape[-1]
    out = torch.empty((t_dim, w_dim, num_boot), dtype=torch.float32,
                      device=counts.device)
    launch = _cascade_library().cascade_bootstrap_launch
    stream = torch.cuda.current_stream(counts.device).cuda_stream
    rc = launch(counts.data_ptr(), ratio.data_ptr(), ctail.data_ptr(),
                weights.data_ptr(), n_rows.data_ptr(), u_end.data_ptr(),
                order.data_ptr(), out.data_ptr(), t_dim, u_dim, w_dim,
                num_boot, int(seed) & ((1 << 64) - 1), stream)
    if rc != 0:
        raise RuntimeError(f"cascade_bootstrap launch failed: cudaError {rc}")
    count_launch(w_dim)
    return out


def _check_tile(counts, weights, n_obs):
    """Validate CUDA tiles ``counts [T, U]``, ``weights [T, U, W]``; returns
    ``n_obs`` as a contiguous float32 ``[T]`` on their device."""
    if counts.device.type != "cuda":
        raise ValueError(f"unsupported device {counts.device}")
    if counts.dim() != 2 or weights.dim() != 3 \
            or weights.shape[:2] != counts.shape:
        raise ValueError(f"expected counts [T, U] and weights [T, U, W]; got "
                         f"{tuple(counts.shape)} and {tuple(weights.shape)}")
    if counts.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("counts and weights must be float32")
    if weights.device != counts.device:
        raise ValueError("counts and weights must be on the same device")
    if not (counts.is_contiguous() and weights.is_contiguous()):
        raise ValueError("counts and weights must be contiguous")
    w_dim = weights.shape[-1]
    if w_dim not in SUPPORTED_W:
        raise ValueError(f"W={w_dim} not in {SUPPORTED_W}")
    return torch.broadcast_to(
        torch.as_tensor(n_obs, dtype=torch.float32, device=counts.device),
        (counts.shape[0],)).contiguous()


def _empty_sums(counts, weights, num_boot: int):
    return torch.empty((counts.shape[0], weights.shape[-1], num_boot),
                       dtype=torch.float32, device=counts.device)


def fused_bootstrap_sums_cuda(counts, weights, n_obs, num_boot: int,
                              seed: int):
    """Cascade bootstrap sums ``[T, W, B]`` float32.

    Args:
      counts: ``[T, U]`` float32 multiplicities (pads are 0).
      weights: ``[T, U, W]`` float32, W in (1, 2, 5).
      n_obs: scalar or ``[T]`` float32 trials per row.
      num_boot: replicates B.
      seed: derived 64-bit seed (the kernel's Philox key).
    """
    if counts.device.type == "cpu":
        return sampling.fused_bootstrap_sums(counts, weights, n_obs,
                                             num_boot, seed)
    n_rows = _check_tile(counts, weights, n_obs)
    if counts.shape[0] == 0 or num_boot == 0:
        return _empty_sums(counts, weights, num_boot)
    return launch_cascade(counts, weights, n_rows, cascade_inputs(counts),
                          num_boot, seed)


def _multinomial_library():
    lib = kernel_build.load(MULTINOMIAL)
    fn = lib.multinomial_bootstrap_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong, p]
        fn.restype = ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.multinomial_bootstrap_resources.argtypes = [ctypes.c_int, ip, ip,
                                                        ip]
        lib.multinomial_bootstrap_resources.restype = ctypes.c_int
    return lib


def multinomial_resources(w_dim: int) -> dict:
    """``cascade_resources`` for the multinomial kernel."""
    regs, shared, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = _multinomial_library().multinomial_bootstrap_resources(
        w_dim, ctypes.byref(regs), ctypes.byref(shared), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"multinomial_bootstrap_resources: cudaError {rc}")
    return {"registers": regs.value, "shared_bytes": shared.value,
            "blocks_per_sm": blocks.value}


def launch_multinomial(weights, n_rows, inputs, num_boot: int, seed: int):
    """Launch the multinomial kernel on validated CUDA tensors; ``inputs``
    is ``cascade_inputs(counts)`` (its ``ctail`` is not read).  Returns
    sums ``[T, W, B]``.  Each launch counts once in the counter
    ``multinomial.kernel`` (warm-up included) and in ``count_launch``."""
    ratio, _, u_end, order = inputs
    t_dim, u_dim = ratio.shape
    w_dim = weights.shape[-1]
    out = torch.empty((t_dim, w_dim, num_boot), dtype=torch.float32,
                      device=ratio.device)
    launch = _multinomial_library().multinomial_bootstrap_launch
    stream = torch.cuda.current_stream(ratio.device).cuda_stream
    rc = launch(ratio.data_ptr(), weights.data_ptr(), n_rows.data_ptr(),
                u_end.data_ptr(), order.data_ptr(), out.data_ptr(), t_dim,
                u_dim, w_dim, num_boot, int(seed) & ((1 << 64) - 1), stream)
    if rc != 0:
        raise RuntimeError(
            f"multinomial_bootstrap launch failed: cudaError {rc}")
    count_launch(w_dim, MULTINOMIAL)
    profiling.count("multinomial.kernel")
    return out


def fused_multinomial_sums_cuda(counts, weights, n_obs, num_boot: int,
                                seed: int):
    """Exact multinomial bootstrap sums ``[T, W, B]`` float32: one launch of
    ``csrc/multinomial_bootstrap.cu``, no host synchronisation.  For a
    tensor on the CPU, the kernel's plain version
    (``sampling.fused_multinomial_sums_philox``, the same draws).

    Args: as ``fused_bootstrap_sums_cuda``.
    """
    if counts.device.type == "cpu":
        return sampling.fused_multinomial_sums_philox(counts, weights, n_obs,
                                                      num_boot, seed)
    n_rows = _check_tile(counts, weights, n_obs)
    if counts.shape[0] == 0 or num_boot == 0:
        return _empty_sums(counts, weights, num_boot)
    return launch_multinomial(weights, n_rows, cascade_inputs(counts),
                              num_boot, seed)


def _gev_library():
    lib = kernel_build.load(GEV)
    fn = lib.gev_refine_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.gev_refine_resources.argtypes = [ip, ip, ip]
        lib.gev_refine_resources.restype = ctypes.c_int
    return lib


def load_gev() -> None:
    """Build (at first use) and load the GEV kernel's library."""
    _gev_library()


def gev_resources() -> dict:
    """``cascade_resources`` for the GEV kernel."""
    regs, shared, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = _gev_library().gev_refine_resources(
        ctypes.byref(regs), ctypes.byref(shared), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"gev_refine_resources: cudaError {rc}")
    return {"registers": regs.value, "shared_bytes": shared.value,
            "blocks_per_sm": blocks.value}


def gev_ptxas() -> dict:
    """What ptxas reported for the GEV kernel when its library was built."""
    kernel_build.build([GEV])
    usage = kernel_build.ptxas_usage(kernel_build.BUILD_LOG.get(GEV, ""))
    if len(usage) != 1:
        raise RuntimeError(f"expected one gev_refine entry, got {usage}")
    return next(iter(usage.values()))


def launch_gev_refine(tails, abs_stat, finite, schedule, nm_iters: int):
    """Launch the GEV kernel on one tile's flagged rows, on the current
    stream of their device; no host synchronisation.

    Args:
      tails: ``[M, 2, L0]`` float64 CUDA tensor, each row's ``L0`` smallest
        null values ascending, then its ``L0`` largest ascending.
      abs_stat: ``[M]`` float64, ``|stat|``.
      finite: ``[M]`` bool, false where the row has a non-finite entry.
      schedule: float64 numpy array ``[5 * S + 2]``
        (``gev.kernel_schedule``).
      nm_iters: the Nelder-Mead iteration cap.

    Returns ``[M, GEV_OUT_COLS]`` float64: the p-value (NaN unless refined),
    the status (0 keep the counting p-value, 1 refined, 2 the host decides),
    the accepted stage of each side (1-based, 0 if none) and the values the
    likelihoods went over.  Each launch counts in ``count_launch``.
    """
    if tails.device.type != "cuda":
        raise ValueError(f"unsupported device {tails.device}")
    if tails.dtype != torch.float64 or tails.dim() != 3 \
            or tails.shape[1] != 2 or not tails.is_contiguous():
        raise ValueError("tails must be a contiguous float64 [M, 2, L0]")
    m, _, tail_len = tails.shape
    if abs_stat.shape != (m,) or abs_stat.dtype != torch.float64 \
            or finite.shape != (m,) or finite.dtype != torch.bool:
        raise ValueError("abs_stat [M] float64 and finite [M] bool expected")
    for t in (abs_stat, finite):
        if t.device != tails.device or not t.is_contiguous():
            raise ValueError("inputs must be contiguous on one device")
    n_stages = (len(schedule) - 2) // 5
    if schedule.dtype != np.float64 or len(schedule) != 5 * n_stages + 2:
        raise ValueError("schedule must be float64 [5 * S + 2]")
    out = torch.empty((m, GEV_OUT_COLS), dtype=torch.float64,
                      device=tails.device)
    if m == 0:
        return out
    sched = np.ascontiguousarray(schedule)
    stream = torch.cuda.current_stream(tails.device).cuda_stream
    rc = _gev_library().gev_refine_launch(
        tails.data_ptr(), abs_stat.data_ptr(), finite.data_ptr(),
        out.data_ptr(), m, tail_len, int(nm_iters),
        sched.ctypes.data_as(ctypes.c_void_p), n_stages, stream)
    if rc != 0:
        raise RuntimeError(f"gev_refine launch failed: cudaError {rc}")
    count_launch(0, GEV)
    return out


__all__ = ["fused_bootstrap_sums_cuda", "fused_multinomial_sums_cuda",
           "cascade_inputs", "launch_cascade", "launch_multinomial",
           "cascade_resources", "multinomial_resources", "cascade_ptxas",
           "launch_gev_refine", "load_gev", "gev_resources", "gev_ptxas",
           "LAUNCHES", "LAUNCHES_BY_W", "WARM_LAUNCHES", "CASCADE",
           "MULTINOMIAL", "GEV", "GEV_OUT_COLS", "reset_launches",
           "count_launch"]
