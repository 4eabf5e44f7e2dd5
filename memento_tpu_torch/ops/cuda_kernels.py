"""Wrappers of the hand-written CUDA kernels.

Each kernel is one entry of ``KERNELS`` (the argtypes of its symbols
``<name>_launch`` and ``<name>_resources`` in the library
``build.LIBRARIES[name]``), served by ``_library``, ``_launch``,
``resources`` and ``ptxas``.  The wrappers are the one place that chooses
by device (``on_card``): a CUDA tensor launches the kernel, a CPU tensor
runs the program's CPU path, any other device raises.
``fused_bootstrap_sums_cuda`` launches ``csrc/cascade_bootstrap.cu`` (the
port of the TPU kernel ``memento_tpu/ops/pallas_kernels.py::
_cascade_chunk_kernel``), on the CPU the plain cascade
(``ops/sampling.py::fused_bootstrap_sums``); ``fused_multinomial_sums_cuda``
launches ``csrc/multinomial_bootstrap.cu``, the exact sampler's kernel, on
the CPU the ``torch.binomial`` chain (``fused_bootstrap_sums(...,
sampler="multinomial")``).  Their draw-for-draw references on the kernels'
Philox streams are ``sampling.fused_bootstrap_sums_philox`` and
``sampling.fused_multinomial_sums_philox``.  ``launch_gev_refine``
launches ``csrc/gev_refine.cu``, the GEV tail refits of one tile's flagged
rows (its inputs, the host's share and the choice of card or host worker
are ``inference/gev.py``'s).  ``LAUNCHES`` counts launches by kernel, so a
run can show that its main path went through the kernel; ``LAUNCHES_BY_W``
splits the cascade's count by the number of weights W (2 or 1 from the 1D
test, 5 from the 2D test).  Launches inside ``device.warming()`` (the tile
loop's first-use warm-up) count in ``WARM_LAUNCHES`` instead.

What depends on the counts alone stays plain tensor operations here, as the
JAX package computes them outside its Pallas call (``cascade_inputs``): the
conditional ratios and tail sums, each row's last occupied bin, and the order
in which the blocks take the rows (longest first, so that the last wave of
blocks does not wait for one long row).  ``launch_cascade`` and
``launch_multinomial`` are the launches alone.
"""

from __future__ import annotations

import ctypes
import re

import numpy as np
import torch

from .. import build
from ..device import is_warming
from . import sampling

SUPPORTED_W = (1, 2, 5)
CASCADE = "cascade_bootstrap"
MULTINOMIAL = "multinomial_bootstrap"
GEV = "gev_refine"
_P, _I, _IP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
# per kernel: the argtypes of ``<name>_launch`` and of ``<name>_resources``
# (each returns a cudaError_t)
KERNELS = {
    CASCADE: ([_P] * 8 + [_I] * 4 + [ctypes.c_ulonglong, _P],
              [_I, _IP, _IP, _IP]),
    MULTINOMIAL: ([_P] * 6 + [_I] * 4 + [ctypes.c_ulonglong, _P],
                  [_I, _IP, _IP, _IP]),
    GEV: ([_P] * 4 + [_I] * 3 + [_P, _I, _P], [_IP, _IP, _IP]),
}
LAUNCHES = {name: 0 for name in KERNELS}
LAUNCHES_BY_W = {w: 0 for w in SUPPORTED_W}  # the cascade's
WARM_LAUNCHES = {name: 0 for name in KERNELS}
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


def on_card(device) -> bool:
    """Whether a kernel runs on ``device``: true for a CUDA device, false
    for the CPU (where the program's CPU path runs); any other device
    raises."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _library(name: str):
    """Kernel ``name``'s library, built and loaded on first use, with its
    two symbols' argtypes set."""
    lib = build.load(name)
    launch = getattr(lib, f"{name}_launch")
    if launch.argtypes is None:
        launch_args, resources_args = KERNELS[name]
        query = getattr(lib, f"{name}_resources")
        query.argtypes, query.restype = resources_args, ctypes.c_int
        launch.restype = ctypes.c_int
        launch.argtypes = launch_args
    return lib


def _launch(name: str, w_dim: int, device, *args) -> None:
    """Launch kernel ``name`` with ``args`` on the current stream of
    ``device`` and count the launch (``count_launch``)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):  # the stream's device
        rc = getattr(_library(name), f"{name}_launch")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    count_launch(w_dim, name)


def resources(name: str, *args) -> dict:
    """Registers per thread, shared memory per block and resident blocks per
    SM of kernel ``name`` from the runtime; ``args`` pick the instance (W
    for the cascade and the multinomial kernel, none for the GEV kernel)."""
    regs, shared, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = getattr(_library(name), f"{name}_resources")(
        *args, ctypes.byref(regs), ctypes.byref(shared), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"{name}_resources: cudaError {rc}")
    return {"registers": regs.value, "shared_bytes": shared.value,
            "blocks_per_sm": blocks.value}


def ptxas(name: str) -> dict:
    """What ptxas reported for each instance of kernel ``name`` when its
    library was built, keyed by the instance's W (0 for a kernel that is
    not templated on it): ``{"registers", "spill_store_bytes",
    "spill_load_bytes"}``."""
    build.build([name])
    usage = {}
    for entry, body in re.findall(
            r"Compiling entry function '(\S+?)'(.*?)(?=Compiling entry|\Z)",
            build.BUILD_LOG[name]["log"], flags=re.S):
        w_dim = re.search(r"ILi(\d+)E", entry)
        found = {key: re.search(rx, body) for key, rx in (
            ("registers", r"Used (\d+) registers"),
            ("spill_store_bytes", r"(\d+) bytes spill stores"),
            ("spill_load_bytes", r"(\d+) bytes spill loads"))}
        usage[int(w_dim.group(1)) if w_dim else 0] = {
            key: int(m.group(1)) if m else None for key, m in found.items()}
    return usage


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
    _launch(CASCADE, w_dim, counts.device, counts.data_ptr(),
            ratio.data_ptr(), ctail.data_ptr(), weights.data_ptr(),
            n_rows.data_ptr(), u_end.data_ptr(), order.data_ptr(),
            out.data_ptr(), t_dim, u_dim, w_dim, num_boot,
            int(seed) & ((1 << 64) - 1))
    return out


def _check_tile(counts, weights, n_obs):
    """Validate CUDA tiles ``counts [T, U]``, ``weights [T, U, W]``; returns
    ``n_obs`` as a contiguous float32 ``[T]`` on their device."""
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
    if not on_card(counts.device):
        return sampling.fused_bootstrap_sums(counts, weights, n_obs,
                                             num_boot, seed)
    n_rows = _check_tile(counts, weights, n_obs)
    if counts.shape[0] == 0 or num_boot == 0:
        return _empty_sums(counts, weights, num_boot)
    return launch_cascade(counts, weights, n_rows, cascade_inputs(counts),
                          num_boot, seed)


def launch_multinomial(weights, n_rows, inputs, num_boot: int, seed: int):
    """Launch the multinomial kernel on validated CUDA tensors; ``inputs``
    is ``cascade_inputs(counts)`` (its ``ctail`` is not read).  Returns
    sums ``[T, W, B]``."""
    ratio, _, u_end, order = inputs
    t_dim, u_dim = ratio.shape
    w_dim = weights.shape[-1]
    out = torch.empty((t_dim, w_dim, num_boot), dtype=torch.float32,
                      device=ratio.device)
    _launch(MULTINOMIAL, w_dim, ratio.device, ratio.data_ptr(),
            weights.data_ptr(), n_rows.data_ptr(), u_end.data_ptr(),
            order.data_ptr(), out.data_ptr(), t_dim, u_dim, w_dim, num_boot,
            int(seed) & ((1 << 64) - 1))
    return out


def fused_multinomial_sums_cuda(counts, weights, n_obs, num_boot: int,
                                seed: int):
    """Exact multinomial bootstrap sums ``[T, W, B]`` float32: one launch of
    ``csrc/multinomial_bootstrap.cu``, no host synchronisation.  For a
    tensor on the CPU, the ``torch.binomial`` chain
    (``sampling.fused_bootstrap_sums(..., sampler="multinomial")``).

    Args: as ``fused_bootstrap_sums_cuda``.
    """
    if not on_card(counts.device):
        return sampling.fused_bootstrap_sums(counts, weights, n_obs,
                                             num_boot, seed,
                                             sampler="multinomial")
    n_rows = _check_tile(counts, weights, n_obs)
    if counts.shape[0] == 0 or num_boot == 0:
        return _empty_sums(counts, weights, num_boot)
    return launch_multinomial(weights, n_rows, cascade_inputs(counts),
                              num_boot, seed)


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
    likelihoods went over.
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
    _launch(GEV, 0, tails.device, tails.data_ptr(), abs_stat.data_ptr(),
            finite.data_ptr(), out.data_ptr(), m, tail_len, int(nm_iters),
            sched.ctypes.data_as(ctypes.c_void_p), n_stages)
    return out


__all__ = ["fused_bootstrap_sums_cuda", "fused_multinomial_sums_cuda",
           "cascade_inputs", "launch_cascade", "launch_multinomial",
           "launch_gev_refine", "on_card", "resources", "ptxas", "KERNELS",
           "LAUNCHES", "LAUNCHES_BY_W", "WARM_LAUNCHES", "CASCADE",
           "MULTINOMIAL", "GEV", "GEV_OUT_COLS", "reset_launches",
           "count_launch"]
