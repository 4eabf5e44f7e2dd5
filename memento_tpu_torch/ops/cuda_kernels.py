"""Wrappers of the hand-written CUDA kernels.

``fused_bootstrap_sums_cuda`` launches ``csrc/cascade_bootstrap.cu`` (the
port of the TPU kernel ``memento_tpu/ops/pallas_kernels.py::
_cascade_chunk_kernel``).  For a tensor on the CPU it runs the plain version,
``ops/sampling.py::fused_bootstrap_sums``; for a CUDA tensor it launches the
kernel or raises.  ``LAUNCHES`` counts kernel launches, so a run can show
that its main path went through the kernel; ``LAUNCHES_BY_W`` splits the
same count by the number of weights W (2 or 1 from the 1D test, 5 from the
2D test).  Launches made inside ``device.warming()`` (the tile loop's
first-use warm-up) count in ``WARM_LAUNCHES`` instead.

What depends on the counts alone stays plain tensor operations here, as the
JAX package computes them outside its Pallas call (``cascade_inputs``): the
conditional ratios and tail sums, each row's last occupied bin, and the order
in which the blocks take the rows (longest first, so that the last wave of
blocks does not wait for one long row).  ``launch_cascade`` is the launch
alone.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import is_warming
from . import kernel_build, sampling

SUPPORTED_W = (1, 2, 5)
LAUNCHES = {"cascade_bootstrap": 0}
LAUNCHES_BY_W = {w: 0 for w in SUPPORTED_W}
WARM_LAUNCHES = {"cascade_bootstrap": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_BY_W, WARM_LAUNCHES):
        for name in counts:
            counts[name] = 0


def count_launch(w_dim: int) -> None:
    """Count one launch of the cascade kernel with ``w_dim`` weights: in
    ``WARM_LAUNCHES`` inside ``device.warming()``, else in ``LAUNCHES`` and
    ``LAUNCHES_BY_W``."""
    if is_warming():
        WARM_LAUNCHES["cascade_bootstrap"] += 1
        return
    LAUNCHES["cascade_bootstrap"] += 1
    LAUNCHES_BY_W[w_dim] += 1


def _cascade_library():
    lib = kernel_build.load("cascade_bootstrap")
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
    kernel_build.build(["cascade_bootstrap"])
    usage = kernel_build.ptxas_usage(
        kernel_build.BUILD_LOG.get("cascade_bootstrap", ""))
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
    t_dim = counts.shape[0]
    w_dim = weights.shape[-1]
    if w_dim not in SUPPORTED_W:
        raise ValueError(f"W={w_dim} not in {SUPPORTED_W}")
    n_rows = torch.broadcast_to(
        torch.as_tensor(n_obs, dtype=torch.float32, device=counts.device),
        (t_dim,)).contiguous()
    if t_dim == 0 or num_boot == 0:
        return torch.empty((t_dim, w_dim, num_boot), dtype=torch.float32,
                           device=counts.device)
    return launch_cascade(counts, weights, n_rows, cascade_inputs(counts),
                          num_boot, seed)


__all__ = ["fused_bootstrap_sums_cuda", "cascade_inputs", "launch_cascade",
           "cascade_resources", "cascade_ptxas", "LAUNCHES", "LAUNCHES_BY_W",
           "WARM_LAUNCHES", "reset_launches", "count_launch"]
