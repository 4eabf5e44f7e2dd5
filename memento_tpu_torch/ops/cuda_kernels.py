"""Wrappers of the hand-written CUDA kernels.

``fused_bootstrap_sums_cuda`` launches ``csrc/cascade_bootstrap.cu`` (the
port of the TPU kernel ``memento_tpu/ops/pallas_kernels.py::
_cascade_chunk_kernel``).  For a tensor on the CPU it runs the plain version,
``ops/sampling.py::fused_bootstrap_sums``; for a CUDA tensor it launches the
kernel or raises.  ``LAUNCHES`` counts kernel launches, so a run can show
that its main path went through the kernel; ``LAUNCHES_BY_W`` splits the
same count by the number of weights W (2 or 1 from the 1D test, 5 from the
2D test).
"""

from __future__ import annotations

import ctypes

import torch

from . import kernel_build, sampling

SUPPORTED_W = (1, 2, 5)
LAUNCHES = {"cascade_bootstrap": 0}
LAUNCHES_BY_W = {w: 0 for w in SUPPORTED_W}


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_BY_W):
        for name in counts:
            counts[name] = 0


def _cascade_library():
    lib = kernel_build.load("cascade_bootstrap")
    fn = lib.cascade_bootstrap_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong, p]
        fn.restype = ctypes.c_int
    return fn


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
    t_dim, u_dim = counts.shape
    w_dim = weights.shape[-1]
    if w_dim not in SUPPORTED_W:
        raise ValueError(f"W={w_dim} not in {SUPPORTED_W}")
    n_rows = torch.broadcast_to(
        torch.as_tensor(n_obs, dtype=torch.float32, device=counts.device),
        (t_dim,)).contiguous()

    out = torch.empty((t_dim, w_dim, num_boot), dtype=torch.float32,
                      device=counts.device)
    if t_dim == 0 or num_boot == 0:
        return out
    ctail, ratio = (x.contiguous() for x in sampling.conditional_ratios(counts))
    bins = torch.arange(1, u_dim + 1, dtype=torch.int32, device=counts.device)
    u_end = torch.where(counts > 0, bins, torch.zeros_like(bins)).amax(dim=1)
    u_end = u_end.to(torch.int32).contiguous()

    launch = _cascade_library()
    stream = torch.cuda.current_stream(counts.device).cuda_stream
    rc = launch(counts.data_ptr(), ratio.data_ptr(),
                ctail.data_ptr(), weights.data_ptr(),
                n_rows.data_ptr(), u_end.data_ptr(), out.data_ptr(),
                t_dim, u_dim, w_dim, num_boot,
                int(seed) & ((1 << 64) - 1), stream)
    if rc != 0:
        raise RuntimeError(f"cascade_bootstrap launch failed: cudaError {rc}")
    LAUNCHES["cascade_bootstrap"] += 1
    LAUNCHES_BY_W[w_dim] += 1
    return out


__all__ = ["fused_bootstrap_sums_cuda", "LAUNCHES", "LAUNCHES_BY_W",
           "reset_launches"]
