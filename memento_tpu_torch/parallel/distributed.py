"""Multi-process runs over ``torch.distributed``.

Counterpart of ``memento_tpu/parallel/distributed.py``.  One process per
card (or several processes sharing one card), each holding the whole
dataset or only its own row range of cells; they meet in all-reduces of
small host arrays:

- ``process_row_range``: the contiguous cell rows a process loads, for
  ``stream_suffstats_multihost``; the sufficient statistics are plain sums,
  so one all-reduce of the per-process sums gives the one-process answer.
- ``process_tile_starts``: the gene (pair) tiles of the tests a process
  runs, round-robin, each keeping its global start, so every tile's seed
  (``fold_seed(seed, start)``) is the one of the one-process run; the rows
  then merge with ``merge_disjoint_rows``.

Backend: gloo, on CPU float64 tensors, whatever the number of cards.  Every
all-reduce here sums host float64 arrays (merged rows, sufficient
statistics, checkpoint have-vectors), as the JAX package's does; gloo keeps
float64 exact; and NCCL cannot put two ranks on one card.  Rank and world
size come from ``torch.distributed`` once it is initialized, else 0 and 1.

The JAX module's ``global_data_mesh`` (one mesh over every device of every
process) has no counterpart: a torch process addresses only its own
devices, and there is no program that spans processes to place on it.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.estimators import NoiseModel, mean_var_from_suffstats

# seconds a process waits for its peers, at start-up and in each collective
DEFAULT_TIMEOUT_S = 600


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group (gloo).

    ``coordinator_address`` is ``host:port`` of rank 0 (``tcp://`` is
    prefixed); with all three arguments ``None``, the rendezvous is read
    from the environment as ``torchrun`` sets it (``env://``).  ``timeout``
    (seconds) bounds the wait for the peers, at start-up and in every
    collective: a peer that died raises instead of hanging.
    """
    given = (coordinator_address, num_processes, process_id)
    td = datetime.timedelta(seconds=timeout)
    if all(x is None for x in given):
        dist.init_process_group("gloo", init_method="env://", timeout=td)
        return
    if any(x is None for x in given):
        raise ValueError("give coordinator_address, num_processes and "
                         "process_id together, or none of them")
    addr = coordinator_address if "://" in coordinator_address \
        else "tcp://" + coordinator_address
    dist.init_process_group("gloo", init_method=addr,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=td)


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    """The number of processes (1 outside a process group)."""
    return dist.get_world_size() if _initialized() else 1


def local_device() -> torch.device:
    """This process's card: ``cuda:{LOCAL_RANK % count}``, or by rank where
    ``LOCAL_RANK`` is unset (ranks beyond the card count share cards)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device for this process; pass device='cpu' (or a CPU "
            "mesh) to run the plain tensor path on the CPU")
    rank = int(os.environ.get("LOCAL_RANK", process_index()))
    return torch.device(f"cuda:{rank % torch.cuda.device_count()}")


def local_data_mesh():
    """The mesh of this process's own device, ``(local_device(),)``: local
    reductions run there and only the ``[G]`` partials cross processes."""
    return (local_device(),)


def process_row_range(n_rows: int,
                      process_id: Optional[int] = None,
                      num_processes: Optional[int] = None) -> Tuple[int, int]:
    """Contiguous, balanced ``[start, stop)`` row range of this process:
    each process loads only ``X[start:stop]`` of the cell matrix."""
    pid = process_index() if process_id is None else process_id
    nproc = process_count() if num_processes is None else num_processes
    base, rem = divmod(n_rows, nproc)
    start = pid * base + min(pid, rem)
    stop = start + base + (1 if pid < rem else 0)
    return start, stop


def process_tile_starts(starts, process_id: Optional[int] = None,
                        num_processes: Optional[int] = None) -> list:
    """Round-robin share of the tile start offsets for this process.  Each
    tile keeps its global start, so its seed fold is that of the
    one-process run, and round-robin balances the tiles' uneven packing
    cost over the processes."""
    pid = process_index() if process_id is None else process_id
    nproc = process_count() if num_processes is None else num_processes
    return list(starts)[pid::nproc]


def allreduce_hostsums(*partials: np.ndarray,
                       precision: str = "high") -> Tuple[np.ndarray, ...]:
    """Sum equally shaped host arrays over all processes; every process
    receives the sums (float64).

    ``precision='high'`` all-reduces float64 (exact up to the order of
    addition; exact outright for two processes, or for sums that are exact
    in float64).  ``'fast'`` ships float32 with a hi/lo split: each partial
    is ``hi + lo`` with ``hi = float32(x)`` and ``lo = float32(x - hi)``,
    the halves are summed in float32 and added in float64 (error about the
    number of processes times 1e-7, relative).
    """
    if precision not in ("high", "fast"):
        raise ValueError("precision must be 'high' or 'fast'")
    stacked = np.stack([np.asarray(p, np.float64) for p in partials])
    k = stacked.shape[0]
    if precision == "high":
        buf = torch.from_numpy(stacked.copy())
    else:
        hi = stacked.astype(np.float32)
        lo = (stacked - hi).astype(np.float32)
        buf = torch.from_numpy(np.concatenate([hi, lo]))
    if process_count() > 1:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    out = buf.numpy().astype(np.float64)
    if precision == "fast":
        out = out[:k] + out[k:]
    return tuple(out[i] for i in range(k))


def merge_disjoint_rows(out: dict, owned: np.ndarray,
                        precision: str = "high") -> dict:
    """Merge per-process result dicts whose row ownership is disjoint.

    Each process holds full-size ``[N, ...]`` arrays with only the rows in
    its ``owned`` mask filled; every row is owned by exactly one process,
    so an all-reduce with the other rows zeroed gives the global result
    exactly (NaN in an owned row stays NaN: NaN + 0 = NaN).

    The masks are checked collectively: a row owned by no process or by
    several (processes that resolved different tile sizes) raises
    ``RuntimeError``.  The owner counts come back as exact integers here;
    the check keeps the JAX package's tolerance (1e-2).
    """
    keys = sorted(out)
    shape = np.shape(out[keys[0]])
    owned = np.asarray(owned, bool)
    mask = np.broadcast_to(
        owned.astype(np.float64).reshape((-1,) + (1,) * (len(shape) - 1)),
        shape).copy()
    arrs = [mask]
    for k in keys:
        a = np.array(out[k], np.float64, copy=True)
        a[~owned] = 0.0
        arrs.append(a)
    merged = allreduce_hostsums(*arrs, precision=precision)
    owners = merged[0][..., 0] if len(shape) > 1 else merged[0]
    ok = np.isclose(owners, 1.0, rtol=0, atol=1e-2)
    if not np.all(ok):
        bad = np.nonzero(~ok)[0]
        raise RuntimeError(
            f"inconsistent distributed tile partition: {bad.size} rows are "
            f"owned by {owners[bad[0]]:.0f} processes (first bad row "
            f"{bad[0]}); every process must resolve the same tile_size: "
            "pass tile_size explicitly")
    return {k: np.asarray(m) for k, m in zip(keys, merged[1:])}


def stream_suffstats_multihost(X_local, size_factor_local,
                               block: int = 8192, precision: str = "high",
                               mesh=None):
    """Global per-gene sufficient statistics from per-process row ranges.

    Args:
      X_local: ``[N_local, G]`` this process's rows of the cell matrix
        (``process_row_range``).
      size_factor_local: ``[N_local]`` their size factors.
      mesh: the devices this process streams through (default
        ``local_data_mesh()``, its card).

    Returns:
      (s1, s2, s1sq): ``[G]`` float64 global sums, the same on every
      process.
    """
    from .streaming import stream_suffstats

    mesh = local_data_mesh() if mesh is None else mesh
    sums = stream_suffstats(mesh, X_local, size_factor_local, block=block,
                            precision=precision)
    return allreduce_hostsums(*sums, precision=precision)


def stream_mean_var_multihost(X_local, size_factor_local, n_obs_global: int,
                              q: float, model: NoiseModel,
                              block: int = 8192, precision: str = "high",
                              mesh=None):
    """Observed global ``(mean, var)`` from per-process row ranges."""
    if not model.relative:
        size_factor_local = np.ones(X_local.shape[0])
    s1, s2, s1sq = stream_suffstats_multihost(
        X_local, size_factor_local, block=block, precision=precision,
        mesh=mesh)
    m, v = mean_var_from_suffstats(s1, s2, s1sq, n_obs_global, q, model)
    return np.asarray(m), np.asarray(v)


__all__ = [
    "initialize",
    "process_index",
    "process_count",
    "local_device",
    "process_row_range",
    "process_tile_starts",
    "merge_disjoint_rows",
    "local_data_mesh",
    "allreduce_hostsums",
    "stream_suffstats_multihost",
    "stream_mean_var_multihost",
    "DEFAULT_TIMEOUT_S",
]
