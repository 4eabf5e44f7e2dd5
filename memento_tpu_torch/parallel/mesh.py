"""Device meshes of the port.

Counterpart of ``memento_tpu/parallel/mesh.py``.  The workload has two
parallel axes: cells (per-group sufficient statistics are plain sums, so
cell slabs reduce independently and their partials add up) and genes or
gene pairs (their tests are independent).  In the JAX package a mesh is a
``jax.sharding.Mesh`` with named ``data`` / ``model`` axes, and GSPMD splits
each program from the input shardings.

PyTorch has no such partitioner, so here **a mesh is a tuple of
``torch.device``s** and the code that takes one splits the work itself:
cell slabs over the devices (``sharded.dp_suffstats``,
``streaming.stream_suffstats``), pieces of a tile's gene axis
(``sharded.sharded_ht_1d_tile``), the correlation matrix's output columns
(``sharded.corr_matrix_sharded``), and whole tiles round-robin
(``inference.ht.run_ht_1d(mesh=...)``).  One axis serves every use, so a
mesh has no shape and no axis names.  The JAX module's ``gene_sharding``,
``cell_sharding`` and ``replicated`` name ``NamedSharding``s, which mean
nothing without GSPMD; they have no counterpart.

A device may appear more than once: ``("cpu", "cpu")`` splits the work in
two on the CPU (the tests), and ``("cuda:0", "cuda:0")`` does the same on a
host with one card.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

Mesh = Tuple[torch.device, ...]


def make_mesh(devices: Sequence = None) -> Mesh:
    """A mesh over ``devices`` (anything ``torch.device`` takes), default
    every visible CUDA device; raises if none is visible."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices "
                "explicitly (e.g. ('cpu', 'cpu')) to build a CPU mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    for dev in mesh:
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {dev}: CUDA is not available")
    return mesh


def as_mesh(mesh) -> Mesh:
    """``mesh`` as a tuple of ``torch.device``s (a mesh, or any sequence of
    device names or devices)."""
    if isinstance(mesh, (str, torch.device)):
        raise TypeError("a mesh is a sequence of devices, not one device; "
                        "wrap it: (device,)")
    return make_mesh(list(mesh))


def split_range(n: int, parts: int):
    """``parts`` contiguous ``(start, stop)`` ranges covering ``[0, n)``,
    the first ``n % parts`` one longer (some are empty when n < parts)."""
    base, rem = divmod(n, parts)
    out, start = [], 0
    for i in range(parts):
        stop = start + base + (1 if i < rem else 0)
        out.append((start, stop))
        start = stop
    return out


__all__ = ["Mesh", "make_mesh", "as_mesh", "split_range"]
