"""Device selection and counter-based seed derivation.

Every entry point that touches the device takes ``device=None``, which means
``cuda``.  A caller that wants the CPU says so (``device="cpu"``, as the
tests do); a CUDA request on a machine without CUDA raises instead of
quietly running on the CPU.

Randomness is derived from integer coordinates, never from call order:
``fold_seed(seed, tile_start, stage, group)`` mixes the tuple with
splitmix64, the role ``jax.random.fold_in`` plays in the JAX package
(``memento_tpu/ops/sampling.py::fold_key``).  The same (seed, coordinates)
always gives the same stream, whichever tile, thread or device runs it.  The
derived 64-bit value seeds a ``torch.Generator`` for the plain tensor paths
and is the Philox key of the CUDA kernel.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain tensor path on the CPU")
    return dev


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_seed(seed: int, *indices: int) -> int:
    """Fold integer coordinates into a 64-bit seed (splitmix64 chain)."""
    x = _splitmix64(int(seed) & _MASK64)
    for ix in indices:
        x = _splitmix64(x ^ (int(ix) & _MASK64))
    return x


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with a derived seed."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed) & _MASK64)
    return gen


__all__ = ["resolve_device", "fold_seed", "generator"]
