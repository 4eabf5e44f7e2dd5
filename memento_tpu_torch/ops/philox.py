"""Philox4x32-10 and the cascade kernel's allocation of its words, in torch.

``csrc/cascade_bootstrap.cu`` draws every random number from the
counter-based generator Philox4x32-10 (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC'11; the constants are Random123's).  This
module is the same generator and the same allocation in plain torch integer
operations, so that the kernel's stream can be replayed on the CPU or on the
card (``sampling.fused_bootstrap_sums_philox``) and the kernel held against
its plain version draw by draw.  It is used by tests and by
``chip_smoke.py``, never on a main path.

The allocation.  Bins go in groups of ``GROUP`` = 4.  For replicate ``b`` of
row ``t`` the group ``g = bin // 4`` owns two Philox calls, keyed by the
tile's 64-bit seed:

- counter ``(b, g, t, CALL_TABLE)``: word ``j`` is the table-branch uniform
  of bin ``4 g + j``;
- counter ``(b, g, t, CALL_GAUSS)``: words (0, 1) and (2, 3) are two
  Box-Muller pairs ``(u1, u2)``; with ``rad = sqrt(-2 log u1)`` and
  ``theta = 2 pi u2 - pi``, bin ``4 g + j`` takes the normal
  ``rad cos(theta)`` for even ``j`` and ``rad sin(theta)`` for odd ``j`` of
  pair ``j // 2``.

So each 32-bit word serves at most one draw, and a draw is a pure function of
(row, bin, replicate, seed): no generator state is carried between bins.  A
uniform is the word's top 24 bits (logical shift) times 2^-24, clamped at
1e-7 away from 0.

``csrc/multinomial_bootstrap.cu`` (the exact sampler) keys the same
generator by its call's seed with counter ``(b, u, t, k)`` for the ``k``-th
call of draw (row ``t``, bin ``u``, replicate ``b``): ``group_words`` with
the bin in place of the group and ``k`` as the call (replayed by
``sampling.fused_multinomial_sums_philox``).
"""

from __future__ import annotations

import math

import torch

GROUP = 4
CALL_TABLE = 0
CALL_GAUSS = 1

_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b):
    """High and low 32-bit words of ``a * b`` for a 32-bit constant ``a``
    and an int64 tensor ``b`` of 32-bit values.  The product is taken in
    16-bit halves of ``b``: ``a * b`` itself overflows int64."""
    p0 = a * (b & 0xFFFF)  # < 2^48
    p1 = a * (b >> 16)  # < 2^48
    s = p0 + ((p1 & 0xFFFF) << 16)  # < 2^49; a*b = s + (p1 >> 16) * 2^32
    return (p1 >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10.

    Args:
      counter: int64 tensor ``[..., 4]`` of 32-bit words.
      key: ``(k0, k1)`` 32-bit ints.

    Returns:
      int64 tensor ``[..., 4]`` of 32-bit output words.
    """
    c0, c1, c2, c3 = (counter[..., i] for i in range(4))
    k0, k1 = int(key[0]) & _MASK32, int(key[1]) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return torch.stack([c0, c1, c2, c3], dim=-1)


def seed_key(seed: int):
    """The kernel's Philox key: low and high word of the 64-bit seed."""
    seed = int(seed) & ((1 << 64) - 1)
    return seed & _MASK32, seed >> 32


def uniform24(bits):
    """Top 24 bits of each word -> float32 uniform in [1e-7, 1)."""
    u = (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)
    return torch.clamp_min(u, 1e-7)


def _device_of(*xs):
    return next((x.device for x in xs if torch.is_tensor(x)),
                torch.device("cpu"))


def group_words(rows, groups, reps, call: int, seed: int):
    """The four words of one Philox call for every (row, group, replicate):
    int64 ``[..., 4]`` over the broadcast shape of the three index tensors."""
    dev = _device_of(rows, groups, reps)
    rows, groups, reps = torch.broadcast_tensors(
        *(torch.as_tensor(x, dtype=torch.int64, device=dev)
          for x in (rows, groups, reps)))
    counter = torch.stack([reps, groups, rows,
                           torch.full_like(rows, int(call))], dim=-1)
    return philox4x32_10(counter, seed_key(seed))


def group_uniforms(rows, groups, reps, seed: int):
    """Table-branch uniforms of a group's four bins, float32 ``[..., 4]``."""
    return uniform24(group_words(rows, groups, reps, CALL_TABLE, seed))


def group_normals(rows, groups, reps, seed: int):
    """Standard normals of a group's four bins, float32 ``[..., 4]``: two
    Box-Muller pairs, cosine for even bins and sine for odd bins."""
    u = uniform24(group_words(rows, groups, reps, CALL_GAUSS, seed))
    u1, u2 = u[..., 0::2], u[..., 1::2]  # [..., pair]
    rad = torch.sqrt(torch.clamp_min(-2.0 * torch.log(u1), 0.0))
    theta = u2 * (2.0 * math.pi) - math.pi
    return torch.stack([rad * torch.cos(theta), rad * torch.sin(theta)],
                       dim=-1).flatten(-2)


def _pick(per_group, bins):
    j = torch.as_tensor(bins, dtype=torch.int64,
                        device=per_group.device) % GROUP
    j = torch.broadcast_to(j, per_group.shape[:-1])
    return torch.gather(per_group, -1, j[..., None])[..., 0]


def bin_uniform(rows, bins, reps, seed: int):
    """The table-branch uniform of draw (row, bin, replicate)."""
    dev = _device_of(rows, bins, reps)
    groups = torch.as_tensor(bins, dtype=torch.int64, device=dev) // GROUP
    return _pick(group_uniforms(rows, groups, reps, seed), bins)


def bin_normal(rows, bins, reps, seed: int):
    """The Gaussian-branch normal of draw (row, bin, replicate)."""
    dev = _device_of(rows, bins, reps)
    groups = torch.as_tensor(bins, dtype=torch.int64, device=dev) // GROUP
    return _pick(group_normals(rows, groups, reps, seed), bins)


def draw_slot(row: int, u: int, rep: int, gaussian: bool):
    """The random variate that draw (row, bin, replicate) consumes, as a
    hashable: a word of the group's table call, or one of the two normals
    (cosine, sine) of a Box-Muller pair of the group's Gaussian call.  No
    two draws share a slot, and the two calls of a group share no counter."""
    j = u % GROUP
    if gaussian:
        counter = (rep, u // GROUP, row, CALL_GAUSS)
        return counter, (2 * (j // 2), 2 * (j // 2) + 1), ("cos", "sin")[j % 2]
    return (rep, u // GROUP, row, CALL_TABLE), (j,), "uniform"


__all__ = [
    "GROUP", "CALL_TABLE", "CALL_GAUSS", "philox4x32_10", "seed_key",
    "uniform24", "group_words", "group_uniforms", "group_normals",
    "bin_uniform", "bin_normal", "draw_slot",
]
