"""Bootstrap replicate moments from compressed tiles (1D and 2D).

Counterpart of ``memento_tpu/ops/bootstrap.py``.  With unique values
``x_u``, size factors ``sf_u`` and resampled multiplicities ``n_ub``::

    M1_b  = sum_u (x_u / sf_u)                 * n_ub / N
    M2_b  = sum_u (x_u^2 - c x_u) / sf_u^2     * n_ub / N
    Mxy_b = sum_u (x_u y_u) / sf_u^2           * n_ub / N     (gene pairs)

so each replicate's moments are weighted sums of one resample: two per gene
(W = 2; one for ``mean_only``), five per gene pair (W = 5: both means, the
cross moment and both second moments from a single joint resample).  The
fused samplers (the cascade, in the CUDA kernel or its plain version, and
the exact multinomial) compute them without materializing ``n_ub``; the
``poisson`` and ``gaussian`` samplers materialize the draws and contract
them (``mean_var_compressed`` / ``cov_compressed``).

User estimators (``bootstrap_1d_custom`` / ``bootstrap_2d_custom``) take
materialized draws.  An estimator that, called on small tensors on the run's
device, returns tensors on that device runs batched over the tile with
``torch.func.vmap``; any other (a numpy-only estimator written for the
reference) runs item by item on host numpy copies, as the JAX package's
``pure_callback`` path does.  ``CUSTOM_PATHS`` counts which path ran.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..device import generator
from .cuda_kernels import fused_bootstrap_sums_cuda
from .estimators import NoiseModel, cov_compressed, mean_var_compressed
from .sampling import bootstrap_counts, fused_bootstrap_sums

SAMPLERS = ("cascade", "cascade_cuda", "multinomial", "poisson", "gaussian")
MATERIALIZED = ("poisson", "gaussian")

CUSTOM_PATHS = {"device": 0, "host": 0}
_PATHS_LOCK = threading.Lock()


def reset_custom_paths() -> None:
    with _PATHS_LOCK:
        for name in CUSTOM_PATHS:
            CUSTOM_PATHS[name] = 0


def _count_path(name: str) -> None:
    with _PATHS_LOCK:
        CUSTOM_PATHS[name] += 1


def _row_params(counts, n_obs, q):
    """``n_obs`` and ``q`` broadcast to the batch shape of ``counts``."""
    batch = counts.shape[:-1]
    return tuple(
        torch.broadcast_to(
            torch.as_tensor(x, dtype=torch.float32, device=counts.device),
            batch)
        for x in (n_obs, q))


def _moment_sums(counts, weights, n_rows, num_boot: int, seed: int,
                 sampler: str):
    """Per-cell weighted sums of the resample, ``[..., W, B]``: the batch
    flattens to rows (each with its own trial count) for the kernel, its
    plain version or the exact multinomial sums."""
    batch = counts.shape[:-1]
    u_dim = counts.shape[-1]
    w_dim = weights.shape[-1]
    flat = (counts.reshape(-1, u_dim).contiguous(),
            weights.reshape(-1, u_dim, w_dim).contiguous(),
            n_rows.reshape(-1).contiguous(), num_boot, seed)
    if sampler == "cascade_cuda":
        sums = fused_bootstrap_sums_cuda(*flat)
    elif sampler in ("cascade", "multinomial"):
        sums = fused_bootstrap_sums(*flat, sampler=sampler)
    else:
        raise ValueError(f"unknown fused sampler {sampler!r}; options: "
                         f"{SAMPLERS}")
    return sums.reshape(*batch, w_dim, num_boot) / n_rows[..., None, None]


def bootstrap_1d(values, counts, inv_sf, inv_sf_sq, n_obs, q,
                 model: NoiseModel, num_boot: int, seed: int,
                 sampler: str = "cascade"):
    """Bootstrap replicate means/variances for rows of compressed tiles.

    Args:
      values, counts, inv_sf, inv_sf_sq: ``[..., U]`` float32 tiles.
      n_obs, q: cells and capture efficiency per row, broadcastable to the
        batch shape ``[...]`` (rows of different groups differ).
      sampler: ``'cascade'`` (the plain version), ``'cascade_cuda'`` (the
        kernel for CUDA tensors; the plain version for CPU tensors),
        ``'multinomial'`` (exact fused sums), ``'poisson'`` or
        ``'gaussian'`` (materialized draws).

    Returns:
      (mean, var): ``[..., B]`` float32.  Rows that collapsed to <= 1 unique
      combo are masked by the caller.
    """
    if sampler in MATERIALIZED:
        draws = bootstrap_counts(counts, n_obs, num_boot, sampler,
                                 generator(seed, counts.device))
        return mean_var_compressed(values, draws, inv_sf, inv_sf_sq, n_obs, q,
                                   model)
    n_rows, q_rows = _row_params(counts, n_obs, q)
    a = values * inv_sf
    if model.mean_only:
        w = a[..., None]
    else:
        c = model.var_correction(q_rows)[..., None]
        w = torch.stack([a, (values * values - c * values) * inv_sf_sq], -1)
    m = _moment_sums(counts, w, n_rows, num_boot, seed, sampler)
    m1 = m[..., 0, :]
    if model.mean_only:
        return m1 + 1.0, torch.full_like(m1, 10.0)
    return m1, m[..., 1, :] - m1 * m1


def pair_weights(values_1, values_2, inv_sf, inv_sf_sq, c):
    """The five contraction weights of a gene pair, ``[..., U, 5]``: the two
    means, the cross moment and the two second moments (``c`` is the noise
    model's variance correction, broadcastable to ``[..., U]``)."""
    return torch.stack([
        values_1 * inv_sf,
        values_2 * inv_sf,
        values_1 * values_2 * inv_sf_sq,
        (values_1 * values_1 - c * values_1) * inv_sf_sq,
        (values_2 * values_2 - c * values_2) * inv_sf_sq,
    ], -1)


def bootstrap_2d(values_1, values_2, counts, inv_sf, inv_sf_sq, n_obs, q,
                 model: NoiseModel, num_boot: int, seed: int,
                 sampler: str = "cascade"):
    """Bootstrap replicate covariance and marginal variances for rows of
    joint compressed tiles: one joint resample drives all three.

    Args:
      values_1, values_2, counts, inv_sf, inv_sf_sq: ``[..., U]`` float32
        tiles (``CompressedPairGroup`` arrays).
      n_obs, q, sampler: as in ``bootstrap_1d``.

    Returns:
      (cov, var_1, var_2): ``[..., B]`` float32.
    """
    if sampler in MATERIALIZED:
        draws = bootstrap_counts(counts, n_obs, num_boot, sampler,
                                 generator(seed, counts.device))
        cov = cov_compressed(values_1, values_2, draws, inv_sf, inv_sf_sq,
                             n_obs)
        _, var_1 = mean_var_compressed(values_1, draws, inv_sf, inv_sf_sq,
                                       n_obs, q, model)
        _, var_2 = mean_var_compressed(values_2, draws, inv_sf, inv_sf_sq,
                                       n_obs, q, model)
        return cov, var_1, var_2
    n_rows, q_rows = _row_params(counts, n_obs, q)
    c = model.var_correction(q_rows)[..., None]
    w = pair_weights(values_1, values_2, inv_sf, inv_sf_sq, c)
    m = _moment_sums(counts, w, n_rows, num_boot, seed, sampler)
    m1, m2 = m[..., 0, :], m[..., 1, :]
    return (m[..., 2, :] - m1 * m2,
            m[..., 3, :] - m1 * m1,
            m[..., 4, :] - m2 * m2)


def _exact_draws(counts, n_obs, num_boot: int, seed: int, sampler: str):
    """Materialized draws for a user estimator: the cascade samplers (an
    approximation fused with the registry's own weights) give way to the
    exact multinomial, as in the JAX package."""
    if sampler in ("cascade", "cascade_cuda"):
        sampler = "multinomial"
    return bootstrap_counts(counts, n_obs, num_boot, sampler,
                            generator(seed, counts.device))


# the probe's small sizes: bins and replicates (distinct, so that an
# estimator summing over the wrong axis shows)
_PROBE_U, _PROBE_B = 4, 3


def _runs_on_device(per_item, n_values: int, device) -> bool:
    """Whether ``per_item(*values, draws, inv_sf, inv_sf_sq)`` on small
    tensors on ``device`` (``n_values`` value vectors: 1 for a gene, 2 for a
    pair) returns tensors of shape ``[B]`` on that device.  A numpy-only
    estimator raises on a CUDA tensor and returns numpy arrays for a CPU
    tensor: both are the host path."""
    u, b = _PROBE_U, _PROBE_B
    v = torch.arange(1.0, u + 1.0, device=device)
    isf = torch.full((u,), 0.5, device=device)
    try:
        out = per_item(*(v, v.flip(0))[:n_values],
                       torch.ones(u, b, device=device), isf, isf * isf)
    # the probe only decides the path; an estimator that fails here is
    # called again on the host path, where its error surfaces
    except Exception:  # noqa: BLE001
        return False
    return all(isinstance(x, torch.Tensor) and x.device == device
               and tuple(x.shape) == (b,) for x in out)


def _sf_args(isf, isf2):
    return isf[:, None], isf2[:, None]


def _per_item_on_host(fn, tensors, n_out: int, num_boot: int, dev):
    """``fn`` item by item on host numpy copies of ``tensors`` (first axis:
    genes or pairs); its ``n_out`` results ``[B]`` come back as float32
    tensors ``[items, B]`` on ``dev``."""
    host = [x.cpu().numpy() for x in tensors]
    outs = [np.empty((len(host[0]), num_boot), np.float32)
            for _ in range(n_out)]
    for i in range(len(host[0])):
        for out, x in zip(outs, fn(*(h[i] for h in host))):
            out[i] = np.asarray(x, np.float32)
    return tuple(torch.as_tensor(out, device=dev) for out in outs)


def bootstrap_1d_custom(custom_fn, values, counts, inv_sf, inv_sf_sq, n_obs,
                        q, num_boot: int, seed: int,
                        sampler: str = "multinomial"):
    """Bootstrap with a user 1D estimator (the reference's custom API).

    The estimator is called as ``custom_fn(data=(expr [U, 1], draws [U, B]),
    n_obs=N, q=q, size_factor=(inv_sf [U, 1], inv_sf_sq [U, 1]))`` per gene
    and returns ``[mean [B], var [B]]``.

    Args:
      values, counts, inv_sf, inv_sf_sq: ``[T, U]`` tensors of one group.
      n_obs, q: the group's cells and capture efficiency.

    Returns:
      (mean, var): ``[T, B]`` float32 on ``values.device``.
    """
    draws = _exact_draws(counts, n_obs, num_boot, seed, sampler)
    dev = values.device
    n, qq = float(n_obs), float(q)

    def per_gene(v, d, isf, isf2):
        out = custom_fn(data=(v[:, None], d), n_obs=n, q=qq,
                        size_factor=_sf_args(isf, isf2))
        return out[0], out[1]

    if _runs_on_device(per_gene, 1, dev):
        _count_path("device")
        return torch.func.vmap(per_gene)(values, draws, inv_sf, inv_sf_sq)

    _count_path("host")
    return _per_item_on_host(per_gene, (values, draws, inv_sf, inv_sf_sq),
                             2, num_boot, dev)


def bootstrap_2d_custom(custom_1d, custom_cov, values_1, values_2, counts,
                        inv_sf, inv_sf_sq, n_obs, q, num_boot: int, seed: int,
                        sampler: str = "multinomial"):
    """Bootstrap covariance and marginal variances with user estimators.

    The covariance estimator is called as ``custom_cov(data=(expr1 [U, 1],
    expr2 [U, 1], draws [U, B]), n_obs=N, q=q, size_factor=(inv_sf [U, 1],
    inv_sf_sq [U, 1]))`` per pair and returns ``cov [B]``; ``custom_1d``
    (as in ``bootstrap_1d_custom``) gives each marginal variance from the
    same joint draws.  Both must run on the device for the batched path.

    Args:
      values_1, values_2, counts, inv_sf, inv_sf_sq: ``[P, U]`` tensors of
        one group.

    Returns:
      (cov, var_1, var_2): ``[P, B]`` float32 on ``values_1.device``.
    """
    draws = _exact_draws(counts, n_obs, num_boot, seed, sampler)
    dev = values_1.device
    n, qq = float(n_obs), float(q)

    def per_pair(v1, v2, d, isf, isf2):
        sf = _sf_args(isf, isf2)
        cov = custom_cov(data=(v1[:, None], v2[:, None], d), n_obs=n, q=qq,
                         size_factor=sf)
        var_1 = custom_1d(data=(v1[:, None], d), n_obs=n, q=qq,
                          size_factor=sf)[1]
        var_2 = custom_1d(data=(v2[:, None], d), n_obs=n, q=qq,
                          size_factor=sf)[1]
        return cov, var_1, var_2

    if _runs_on_device(per_pair, 2, dev):
        _count_path("device")
        return torch.func.vmap(per_pair)(values_1, values_2, draws, inv_sf,
                                         inv_sf_sq)

    _count_path("host")
    return _per_item_on_host(per_pair,
                             (values_1, values_2, draws, inv_sf, inv_sf_sq),
                             3, num_boot, dev)


def observed_moments_compressed(values, counts, inv_sf, inv_sf_sq, n_obs, q,
                                model: NoiseModel):
    """Observed (not resampled) moments from the compressed tiles: the
    estimator on the original multiplicities.  Returns ``(mean, var)``
    ``[...]``."""
    m, v = mean_var_compressed(values, counts[..., None], inv_sf, inv_sf_sq,
                               n_obs, q, model)
    return m[..., 0], v[..., 0]


__all__ = ["bootstrap_1d", "bootstrap_2d", "bootstrap_1d_custom",
           "bootstrap_2d_custom", "observed_moments_compressed",
           "pair_weights", "SAMPLERS", "CUSTOM_PATHS", "reset_custom_paths"]
