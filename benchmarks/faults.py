"""Faults planted in the program underneath the harness, for showing that
the comparison that decides ``correct`` catches them.

    python3 -m benchmarks.faults --workload NAME --fault NAME --seeds 1 2 3

runs the cell with the fault planted, for each seed, over one cycle of
its traffic (``--seconds``, default 1), and prints one JSON line per seed
with every number compared and ``correct``, which has to come out false
(``--fault none``: the sound program, whose numbers are the lower readings
of the limits).
The benchmark's own runs do not run it; ``benchmarks/tests/
test_bench_control.py`` plants each fault at a size the CPU holds.

Each fault is a function of the request kind (``"1d"`` or ``"2d"``) that
returns the list of ``(object, attribute, replacement)`` to patch:

- ``altered``: one item's observed coefficient moved by 0.05 where the
  tile loop produces it;
- ``half_batch``: the observed moments (1D) or covariances (2D) over the
  first half of each group's cells, the mean taken over that half;
- ``unchanged``: the first request's result returned for every later one;
- ``boot_scaled``: every bootstrap replicate's weighted sums moved 1.5
  times as far from their mean over the replicates, where the sampler
  produces them.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np


def _altered(kind):
    import memento_tpu_torch.api as api

    name, key = (("run_ht_1d", "mean_coef") if kind == "1d"
                 else ("run_ht_2d", "corr_coef"))
    real = getattr(api, name)

    def broken(*a, **kw):
        out = real(*a, **kw)
        out[key][0] += 0.05
        return out
    return [(api, name, broken)]


def _half_batch(kind):
    import memento_tpu_torch.api as api

    if kind == "1d":
        real = api._observed_moments

        def broken(uns, X, n_obs, q, size_factor):
            h = max(1, n_obs // 2)
            return real(uns, X[:h], h, q, np.asarray(size_factor)[:h])
        return [(api, "_observed_moments", broken)]
    real = api.cov_sparse_pairs

    def broken_pairs(X, sf, q, idx1, idx2, model):
        h = max(1, X.shape[0] // 2)
        return real(X[:h], np.asarray(sf)[:h], q, idx1, idx2, model)
    return [(api, "cov_sparse_pairs", broken_pairs)]


def _unchanged(kind):
    import memento_tpu_torch

    name = "get_1d_ht_result" if kind == "1d" else "get_2d_ht_result"
    real = getattr(memento_tpu_torch, name)
    first = []

    def broken(adata):
        if not first:
            first.append(real(adata))
        return first[0]
    return [(memento_tpu_torch, name, broken)]


def _boot_scaled(kind):
    from memento_tpu_torch.ops import bootstrap

    real = bootstrap._moment_sums

    def broken(*a, **kw):
        sums = real(*a, **kw)
        mean = sums.mean(-1, keepdim=True)
        return mean + 1.5 * (sums - mean)
    return [(bootstrap, "_moment_sums", broken)]


FAULTS = {"altered": _altered, "half_batch": _half_batch,
          "unchanged": _unchanged, "boot_scaled": _boot_scaled}


def plant(fault: str, kind: str):
    """Plant ``fault``; returns the function that takes it out again."""
    patches = FAULTS[fault](kind)
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, new in patches:
        setattr(obj, attr, new)

    def undo():
        for obj, attr, old in saved:
            setattr(obj, attr, old)
    return undo


def main(argv=None) -> int:
    from .run import ROOT, find_cell, log, run_cell

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--fault", required=True,
                        choices=sorted(FAULTS) + ["none"])
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        log("no CUDA device")
        return 2
    cell = find_cell(ROOT, args.workload)
    kind = cell.kind().Runner.kind
    for seed in args.seeds:
        undo = (plant(args.fault, kind) if args.fault != "none"
                else (lambda: None))
        try:
            out = run_cell(cell, seed, args.seconds, False, args.device,
                           Path(tempfile.gettempdir()))
        finally:
            undo()
        print(json.dumps({"workload": cell.name, "fault": args.fault,
                          "seed": seed, "correct": out["correct"],
                          "numbers": {k: v for k, (v, _) in
                                      out["compared"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
