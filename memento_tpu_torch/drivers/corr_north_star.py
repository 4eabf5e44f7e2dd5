"""The G x G correlation matrix at transcriptome scale.

    python -m memento_tpu_torch.drivers.corr_north_star [--device cuda]

The counterpart of the JAX package's ``examples/corr_north_star.py``: the
port's ``ops/corr.py::corr_matrix_device`` (``get_corr_matrix``'s engine)
on one group of ``north_star``'s counts, the first half of the cells
(100,000 cells x 20,000 genes), with total-count size factors scaled to mean
one.  The phase split is ``corr_matrix_device``'s own: host densify and
upload of the dense cell blocks, the compensated Gram stream on the device
(synchronized at its end), the gather of the Gram rows and the float64
finish on the host in row blocks.  Prints one JSON line (``_report.py``).

Environment knobs: NS_CELLS (total; one half is the group), NS_GENES,
NS_CACHE and NS_DRAW (shared with ``north_star``), CORR_BLOCK,
CORR_ROW_BLOCK.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from ..ops.corr import corr_matrix_device
from ..ops.estimators import get_noise_model, mean_var_sparse
from ..ops.size_factor import estimate_size_factor
from ..ops.transport import compact_transport_dtype
from ..utils import profiling
from . import _report
from ._data import load_or_simulate

CAPTURE_Q = 0.1


def knobs() -> dict:
    return {"cells": _report.env_int("NS_CELLS", 200_000),
            "genes": _report.env_int("NS_GENES", 20_000),
            "block": _report.env_int("CORR_BLOCK", 4096),
            "row_block": _report.env_int("CORR_ROW_BLOCK", 4096),
            "cache": os.environ.get("NS_CACHE", ""),
            "draw": os.environ.get("NS_DRAW", "numpy")}


def group_inputs(Xg):
    """One group's size factors (total counts, scaled to mean one) and
    per-gene variances, as the JAX driver sets them up."""
    sf = estimate_size_factor(Xg, total=True)
    sf = sf / sf.mean()
    _, var = mean_var_sparse(Xg, sf, CAPTURE_Q)
    return sf, var


def run_corr(Xg, sf, var, block: int, row_block, device):
    """``corr_matrix_device`` on the group (float32 result); returns the
    matrix and its phase split in seconds."""
    profiling.reset_timings()
    t = time.perf_counter()
    mat = corr_matrix_device(Xg, sf, CAPTURE_Q, var,
                             get_noise_model("hyper_relative"), block=block,
                             row_block=row_block, out_dtype=np.float32,
                             device=device)
    total = time.perf_counter() - t
    tm = profiling.timings()

    def total_of(name):
        return tm.get(name, {}).get("total_s", 0.0)

    return mat, {"gram_stream": total_of("corr.gram"),
                 "gram_stream_host_side": total_of("corr.densify")
                 + total_of("corr.upload"),
                 "densify": total_of("corr.densify"),
                 "upload": total_of("corr.upload"),
                 "gather_finish": total_of("corr.finish"),
                 "gather_only": total_of("corr.gather"),
                 "corr_total": total}


def record(cfg: dict, Xg, mat, phases: dict) -> dict:
    n, g = Xg.shape
    tdtype = compact_transport_dtype(Xg) or np.float32
    offdiag = mat[np.triu_indices(g, 1)]
    total = phases["corr_total"]
    return {
        "config": {"cells": n, "genes": g, "block": cfg["block"],
                   "row_block": cfg["row_block"],
                   "transport_dtype": np.dtype(tdtype).name},
        "phases_s": dict(phases),
        "corr_total_s": total,
        "cellpairs_per_s": n * g * g / total,
        "finite_frac": float(np.isfinite(mat).mean()),
        "offdiag_mean_abs": float(np.nanmean(np.abs(offdiag))),
        "device_gb": 2 * g * g * 4 / 1e9,
        "result_gb": mat.nbytes / 1e9,
    }


def main(argv=None) -> int:
    args = _report.parse_args(__doc__, argv)
    dev = _report.select_device(args.device)
    cfg = knobs()
    phases = {}
    t = time.perf_counter()
    X = load_or_simulate(cfg["cache"], cfg["cells"], cfg["genes"],
                         cfg["draw"], dev)
    Xg = X[: cfg["cells"] // 2].tocsr()  # one group, as get_corr_matrix
    del X
    phases["load"] = time.perf_counter() - t
    _report.log(f"group: {Xg.shape[0]} cells x {Xg.shape[1]} genes, "
                f"nnz={Xg.nnz}")
    t = time.perf_counter()
    sf, var = group_inputs(Xg)
    phases["setup"] = time.perf_counter() - t
    _report.reset(dev)
    mat, corr_phases = run_corr(Xg, sf, var, cfg["block"],
                                cfg["row_block"] or None, dev)
    phases.update(corr_phases)
    profiling.report(file=sys.stderr)
    _report.emit({**record(cfg, Xg, mat, phases), "device": str(dev),
                  **_report.resources(dev)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
