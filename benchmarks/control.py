"""The control of the comparison that decides ``correct``.

    python3 -m benchmarks.control --workload NAME --seeds 1 2 3

The control is the plain reference put in the program's place and computed
in the nearest precision below the one that the configuration states
(``reference.precisions``: float32 for the float64 host stages, bfloat16
for the float32 device program); in the program's place it draws its own
replicates.  For each seed it draws the
cell's data, takes the requests of the cell's traffic in order (``N``, by
default the traffic's first cycle of cell types or queries), samples them
as a run's check does, answers each by the control and judges it against
the float64 reference with the cell's numbers and limits.  It prints one
JSON line per seed, with every number and ``correct``, which has to come
out false.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import session
from .run import ROOT, Record, find_cell, log


def run_seed(cell, seed: int, n_requests: int, device) -> dict:
    """The control's verdict on one seed."""
    from . import data

    t0 = time.perf_counter()
    dataset = data.draw(cell.config, seed, device)
    runner = cell.kind().Runner(None, dataset, cell.config, cell.traffic,
                                seed, device)
    gen = runner.requests()
    records = [Record(index=i, request=next(gen), start_s=0.0, end_s=0.0)
               for i in range(n_requests)]
    prep = runner.prepare("control")

    def answer(request):
        return runner.reference_results(request, prep, "control")

    verdict = session.check(runner, records, cell.checks, answer=answer)
    return {"workload": cell.name, "seed": seed,
            "correct": bool(verdict["within"]),
            "numbers": {k: v for k, (v, _) in verdict["numbers"].items()},
            "limits": {k: lim for k, (_, lim) in verdict["numbers"].items()},
            "others": verdict["others"], "compared": verdict["compared"],
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--requests", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    import torch

    cell = find_cell(ROOT, args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        log("the control runs on the card: no CUDA device")
        return 2
    n = args.requests or max(int(cell.traffic.get("cycle", 0)),
                             len(cell.config["celltype_shares"]))
    for seed in args.seeds:
        print(json.dumps(run_seed(cell, seed, n, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
