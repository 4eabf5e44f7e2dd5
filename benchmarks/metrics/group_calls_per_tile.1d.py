"""``group_calls_per_tile.1d``: the per-group sampler's (group, chunk)
draws per 1D tile, from the program's counters
(``memento_tpu_torch.utils.profiling.counters()``): ``ht1d.group_calls``
over ``ht1d.tiles``.  Whole process, warm-up included: a ratio.  Nothing
in an untraced run, or where the program keeps no such counters."""

import sys

PROGRAM = "memento_tpu_torch.utils.profiling"
CALLS = "ht1d.group_calls"
TILES = "ht1d.tiles"


def read(run):
    t = run.traced
    if t is None or t.kind != "1d":
        return None
    counters = getattr(sys.modules.get(PROGRAM), "counters", None)
    if counters is None:
        return None
    found = counters()
    if not found.get(TILES) or CALLS not in found:
        return None
    return found[CALLS] / found[TILES]
