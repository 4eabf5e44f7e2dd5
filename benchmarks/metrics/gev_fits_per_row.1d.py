"""``gev_fits_per_row.1d``: GEV fits per row refit, from the program's
counters (``memento_tpu_torch.utils.profiling.counters()``): rows fitted,
summed over the tail schedule's stages and both sides
(``ht1d.gev.fit_rows``), over rows sent to the refit (``ht1d.gev.rows``).
Whole process, warm-up included: a ratio.  Nothing in an untraced run, or
where the program keeps no such counters."""

import sys

PROGRAM = "memento_tpu_torch.utils.profiling"
ROWS = "ht1d.gev.rows"
FITS = "ht1d.gev.fit_rows"


def read(run):
    t = run.traced
    if t is None or t.kind != "1d":
        return None
    counters = getattr(sys.modules.get(PROGRAM), "counters", None)
    if counters is None:
        return None
    found = counters()
    if not found.get(ROWS):
        return None
    return found.get(FITS, 0) / found[ROWS]
