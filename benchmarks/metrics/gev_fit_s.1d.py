"""``gev_fit_s.1d``: seconds per request of a traced run's window in the
program's span ``ht1d.gev.fit``: the GEV worker's batched tail fits, busy
time on its own thread (the copy of the rows before them is
``ht1d.gev.refine.wait``)."""

PHASE = "ht1d.gev.fit"


def read(run):
    t = run.traced
    if t is None or t.kind != "1d" or not t.n or PHASE not in t.phases:
        return None
    return t.phases[PHASE] / t.n
