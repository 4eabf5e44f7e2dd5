"""``gev_wait_s.1d``: seconds per request of a traced run's
window, in the program's phase
``ht1d.gev.join``: the wait for the GEV tail refits at the end of a
test, the part of the worker's time the caller is exposed to."""

PHASE = "ht1d.gev.join"


def read(run):
    t = run.traced
    if t is None or t.kind != "1d" or not t.n or PHASE not in t.phases:
        return None
    return t.phases[PHASE] / t.n
