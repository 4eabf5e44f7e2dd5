"""``dispatch_s.1d``: seconds per request of a traced run's
window, in the program's phase
``ht1d.dispatch``: the device program of the tiles, synchronized."""

PHASE = "ht1d.dispatch"


def read(run):
    t = run.traced
    if t is None or t.kind != "1d" or not t.n or PHASE not in t.phases:
        return None
    return t.phases[PHASE] / t.n
