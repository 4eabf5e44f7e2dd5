"""``dispatch_s.2d``: seconds per request of a traced run's
window, in the program's phase
``ht2d.dispatch``: the device program of the tiles, synchronized."""

PHASE = "ht2d.dispatch"


def read(run):
    t = run.traced
    if t is None or t.kind != "2d" or not t.n or PHASE not in t.phases:
        return None
    return t.phases[PHASE] / t.n
