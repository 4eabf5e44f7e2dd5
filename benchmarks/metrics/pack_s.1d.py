"""``pack_s.1d``: seconds per request of a traced run's
window, in the program's phase
``ht1d.compress+pack``: the tile loop's host packing, busy time on
its prefetch thread."""

PHASE = "ht1d.compress+pack"


def read(run):
    t = run.traced
    if t is None or t.kind != "1d" or not t.n or PHASE not in t.phases:
        return None
    return t.phases[PHASE] / t.n
