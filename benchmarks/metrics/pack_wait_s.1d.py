"""``pack_wait_s.1d``: seconds per request of a traced run's window in
the program's span ``ht1d.pack.wait``: the dispatching thread waiting for
the prefetch thread's packed tile, the part of packing the request pays
for."""

PHASE = "ht1d.pack.wait"


def read(run):
    t = run.traced
    if t is None or t.kind != "1d" or not t.n or PHASE not in t.phases:
        return None
    return t.phases[PHASE] / t.n
