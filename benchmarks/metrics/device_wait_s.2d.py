"""``device_wait_s.2d``: seconds per request of a traced run's window in
which the dispatching thread is blocked on the device: the program's spans
``ht2d.launch.wait`` (reads inside the device program) and
``ht2d.harvest.wait`` (the results' copies back)."""

PHASES = ("ht2d.launch.wait", "ht2d.harvest.wait")


def read(run):
    t = run.traced
    if t is None or t.kind != "2d" or not t.n:
        return None
    if not any(p in t.phases for p in PHASES):
        return None
    return sum(t.phases.get(p, 0.0) for p in PHASES) / t.n
