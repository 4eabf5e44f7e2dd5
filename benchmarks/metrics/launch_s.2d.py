"""``launch_s.2d``: seconds per request of a traced run's window in
which the host launches the tiles' device program: the program's span
``ht2d.launch`` less its waits for the device, ``ht2d.launch.wait``."""

PHASE = "ht2d.launch"
WAIT = "ht2d.launch.wait"


def read(run):
    t = run.traced
    if t is None or t.kind != "2d" or not t.n or PHASE not in t.phases:
        return None
    return (t.phases[PHASE] - t.phases.get(WAIT, 0.0)) / t.n
