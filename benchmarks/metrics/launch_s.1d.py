"""``launch_s.1d``: seconds per request of a traced run's window in
which the host launches the tiles' device program: the program's span
``ht1d.launch`` less its waits for the device, ``ht1d.launch.wait``."""

PHASE = "ht1d.launch"
WAIT = "ht1d.launch.wait"


def read(run):
    t = run.traced
    if t is None or t.kind != "1d" or not t.n or PHASE not in t.phases:
        return None
    return (t.phases[PHASE] - t.phases.get(WAIT, 0.0)) / t.n
