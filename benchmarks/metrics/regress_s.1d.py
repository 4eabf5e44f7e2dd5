"""``regress_s.1d``: device seconds per request of a traced run's window
in the tiles' two meta-regressions, the program's device span
``ht1d.regress`` (two CUDA events around them).  Nothing where the program
has no such span."""

PHASE = "ht1d.regress"


def read(run):
    t = run.traced
    if t is None or t.kind != "1d" or not t.n or PHASE not in t.phases:
        return None
    return t.phases[PHASE] / t.n
