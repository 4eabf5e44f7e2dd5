"""``treatment_s.1d``: seconds per request of a traced run's window in
which ``ht_1d_moments`` builds the per-gene treatments of
``treatment_for_gene`` (eQTL mode), the program's span
``ht_1d_moments.treatment``.  Nothing where the program has no such span."""

PHASE = "ht_1d_moments.treatment"


def read(run):
    t = run.traced
    if t is None or t.kind != "1d" or not t.n or PHASE not in t.phases:
        return None
    return t.phases[PHASE] / t.n
