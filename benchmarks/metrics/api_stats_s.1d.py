"""``api_stats_s.1d``: seconds per request of a traced run's window in the
API's host statistics, by the program's spans: ``setup_memento``'s
``size_factor``, ``moments`` and ``fit``, and ``compute_1d_moments``'s
``sf_bins``, ``observed``, ``filter`` and ``fit``."""

PHASES = ("setup_memento.size_factor", "setup_memento.moments",
          "setup_memento.fit", "compute_1d_moments.sf_bins",
          "compute_1d_moments.observed", "compute_1d_moments.filter",
          "compute_1d_moments.fit")


def read(run):
    t = run.traced
    if t is None or t.kind != "1d" or not t.n:
        return None
    if not any(p in t.phases for p in PHASES):
        return None
    return sum(t.phases.get(p, 0.0) for p in PHASES) / t.n
