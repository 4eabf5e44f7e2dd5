"""``api_layout_s.1d``: seconds per request of a traced run's window in the
API's data layout, by the program's spans: ``setup_memento.layout`` (the
CSR and the AnnData's keys), ``create_groups.labels`` (the label strings),
``create_groups.split`` (the CSC copy and the per-group row slices) and
``compute_1d_moments.subset`` (the filtered column subsets)."""

PHASES = ("setup_memento.layout", "create_groups.labels",
          "create_groups.split", "compute_1d_moments.subset")


def read(run):
    t = run.traced
    if t is None or t.kind != "1d" or not t.n:
        return None
    if not any(p in t.phases for p in PHASES):
        return None
    return sum(t.phases.get(p, 0.0) for p in PHASES) / t.n
