"""``api_host_s.1d``: seconds per request of a traced run's
window, in the API's host stages,
by the harness's spans around the calls into ``api.py``
(``setup_memento``, ``create_groups``, ``compute_1d_moments``)."""

SPANS = ("api.setup_memento", "api.create_groups", "api.compute_1d_moments")


def read(run):
    t = run.traced
    if t is None or t.kind != "1d" or not t.n:
        return None
    if not any(s in t.spans for s in SPANS):
        return None
    return sum(t.spans.get(s, 0.0) for s in SPANS) / t.n
