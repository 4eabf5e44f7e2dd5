"""``api_host_s.2d``: seconds per request of a traced run's
window, in the API's host stages,
by the harness's spans around the calls into ``api.py``
(``compute_2d_moments``)."""

SPANS = ("api.compute_2d_moments",)


def read(run):
    t = run.traced
    if t is None or t.kind != "2d" or not t.n:
        return None
    if not any(s in t.spans for s in SPANS):
        return None
    return sum(t.spans.get(s, 0.0) for s in SPANS) / t.n
