"""``tests_1d_per_s``: 1D tests (one per gene and treatment column, DE and
DV together) of the window's completed requests per second, from the
window's start to the last completion."""


def read(run):
    if run.kind != "1d" or run.window_s <= 0:
        return None
    return sum(r.work for r in run.records) / run.window_s
