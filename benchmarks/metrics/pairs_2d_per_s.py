"""``pairs_2d_per_s``: gene pairs tested by the window's completed queries
per second, from the window's start to the last completion."""


def read(run):
    if run.kind != "2d" or run.window_s <= 0:
        return None
    return sum(r.work for r in run.records) / run.window_s
