"""``setup_s``: seconds from the process's start to the window's: imports,
the data drawn on the card, the warm-up request, and in a traced run the
profiler's first start."""


def read(run):
    return run.setup_s
