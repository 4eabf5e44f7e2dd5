"""``peak_host_gib``: the process's peak resident set, set-up included,
read when the window closes (before the reference runs)."""


def read(run):
    return run.peak_host_bytes / 2**30
