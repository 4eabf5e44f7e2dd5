"""``device_idle_share.1d``: percent of the profiled requests' trace in
which no kernel, copy or memset ran on the device."""


def read(run):
    t = run.traced
    if t is None or t.kind != "1d" or t.summary.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - t.summary["busy_s"] / t.summary["window_s"])
