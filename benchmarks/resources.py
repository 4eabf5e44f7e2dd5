"""Peak memory of a run, host and device.

The arithmetic is a frozen copy of ``memento_tpu_torch/drivers/_report.py::
resources`` (at commit dd20120): the host's peak resident set from
``getrusage`` (``ru_maxrss``, KiB on Linux), the device's from
``torch.cuda.max_memory_allocated``.
"""

from __future__ import annotations

import resource


def peak_host_rss_bytes() -> int:
    """The process's peak resident set so far, set-up included."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def peak_device_bytes(device) -> int:
    """The device's peak allocated memory since the run began (0 on the
    CPU)."""
    import torch

    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


def device_info(device, peak_bytes: int) -> dict:
    """The result line's ``device``."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": peak_bytes}


__all__ = ["peak_host_rss_bytes", "peak_device_bytes", "device_info"]
