"""What every driver shares: its device, its knobs and its JSON line.

The last line a driver prints on stdout is one JSON object.  Beside the
keys of the JAX driver it replaces, it holds ``resources()``: the peak
device memory (``torch.cuda.max_memory_allocated``), the peak and current
host RSS, the cascade kernel's launches (the wrapper's counters: the run's
own and the first-use warm-up's) and ``card``, the card's name and power
limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
gives them (``None`` on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess

import numpy as np
import torch

from ..ops import cuda_kernels
from ._data import log  # noqa: F401  (the drivers' stderr log)


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def parse_args(doc: str, argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the "
                             "plain tensor path)")
    return parser.parse_args(argv)


def select_device(name: str) -> torch.device:
    """The driver's device; a CUDA device without CUDA raises (a driver
    never falls back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the drivers run on the card "
                           "unless --device cpu is given")
    return dev


def card_line(dev: torch.device):
    """The card's name and power limit as nvidia-smi prints them."""
    if dev.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def reset(dev: torch.device) -> None:
    """Zero the launch counters and the device's peak memory."""
    cuda_kernels.reset_launches()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def host_rss_bytes() -> int:
    """The process's resident set now (Linux ``/proc``)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def resources(dev: torch.device, with_card: bool = True) -> dict:
    """Peak device memory since ``reset``, host RSS (the process's peak and
    now), cascade launches since ``reset`` and (``with_card``) the card."""
    peak = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
    out = {
        "peak_device_gib": peak,
        "peak_host_rss_gib":
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
        "host_rss_gib": host_rss_bytes() / 2**30,
        "cascade_launches": cuda_kernels.LAUNCHES["cascade_bootstrap"],
        "warm_launches": cuda_kernels.WARM_LAUNCHES["cascade_bootstrap"],
    }
    if with_card:
        out["card"] = card_line(dev)
    return out


def null_calibration(pvals) -> dict:
    """On a null design: the share of finite p-values, their median and the
    share below 0.05."""
    p = np.asarray(pvals, dtype=np.float64).ravel()
    finite = np.isfinite(p)
    return {"finite_pval_frac": float(finite.mean()) if p.size else 0.0,
            "null_median_pval": float(np.median(p[finite]))
            if finite.any() else None,
            "null_fp_share_005": float((p[finite] < 0.05).mean())
            if finite.any() else None}


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)
