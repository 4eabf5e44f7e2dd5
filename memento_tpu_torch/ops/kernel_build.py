"""Build the hand-written CUDA kernels with ``nvcc`` and load them by ctypes.

Each ``csrc/<name>.cu`` compiles, at first use and from the package's own
sources, into ``_build/lib<name>-<hash>.so`` with a plain C interface
(``-gencode arch=compute_90a,code=sm_90a``, Hopper).  The hash is that of
the source, so an edited kernel is rebuilt and a stale library is never
loaded; ``nvcc``'s output (the ptxas report) is kept beside the library.
``build()`` starts one ``nvcc`` per source at once and waits for all of
them.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LOADED: dict = {}
BUILD_LOG: dict = {}  # name -> nvcc's stderr (ptxas register/spill report)


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build(names=None) -> dict:
    """Compile every named source (default: all) that has no library yet,
    all ``nvcc`` processes at once; returns ``{name: library path}``."""
    names = kernel_names() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            log = lib.with_suffix(".log")
            if name not in BUILD_LOG and log.exists():
                BUILD_LOG[name] = log.read_text()
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, lib)
    failures = []
    for name, (proc, tmp, lib) in procs.items():
        out, err = proc.communicate()
        BUILD_LOG[name] = out + err
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{err}")
            continue
        lib.with_suffix(".log").write_text(BUILD_LOG[name])
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return {name: library_path(name) for name in names}


def ptxas_usage(log: str) -> dict:
    """What ``ptxas -v`` reported for each kernel entry in an ``nvcc`` log:
    ``{mangled entry name: {"registers", "spill_store_bytes",
    "spill_load_bytes"}}``."""
    usage = {}
    for entry, body in re.findall(
            r"Compiling entry function '(\S+?)'(.*?)(?=Compiling entry|\Z)",
            log, flags=re.S):
        regs = re.search(r"Used (\d+) registers", body)
        stores = re.search(r"(\d+) bytes spill stores", body)
        loads = re.search(r"(\d+) bytes spill loads", body)
        usage[entry] = {
            "registers": int(regs.group(1)) if regs else None,
            "spill_store_bytes": int(stores.group(1)) if stores else None,
            "spill_load_bytes": int(loads.group(1)) if loads else None,
        }
    return usage


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = build([name])[name]
            lib = _LOADED[name] = ctypes.CDLL(str(path))
        return lib


__all__ = ["build", "load", "library_path", "kernel_names", "ptxas_usage",
           "BUILD_DIR", "BUILD_LOG"]
