"""Build the hand-written CUDA kernels with ``nvcc`` and load them by ctypes.

Each ``csrc/<name>.cu`` compiles, at first use and from the package's own
sources, into ``_build/lib<name>-<hash>.so`` with a plain C interface
(``-gencode arch=compute_90a,code=sm_90a``, Hopper).  The hash is that of
the source, so an edited kernel is rebuilt and a stale library is never
loaded.  ``build()`` starts one ``nvcc`` per source at once and waits for
all of them.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = build([name])[name]
            lib = _LOADED[name] = ctypes.CDLL(str(path))
        return lib


__all__ = ["build", "load", "library_path", "kernel_names", "BUILD_DIR",
           "BUILD_LOG"]
