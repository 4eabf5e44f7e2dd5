"""Build the native host library with ``g++`` and load it by ctypes.

``compress.cpp``, ``suffstats.cpp`` and ``pairs.cpp`` compile, at first use
and from the package's own sources, into ``_build/libnative-<hash>.so`` with
the JAX package's Makefile flags; ``g++``'s output is kept beside it as
``libnative-<hash>.log``.  ``-march=native`` ties the library to the CPU it
was built on, so the hash covers the sources, the flags, ``g++ --version``
and the CPU's model and instruction-set flags: a library built on another
host is never loaded.  An ``flock`` serializes concurrent builds (test
workers), each compiling to a pid-unique file renamed into place, so nobody
loads a half-written library.  A failed build or load raises
``RuntimeError`` with the compiler's or loader's message; nothing runs at
import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
import time
from pathlib import Path

from ..ops.kernel_build import BUILD_DIR

SOURCE_DIR = Path(__file__).resolve().parent
SOURCES = ("compress.cpp", "suffstats.cpp", "pairs.cpp")
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-fopenmp",
             "-std=c++17"]

_LOCK = threading.Lock()
_LIB = None
BUILD_LOG: dict = {}  # "compiler", "seconds" (0 when built earlier), "output"


def _cpu_fingerprint() -> bytes:
    """The CPU's model name and instruction-set flags (what ``-march=native``
    compiles for)."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return f"{platform.machine()} {platform.processor()}".encode()
    keep = [ln for ln in lines if ln.split(":")[0].strip()
            in ("model name", "flags", "Features", "CPU part")]
    return "\n".join(sorted(set(keep))).encode()


def _compiler_version() -> str:
    try:
        proc = subprocess.run([CXX, "--version"], capture_output=True,
                              text=True, timeout=60)
    except OSError as exc:
        raise RuntimeError(f"native build: cannot run {CXX!r}: {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"native build: {CXX} --version failed:\n"
                           f"{proc.stderr}")
    return proc.stdout


def library_path(version: str) -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((SOURCE_DIR / name).read_bytes())
    for part in (" ".join(CXX_FLAGS), version):
        h.update(part.encode())
    h.update(_cpu_fingerprint())
    return BUILD_DIR / f"libnative-{h.hexdigest()[:16]}.so"


def _build(lib: Path, version: str) -> None:
    """Compile the sources into ``lib`` unless another process has already
    done so; under an exclusive ``flock``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libnative.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [CXX, *CXX_FLAGS, "-o", str(tmp),
               *(str(SOURCE_DIR / name) for name in SOURCES)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        BUILD_LOG.update(seconds=time.perf_counter() - start,
                         output=proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"native build failed ({' '.join(cmd)}, exit "
                f"{proc.returncode}):\n{proc.stderr}")
        lib.with_suffix(".log").write_text(f"{version}\n{BUILD_LOG['output']}")
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none


def load() -> ctypes.CDLL:
    """The native library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            version = _compiler_version()
            lib = library_path(version)
            BUILD_LOG.update(compiler=version.splitlines()[0], seconds=0.0)
            if not lib.exists():
                _build(lib, version)
            try:
                _LIB = ctypes.CDLL(str(lib))
            except OSError as exc:
                raise RuntimeError(f"native library {lib.name} does not "
                                   f"load: {exc}") from exc
        return _LIB


def omp_threads() -> int:
    """OpenMP's thread count in the library's parallel regions."""
    fn = load().omp_get_max_threads  # libgomp, resolved through the library
    fn.restype = ctypes.c_int
    return int(fn())


__all__ = ["load", "library_path", "omp_threads", "BUILD_LOG", "SOURCES",
           "CXX", "CXX_FLAGS"]
