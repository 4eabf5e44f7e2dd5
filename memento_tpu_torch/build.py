"""Build the port's native libraries and load them by ctypes.

Every library in ``LIBRARIES`` is one entry: its compiler, its sources and
its flags.  The CUDA kernels (``csrc/<name>.cu``, one library each, with a
plain C interface) build with ``nvcc`` for Hopper; the native host layer
(``native/*.cpp``, one library) with ``g++`` and the JAX package's Makefile
flags.  Each compiles, at first use and from the package's own sources, into
``_build/lib<name>-<hash>.so``.  The hash covers the sources, the flags, the
compiler's ``--version`` and, where the flags hold ``-march=native``, the
CPU's model and instruction-set flags: an edited source, another flag,
another compiler or another host never loads a stale library.  Under an
``flock`` per library, each build compiles to a pid-unique file renamed
into place, so a concurrent process waits and then loads the whole library;
the compiler's output (for ``nvcc``, the ptxas report) is kept beside it as
``lib<name>-<hash>.log``.  ``build()`` starts every compiler at once and
waits for all of them.  A failed build or load raises ``RuntimeError`` with
the compiler's or loader's message.  Nothing runs at import time, and this
module imports nothing from the package.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-fopenmp",
             "-std=c++17")


class Library(NamedTuple):
    compiler: str  # "nvcc" (found by ``nvcc_path``) or a command on PATH
    sources: tuple  # paths under the package
    flags: tuple


LIBRARIES = {
    "cascade_bootstrap": Library("nvcc", ("csrc/cascade_bootstrap.cu",),
                                 NVCC_FLAGS),
    # the GEV refit rounds every product and sum on its own, as numpy does
    # (no fused multiply-add contractions)
    "gev_refine": Library("nvcc", ("csrc/gev_refine.cu",),
                          NVCC_FLAGS + ("-fmad=false",)),
    "multinomial_bootstrap": Library("nvcc",
                                     ("csrc/multinomial_bootstrap.cu",),
                                     NVCC_FLAGS),
    "native": Library("g++", ("native/compress.cpp", "native/suffstats.cpp",
                              "native/pairs.cpp"), CXX_FLAGS),
}

_LOCKS: dict = {}  # name -> the lock of its first load
_LOADED: dict = {}
# name -> {"version": the compiler's --version, "seconds": the build's time
# (0 when built earlier), "log": the compiler's output}
BUILD_LOG: dict = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def _command(compiler: str) -> str:
    return nvcc_path() if compiler == "nvcc" else compiler


@functools.lru_cache(maxsize=None)
def compiler_version(compiler: str) -> str:
    """``compiler --version``, run once per process and compiler."""
    try:
        proc = subprocess.run([_command(compiler), "--version"],
                              capture_output=True, text=True, timeout=60)
    except OSError as exc:
        raise RuntimeError(f"cannot run {compiler!r}: {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} --version failed:\n{proc.stderr}")
    return proc.stdout


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


def library_path(name: str) -> Path:
    lib = LIBRARIES[name]
    h = hashlib.sha256()
    for source in lib.sources:
        h.update((PACKAGE_DIR / source).read_bytes())
    for part in (" ".join(lib.flags), compiler_version(lib.compiler)):
        h.update(b"\0" + part.encode())
    if "-march=native" in lib.flags:
        h.update(_cpu_fingerprint())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


@contextlib.contextmanager
def _flock(name: str):
    with open(BUILD_DIR / f"lib{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


def build(names=None) -> dict:
    """Compile every named library (default: all) that is not built yet,
    every compiler at once; returns ``{name: library path}``."""
    names = sorted(LIBRARIES if names is None else set(names))
    paths = {name: library_path(name) for name in names}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, failures = {}, []
    with contextlib.ExitStack() as locks:
        for name in names:  # one order, so two processes never deadlock
            path = paths[name]
            if not path.exists():
                locks.enter_context(_flock(name))
            lib = LIBRARIES[name]
            version = compiler_version(lib.compiler)
            if path.exists():
                if name not in BUILD_LOG:
                    log = path.with_suffix(".log")
                    BUILD_LOG[name] = {
                        "version": version, "seconds": 0.0,
                        "log": log.read_text() if log.exists() else ""}
                continue
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [_command(lib.compiler), *lib.flags, "-o", str(tmp),
                   *(str(PACKAGE_DIR / s) for s in lib.sources)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            jobs[name] = (proc, cmd, tmp, version, time.perf_counter())
        for name, (proc, cmd, tmp, version, start) in jobs.items():
            out, err = proc.communicate()
            path = paths[name]
            BUILD_LOG[name] = {"version": version,
                               "seconds": time.perf_counter() - start,
                               "log": out + err}
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failures.append(f"{name} build failed ({' '.join(cmd)}, exit "
                                f"{proc.returncode}):\n{err}")
                continue
            path.with_suffix(".log").write_text(out + err)
            os.replace(tmp, path)  # atomic: a loader sees all or none
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The named library, built on first use; a thread that loads one
    library does not wait for another's build."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOCKS.setdefault(name, threading.Lock()):
        if name not in _LOADED:
            path = build([name])[name]
            try:
                _LOADED[name] = ctypes.CDLL(str(path))
            except OSError as exc:
                raise RuntimeError(f"library {path.name} does not load: "
                                   f"{exc}") from exc
        return _LOADED[name]


__all__ = ["build", "load", "library_path", "compiler_version", "nvcc_path",
           "Library", "LIBRARIES", "BUILD_DIR", "BUILD_LOG", "NVCC_FLAGS",
           "CXX_FLAGS"]
