"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them by ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<digest>.so``, where the
digest covers the source, the shared header and the flags, so a changed
source is rebuilt and an unchanged one is reused. Every source has a plain C
interface (no PyTorch headers), so a build takes seconds. Several sources
build in parallel: one ``nvcc`` process each, all started together.

The host job: ``csrc/host/*.cpp`` (the native preprocessing and threshold
engine, ``data/native.py``) becomes ``_build/libhypad_host-<digest>.so``
through ``g++`` with the flags of the JAX package's native Makefile
(``-ffp-contract=off`` keeps a + b * c two roundings, as numpy's, or the
thresholds drift by an ulp). Its digest also covers the host CPU's flags,
since ``-march=native`` code runs only where it was built. Several
processes (test workers) may ask for it at once: each builds under an
exclusive file lock into a temporary name that ``os.replace`` moves into
place, so none loads a half-written library.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_SOURCES = ("mobius_linear", "kde_argmax", "critic_step")
HOST_SOURCES = ("pipeline.cpp", "thresholds.cpp")
HOST_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fPIC",
              "-std=c++17", "-Wall", "-shared")


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name) -> Path:
    """Where the shared library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha1()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=KERNEL_SOURCES, extra_jobs=None):
    """Compile every source in ``names`` that has no current library, and
    the ``compile_sources`` jobs in ``extra_jobs``, all ``nvcc`` processes
    at once. Returns {name: (seconds, ptxas report)}; raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return compile_sources({**{name: (CSRC / f"{name}.cu", library_path(name))
                               for name in names
                               if not library_path(name).exists()},
                            **(extra_jobs or {})})


def compile_sources(jobs):
    """Compile each ``{name: (source, library)}`` with ``nvcc`` into a
    shared library, all processes at once, with ``csrc/`` on the include
    path. Returns {name: (seconds, ptxas report)}; raises with the
    compiler's output if any build fails."""
    procs = {}
    t0 = time.perf_counter()
    for name, (src, out) in jobs.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name} (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


@functools.cache
def load(name) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    path = library_path(name)
    if not path.exists():
        build((name,))
    return ctypes.CDLL(str(path))


def instance(width):
    """The kernel instance a launch whose widest width is ``width`` takes,
    as every source in ``csrc/`` decides: "narrow" up to 128, "wide" up to
    256, else "xwide" (the any-width instance)."""
    return "narrow" if width <= 128 else "wide" if width <= 256 else "xwide"


def count_launch(fn, kind):
    """One launch of the kernel wrapper ``fn``, of instance ``kind``:
    ``fn.launches`` counts every launch, ``fn.wide_launches`` and
    ``fn.xwide_launches`` those of the wide and the any-width instance."""
    fn.launches += 1
    fn.wide_launches += kind == "wide"
    fn.xwide_launches += kind == "xwide"


def _cpu_flags():
    """The host CPU's feature line (what ``-march=native`` compiles for)."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("flags")), "")
    except OSError:
        return platform.processor()


def host_library_path() -> Path:
    """Where the host engine built from ``csrc/host/`` lives."""
    h = hashlib.sha1()
    for name in HOST_SOURCES:
        h.update((CSRC / "host" / name).read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    h.update((platform.machine() + _cpu_flags()).encode())
    return BUILD_DIR / f"libhypad_host-{h.hexdigest()[:12]}.so"


def build_host():
    """The host engine's library path, compiled with ``g++`` first if it
    is not there (under an exclusive lock; a temporary name, then
    ``os.replace``). Raises with the compiler's output if the build
    fails, or if ``g++`` is missing."""
    out = host_library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():   # another process built it while we waited
            return out
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the host engine cannot build")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [cxx, *HOST_FLAGS, "-o", str(tmp),
             *(str(CSRC / "host" / name) for name in HOST_SOURCES)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"host engine build failed (g++ exit "
                               f"{proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    return out
