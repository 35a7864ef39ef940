"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them by ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<digest>.so``, where the
digest covers the source, the shared header and the flags, so a changed
source is rebuilt and an unchanged one is reused. Every source has a plain C
interface (no PyTorch headers), so a build takes seconds. Several sources
build in parallel: one ``nvcc`` process each, all started together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_SOURCES = ("mobius_linear", "kde_argmax", "critic_step")


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
