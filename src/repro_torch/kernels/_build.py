"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``repro_torch/csrc/<name>.cu`` becomes one shared library with a plain
C interface, compiled for Hopper (``sm_90a``) into ``build/repro_torch/``
at the repository root (git-ignored).  The library's file name carries a
hash of its source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source or header is rebuilt at its next use and a stale library
is never loaded.  ``build`` starts one ``nvcc`` per source, all at once.
Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(SRC_DIR.glob("*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on the machine with the card, which has the CUDA "
                       "toolkit")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(sources()[name].read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named source (default: all) whose library is missing,
    one ``nvcc`` process per source, all started together.  Returns the
    seconds each build took (0.0 for a library that was already there).
    The compiler's report (registers, shared memory, spills) goes to
    ``<lib>.log``."""
    names = list(sources()) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    took = {n: 0.0 for n in names}
    procs = {}
    for n in names:
        out = lib_path(n)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        procs[n] = (time.perf_counter(), tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(sources()[n])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (t0, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        took[n] = time.perf_counter() - t0
        lib_path(n).with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"CUDA build of {n} failed: nvcc exit "
                          f"{proc.returncode}\n{log}")
        else:
            os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("\n".join(failed))
    return took


def build_log(name: str) -> str:
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        if not lib_path(name).exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return lib
