"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/empanada_torch/`` (git-ignored; the file name carries a hash of
the source, so an edited kernel is rebuilt) and loaded with ctypes.
Nothing here runs at import time: the CPU test machines have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["KERNEL_SOURCES", "build", "build_all", "build_log", "load"]

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "empanada_torch"
KERNEL_SOURCES = ("group_pixels",)

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC"]

_lock = threading.Lock()
_libs = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built; returns
    (target, temporary output, Popen or None)."""
    target = _target(name)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name, target, tmp, proc):
    if proc is None:
        return target
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):"
                           f"\n{out}")
    target.with_suffix(".log").write_text(out)
    os.replace(tmp, target)
    return target


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers, shared memory, spills) from the
    build of the current ``csrc/<name>.cu``; empty if it is not built."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names=KERNEL_SOURCES):
    """Compile every kernel source in parallel (one nvcc each); returns
    {name: library path}."""
    with _lock:
        started = {name: _start(name) for name in names}
        return {name: _finish(name, *started[name]) for name in names}


def build(name: str) -> Path:
    return build_all((name,))[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    path = build(name)
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]
