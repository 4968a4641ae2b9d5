"""Build the port's C++ host core (``core/_native/core.cpp``).

At first use the source is compiled with ``g++`` called directly (no
make: a machine with only a CUDA toolkit and its host compiler builds
it) into a shared library under ``build/empanada_torch/`` (git-ignored).
The file name carries a hash of the source and the flags, so an edited
source is rebuilt and a library on disk is never stale. Nothing here
runs at import time.

The compiler is ``$CXX`` when that is set, else ``g++``. A build that
fails raises with the compiler's output: no caller falls back to numpy
because the library is missing.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from empanada_torch.cuda_build import BUILD_DIR, PKG_DIR

__all__ = ["SOURCE", "CXX_FLAGS", "compiler", "build"]

SOURCE = PKG_DIR / "core" / "_native" / "core.cpp"

# no -march=native: the library may be built on one machine and loaded on
# another, and the entry points are bound by memory walks and heap pops,
# not by vector arithmetic
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()


def compiler() -> str:
    """Path of the C++ compiler: ``$CXX`` if set, else ``g++``."""
    name = os.environ.get("CXX") or "g++"
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(
            f"C++ compiler {name!r} not found: the host core "
            f"({SOURCE.name}) is built with g++ at first use; set CXX to "
            f"a compiler, or EMPANADA_TORCH_NO_NATIVE=1 to ask for the "
            f"numpy host half by name")
    return found


def _target(build_dir: Path) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return build_dir / f"libetpu_core-{digest}.so"


def build(build_dir=None) -> Path:
    """Compile the host core unless its library is already in
    ``build_dir`` (default ``build/empanada_torch/``); returns the
    library's path. Safe when several threads or processes build at
    once: each compiles into a temporary of its own and renames it into
    place."""
    build_dir = BUILD_DIR if build_dir is None else Path(build_dir)
    target = _target(build_dir)
    with _lock:
        if target.exists():
            return target
        cxx = compiler()
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{' '.join(cmd)} failed (rc {proc.returncode}):\n"
                    f"{proc.stdout}")
            os.replace(tmp, target)
        finally:
            if tmp.exists():
                tmp.unlink()
    return target
