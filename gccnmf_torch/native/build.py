"""Lazy build of the native host-runtime library (counterpart of
``gccnmf_tpu/native/build.py``).

Compiles ``src/gccnmf_rt.cpp`` with one ``g++ -O3 -shared`` call the first
time it is needed, into ``gccnmf_torch/build/`` (the kernels' build
directory) under a name that carries a hash of the source and the compiler,
so an edit builds a new library and never reuses a stale one. The compiler
writes a per-process temporary name that ``os.replace`` publishes
atomically: several processes (test workers) may build at once. Nothing
builds at import time; without a C++ compiler :func:`build` returns None
and the runtime takes its NumPy path.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path

logger = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "src" / "gccnmf_rt.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden", "-Wall"]

__all__ = ["lib_path", "build", "find_compiler", "SRC", "BUILD_DIR"]


def find_compiler() -> str | None:
    for cc in (os.environ.get("CXX"), "g++", "clang++"):
        if cc and shutil.which(cc):
            return cc
    return None


def _fingerprint(compiler: str) -> str:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join([compiler, *CXX_FLAGS]).encode())
    return h.hexdigest()[:16]


def lib_path(compiler: str) -> Path:
    """Where the library built by ``compiler`` from the current source lives."""
    return BUILD_DIR / f"libgccnmf_torch_rt_{_fingerprint(compiler)}.so"


def build(force: bool = False) -> str | None:
    """Build (if not built yet) and return the shared library's path, or
    None without a compiler or when the compile fails."""
    compiler = find_compiler()
    if compiler is None:
        logger.info("no C++ compiler found; native runtime disabled")
        return None
    out = lib_path(compiler)
    if out.exists() and not force:
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp_out = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    cmd = [compiler, *CXX_FLAGS, str(SRC), "-o", str(tmp_out)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:  # pragma: no cover
        logger.warning("native runtime build failed:\n%s", e.stderr)
        tmp_out.unlink(missing_ok=True)
        return None
    os.replace(tmp_out, out)
    logger.info("built native runtime: %s", out)
    return str(out)
