"""Build the port's CUDA kernels and bind them with ``ctypes``.

Every ``gccnmf_torch/csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) for ``sm_90a``, then linked into one shared library
with a plain C interface. The library is cached in ``gccnmf_torch/build/``
under a hash of the sources and flags, so the first call in a fresh checkout
builds everything and later calls load it. Nothing builds at import time.

No ``--use_fast_math``: the fp32 path needs IEEE ``/`` and ``sqrtf`` to
match the guarded divides of the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

__all__ = ["library", "launch", "require_cuda", "CSRC_DIR", "BUILD_DIR"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float

# C entry points: name → argument types (every pointer and the stream as
# c_void_p, so ctypes never cuts a 64-bit address to an int).
_SIGNATURES = {
    "gccnmf_kl_nmf": [
        _P, _I, _I, _P, _P, _P, _P, _I,  # v v_bf16 ldv w h wb hb ldk
        _P, _I, _P, _P, _P, _P, _P,  # q ldq part wsum hsum norms vsum
        _I, _I, _I, _I, _I, _I, _I,  # B T F K iters splits split_rows
        _F, _F, _I, _P,  # alpha eps mode stream
    ],
    "gccnmf_frontend": [
        _P, _I, _L, _I, _I,  # x B n hop win
        _P, _P, _P, _I, _I, _P, _P, _P,  # window twiddle radix passes conjugate y0 cos sin
        _P, _I, _I, _P, _I,  # basis nb ldw steer ldj
        _P, _L, _I, _P,  # stage ldx frame_rows crows
        _I, _I, _I, _I, _I,  # T F D rnd plane_bf16
        _P, _P, _P, _P, _P, _P, _P,  # sre sim mag cre cim ang stream
    ],
    "gccnmf_masked_synthesis": [
        _P, _P, _I, _I, _P, _P, _P,  # sre sim plane_bf16 ldf winner w h
        _P, _P, _P, _I,  # scale twiddle radix passes (the float32 FFT)
        _P, _I, _P, _P, _P,  # basis_rows ldj x frames out
        _I, _I, _I, _I, _I, _I, _I, _I, _I,  # B S C T F K win hop rnd
        _P,  # stream
    ],
    "gccnmf_soft_mask": [
        _P, _P, _I, _I, _P, _P, _P, _P, _I,  # cre cim plane_bf16 ldf cw sw fold rows ldj
        _P, _P, _P, _P, _P,  # params pmax parg hmask argout
        _I, _I, _I, _I, _I, _I, _I,  # B T F K D splits chunk
        _P,  # stream
    ],
    "gccnmf_tf_synthesis": [
        _P, _P, _I, _I, _P, _P,  # sre sim plane_bf16 ldf hmask wn
        _P, _P, _P, _I,  # scale twiddle radix passes (the float32 FFT)
        _P, _I, _P, _P, _P,  # basis_rows ldj x frames out
        _I, _I, _I, _I, _I, _I, _I, _I,  # B C T F K win hop rnd
        _P,  # stream
    ],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log: str = ""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(so_path: Path, sources: list[Path]) -> str:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        try:
            for src, _, proc in procs:
                out, _ = proc.communicate(timeout=900)
                logs.append(f"== {src.name}\n{out}")
                if proc.returncode != 0:
                    failed.append(src.name)
        finally:  # a timeout or interrupt leaves no compiler running
            for _, _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_so = Path(tmp) / so_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_so), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=300,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so_path)  # atomic: a concurrent build never sees half a file
    return log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use. Raises if ``nvcc`` is
    missing or a source does not compile."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            sources = sorted(CSRC_DIR.glob("*.cu"))
            so_path = BUILD_DIR / f"libgccnmf_torch_{_digest()}.so"
            if not so_path.exists():
                build_log = _compile(so_path, sources)
            lib = ctypes.CDLL(str(so_path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s current stream (appended
    as the last argument) and raise on a non-zero ``cudaError_t``. Pointers
    are ``tensor.data_ptr()`` ints; the caller keeps the tensors alive."""
    fn = getattr(library(), name)
    with torch.cuda.device(device):
        status = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status}")


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The common CUDA device of ``tensors``; raises if any lies elsewhere."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
    return dev
