#!/usr/bin/env python3
"""Where the tensor-core NMF kernels of the materialised-Q route spend their
time, block by block, on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_nmf_phases.py [--batch 16]
[--seed 0] [--no-prefetch]``. It builds an instrumented copy of
``gccnmf_torch/csrc/nmf.cu`` into a temporary directory: thread 0 of every
block of the three tensor-core kernels reads ``%globaltimer`` when the block
starts, after its main loop, after staging its output tile, and at its end.
It runs ``kl_nmf_cuda`` (``bfloat16_q_simul``, turbo, which launches all
three: ``bfloat16_q`` keeps Q on chip at K = 128 and launches none of
them) through that copy at the reference
shape (2T = 2486, F = 513, K = 128, random bf16 V from ``--seed``), one
iteration for the stamps of its last launch of each kernel, and prints per
kernel one JSON line: blocks, span, mean block life, the mean of each phase,
and the mean number of blocks in flight (block lives over the span). Then
the time of 100 iterations through the same copy (CUDA events). With
``--no-prefetch`` the ratio kernel's L2 prefetch is left out, the other side
of the comparison behind it. Needs a card and ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

T, F, K = 2486, 513, 128
KERNELS = ("tc_wh_ratio_kernel", "tc_h_update_kernel", "tc_qth_split_kernel")
MODE = "bfloat16_q_simul"  # the materialised route, all three kernels
MAX_BLOCKS = 16384

STAMPS = f"""
__device__ unsigned long long phase_stamps[3][{MAX_BLOCKS}][4];
#define STAMP(KID, I)                                                              \\
  if (threadIdx.x == 0) {{                                                          \\
    unsigned long long now;                                                        \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));                        \\
    phase_stamps[KID][blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)][I] = now; \\
  }}
extern "C" int phase_stamps_get(void* out) {{
  return (int)cudaMemcpyFromSymbol(out, phase_stamps, sizeof(phase_stamps));
}}
"""


def instrument(src: str, csrc: str, prefetch: bool) -> str:
    """nmf.cu with a stamp at each phase boundary of the tensor-core
    kernels; raises if the source no longer has the expected landmarks."""
    src = src.replace('#include "common.cuh"', f'#include "{csrc}/common.cuh"')
    src = src.replace('#include "simt_gemm.cuh"', f'#include "{csrc}/simt_gemm.cuh"')
    src = src.replace('#include "tc_gemm.cuh"', f'#include "{csrc}/tc_gemm.cuh"')
    src = src.replace("namespace {\n", STAMPS + "namespace {\n", 1)
    for kid, name in enumerate(KERNELS):
        start = src.index("{\n", src.index(name + "(")) + 2
        src = src[:start] + f"  STAMP({kid}, 0);\n" + src[start:]
        after_loop = src.index(";\n", src.index("tc::gemm<", start)) + 2
        src = src[:after_loop] + f"  STAMP({kid}, 1);\n" + src[after_loop:]
        staged = src.index("\n", src.index("tc::stage_acc<TL>(acc, s);", after_loop)) + 1
        src = src[:staged] + f"  STAMP({kid}, 2);\n" + src[staged:]
        end = src.index("\n}\n\n", staged)
        body = src[staged:end].replace("return;", f"{{ STAMP({kid}, 3); return; }}")
        src = src[:staged] + body + f"\n  STAMP({kid}, 3);" + src[end:]
    if not prefetch:
        start = src.index("  tc::prefetch_tile_l2(")
        src = src[:start] + src[src.index(";\n", start) + 2:]
    return src


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-prefetch", action="store_true")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_nmf_phases: CUDA is not available", file=sys.stderr)
        return 1
    from gccnmf_torch import _build
    from gccnmf_torch.ops.nmf import nmf_init_numpy
    from gccnmf_torch.ops.nmf_cuda import _splits, kl_nmf_cuda

    b = args.batch
    splits, _ = _splits(T)
    blocks = {"tc_wh_ratio_kernel": -(-F // 64) * -(-T // 128) * b,
              "tc_h_update_kernel": -(-K // 128) * -(-T // 128) * b,
              "tc_qth_split_kernel": -(-K // 128) * -(-F // 128) * b * splits}
    if max(blocks.values()) > MAX_BLOCKS:
        raise SystemExit(f"chip_nmf_phases: --batch {b} needs more than {MAX_BLOCKS} blocks")
    csrc = str(_build.CSRC_DIR)
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "nmf_phases.cu"), os.path.join(tmp, "nmf_phases.so")
        with open(os.path.join(csrc, "nmf.cu")) as fh:
            src = instrument(fh.read(), csrc, prefetch=not args.no_prefetch)
        with open(cu, "w") as fh:
            fh.write(src)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, cu],
                       check=True, capture_output=True, timeout=900)
        lib = ctypes.CDLL(so)
    lib.gccnmf_kl_nmf.argtypes = _build._SIGNATURES["gccnmf_kl_nmf"]
    lib.gccnmf_kl_nmf.restype = ctypes.c_int
    lib.phase_stamps_get.argtypes = [ctypes.c_void_p]
    _build._lib = lib  # kl_nmf_cuda launches through the instrumented copy

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    v = torch.as_tensor(rng.random((b, T, F), dtype=np.float32), device=dev).to(torch.bfloat16)
    w0n, h0n = nmf_init_numpy(F, K, T)
    w0 = torch.as_tensor(w0n, device=dev).expand(b, F, K)
    h0 = torch.as_tensor(h0n, device=dev).expand(b, T, K)
    kl_nmf_cuda(v, w0, h0, 1, matmul_dtype=MODE)  # warm-up
    kl_nmf_cuda(v, w0, h0, 1, matmul_dtype=MODE)
    torch.cuda.synchronize()
    stamps = np.zeros((3, MAX_BLOCKS, 4), np.uint64)
    if lib.phase_stamps_get(stamps.ctypes.data) != 0:
        raise RuntimeError("chip_nmf_phases: reading the stamps failed")
    for kid, name in enumerate(KERNELS):
        raw = stamps[kid, :blocks[name]].astype(np.int64)
        st = (raw - raw[:, 0].min()).astype(np.float64) / 1e3  # µs since the first block
        life = st[:, 3] - st[:, 0]
        span = st[:, 3].max() - st[:, 0].min()
        print(json.dumps(dict(
            kernel=name, batch=b, prefetch=not args.no_prefetch, blocks=blocks[name],
            span_us=span, block_life_us=life.mean(), main_loop_us=(st[:, 1] - st[:, 0]).mean(),
            stage_us=(st[:, 2] - st[:, 1]).mean(), epilogue_us=(st[:, 3] - st[:, 2]).mean(),
            blocks_in_flight=life.sum() / span)), flush=True)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    kl_nmf_cuda(v, w0, h0, 100, matmul_dtype=MODE)
    end.record()
    end.synchronize()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(iterations=100, batch=b, prefetch=not args.no_prefetch,
                          ms=start.elapsed_time(end), device=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
