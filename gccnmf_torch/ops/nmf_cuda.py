"""Kernel 1: batched KL-NMF on Hopper (``csrc/nmf.cu``) and its plain twin.

Replaces ``gccnmf_tpu/ops/nmf_pallas.py::kl_nmf_pallas``. The TPU kernel
keeps the whole problem resident in VMEM; on the card V alone (≈2.5 MB of
bf16 per utterance at the reference shape) dwarfs a block's 227 KB of
shared memory, so each iteration is a few launches over the batch, each a
tiled GEMM with its update fused into the epilogue. The products are 1.31
GFLOP per iteration per utterance.

In modes ``"bfloat16"`` and ``"bfloat16_q"`` at K <= 256
(:func:`q_on_chip`) the ratio Q = V/WH never reaches device memory: two
kernels, each a back-to-back product on the tensor cores (``wgmma``, see
``csrc/tc_gemm.cuh``) in the shape of flash attention, recompute H·Wᵀ on a
tile, take the ratio on its registers and feed Q in bf16 from registers to
the product that reads it (Q·W in the H update, Qᵀ·H in the W update's row
splits). An iteration is 7 launches, V is read twice and no Q plane is
allocated; what is left is bound by V's bytes and the products' operations
nearly alike, with the ratio's guarded divides and roundings on the SIMT
cores beside them. V goes to the kernels as rows of 16-byte chunks (one
copy a call where it does not lie so, :func:`_v_rows`). Above K = 256 a
block's output rows no longer fit its registers, and those modes
materialise Q (T, row_pad(F)) in bf16 between 9 launches an iteration.

The turbo mode ``"bfloat16_q_simul"`` (kernel mode 3, the Pallas body's
``shared_q=True``) keeps that materialised route: its one Q per iteration
feeds both products (fusing it into each would compute H·Wᵀ twice). The
Qᵀ·H product reads the pre-update H shadow before the H update overwrites
it, and a gain launch rescales H (and its shadow) by ΣV over the model's
mass after the renormalisation, ΣV taken once per utterance over bf16(V).

In float32 the products stay fp32 FMAs on the SIMT cores, since no
tensor-core path is exact fp32, on the pipelined core of
``csrc/simt_gemm.cuh`` (8 × 8 register micro-tiles, a 3-stage
shared-memory ring), over an fp32 Q whose rows are padded to 16 bytes and
with the Qᵀ·H row splits of :func:`_splits_simt`; that design is bound by
the card's fp32 FMA rate.

In the bf16 modes the wrapper hands the kernel bf16 operand planes with
rows padded by zeros to a multiple of 8 elements (16 bytes), as
:func:`bf16_rows` builds them: the shadows Wb (F, ldk), Hb (T, ldk) of the
fp32 W and H, which the kernel keeps equal to ``round_bf16`` of them, and Q
(T, ldq) where it is materialised. W, H and every sum stay fp32.

``kl_nmf_cuda`` launches the kernel for a CUDA tensor and takes
:func:`kl_nmf_plain` only for a CPU tensor. ``kl_nmf_plain`` computes the
same function with torch ops, rounding at the same points (with an exact
reciprocal in ``"bfloat16_q"`` and ``"bfloat16_q_simul"``).
"""

from __future__ import annotations

import torch

from gccnmf_torch import _build
from gccnmf_torch.ops.nmf import MATMUL_DTYPES, kl_nmf

__all__ = ["kl_nmf_cuda", "kl_nmf_plain", "NMF_MODES", "nmf_mode", "q_on_chip", "bf16_rows",
           "row_pad"]

# matmul_dtype → kernel mode (csrc/nmf.cu)
NMF_MODES = {md: i for i, md in enumerate(MATMUL_DTYPES)}

# the widest K whose (64 rows, K) output the on-chip route's blocks hold in
# registers (csrc/nmf.cu Fused: KT = 128 or 256)
Q_ON_CHIP_MAX_K = 256


def nmf_mode(matmul_dtype: str) -> int:
    """The kernel mode of ``matmul_dtype``; raises for an unknown mode."""
    if matmul_dtype not in NMF_MODES:
        raise ValueError(f"unknown matmul_dtype {matmul_dtype!r}: want {list(NMF_MODES)}")
    return NMF_MODES[matmul_dtype]


def q_on_chip(matmul_dtype: str, k: int) -> bool:
    """Whether kernel 1 keeps Q = V/WH on chip for ``matmul_dtype`` at K
    atoms: modes ``"bfloat16"`` and ``"bfloat16_q"`` at K <= 256 do (the
    ratio recomputed inside both products that read it, 7 launches an
    iteration); above that they materialise Q (9 launches). Turbo
    (``"bfloat16_q_simul"``), whose one Q per iteration feeds both products,
    and ``"float32"`` never do. A function of (mode, K) only, so a batch
    element takes the route it takes alone."""
    return nmf_mode(matmul_dtype) in (1, 2) and k <= Q_ON_CHIP_MAX_K


def kl_nmf_plain(
    v: torch.Tensor,
    w0: torch.Tensor,
    h0: torch.Tensor,
    num_iterations: int,
    sparsity_alpha: float = 0.0,
    epsilon: float = 1e-16,
    matmul_dtype: str = "bfloat16_q",
):
    """Plain torch version of :func:`kl_nmf_cuda`: the guarded
    :func:`~gccnmf_torch.ops.nmf.kl_nmf` with the mode's bf16 rounding
    points. ``v`` may be wider than F (the columns past F are ignored) and
    fp32 or bf16."""
    nmf_mode(matmul_dtype)
    return kl_nmf(v[..., : w0.shape[-2]], w0, h0, num_iterations, sparsity_alpha, epsilon,
                  guard=True, matmul_dtype=matmul_dtype)


def _splits(t: int) -> tuple[int, int]:
    """Row splits of the Qᵀ·H product (a function of T only, so every batch
    size sums in the same order): ≈256 rows each, at most 16."""
    splits = min(16, -(-t // 256))
    rows = -(-t // splits)
    rows = -(-rows // 16) * 16
    return -(-t // rows), rows


def _splits_simt(t: int) -> tuple[int, int]:
    """The float32 mode's row splits of Qᵀ·H (a function of T only), summed
    in order by ``w_update_kernel``: ≈128 rows each up to 32 splits (the
    reference 2,486 rows: 20, twice :func:`_splits`'s count, for blocks
    enough on the SIMT cores), and past that one per ≈4,096 rows (the hour's
    899,986 rows: 220 splits, about 2,000 blocks). Never fewer splits than
    :func:`_splits` gives."""
    splits = max(min(32, -(-t // 128)), -(-t // 4096))
    rows = -(-t // splits)
    rows = -(-rows // 16) * 16
    return -(-t // rows), rows


def row_pad(n: int) -> int:
    """``n`` rounded up to a multiple of 8: a bf16 row of 16-byte chunks."""
    return -(-n // 8) * 8


def bf16_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., R, C) in bf16 with rows of :func:`row_pad` ``(C)``
    elements, the padding zero: the layout of the kernel's operand
    planes."""
    out = torch.zeros((*x.shape[:-1], row_pad(x.shape[-1])), device=x.device,
                      dtype=torch.bfloat16)
    out[..., : x.shape[-1]] = x
    return out


def kl_nmf_cuda(
    v: torch.Tensor,
    w0: torch.Tensor,
    h0: torch.Tensor,
    num_iterations: int,
    sparsity_alpha: float = 0.0,
    epsilon: float = 1e-16,
    matmul_dtype: str = "bfloat16_q",
):
    """``num_iterations`` KL-NMF updates. ``v``: (..., T, Fv) fp32 or bf16,
    ``Fv >= F`` (columns past F are ignored); ``w0``: (..., F, K);
    ``h0``: (..., T, K), broadcast over ``v``'s batch dims. Returns fp32
    ``(W, H)`` with the batch dims of ``v``. Launches the CUDA kernel for a
    CUDA ``v``; a CPU ``v`` takes :func:`kl_nmf_plain`. ``kl_nmf_cuda.launches``
    counts its calls, not the device kernels each one launches;
    ``kl_nmf_cuda.q_on_chip`` the calls that took the route of
    :func:`q_on_chip`."""
    mode = nmf_mode(matmul_dtype)
    if v.device.type == "cpu":
        return kl_nmf_plain(v, w0, h0, num_iterations, sparsity_alpha, epsilon, matmul_dtype)
    dev = _build.require_cuda("kl_nmf_cuda", v, w0, h0)
    if v.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kl_nmf_cuda: V must be float32 or bfloat16, got {v.dtype}")
    *batch, t, fv = v.shape
    f, k = w0.shape[-2:]
    if fv < f:
        raise ValueError("kl_nmf_cuda: V has fewer frequency bins than W")
    if h0.shape[-2:] != (t, k):
        raise ValueError(f"kl_nmf_cuda: H0 must be (..., {t}, {k}), got {tuple(h0.shape)}")
    v3 = v.reshape(-1, t, fv).contiguous()
    b = v3.shape[0]
    w = torch.empty((*batch, f, k), device=dev, dtype=torch.float32)
    h = torch.empty((*batch, t, k), device=dev, dtype=torch.float32)
    w.copy_(w0.expand(*batch, f, k))
    h.copy_(h0.expand(*batch, t, k))
    splits, split_rows = _splits_simt(t) if mode == 0 else _splits(t)
    on_chip = q_on_chip(matmul_dtype, k)
    if mode == 0:  # SIMT products on fp32 Q, rows of 16 bytes (the kernel zeroes the pad)
        wb = hb = None
        q = torch.empty((b, t, -(-f // 4) * 4), device=dev, dtype=torch.float32)
    else:  # tensor-core products on bf16 planes of 16-byte rows
        wb, hb = bf16_rows(w), bf16_rows(h)
        q = None if on_chip else torch.zeros((b, t, row_pad(f)), device=dev,
                                             dtype=torch.bfloat16)
    if on_chip:
        v3, fv = _v_rows(v3, f, mode)
    # Qᵀ·H's (B, splits, F, K) partial sums; mode 0 also keeps H's (B,
    # ceil(T/64), K) column sums there, per 64-row tile of its H update
    part = torch.empty(b * max(splits * f * k, -(-t // 64) * k), device=dev,
                       dtype=torch.float32)
    stats = torch.empty((3, b, k), device=dev, dtype=torch.float32)
    v_sum = torch.empty(b, device=dev, dtype=torch.float32)  # ΣV, read in mode 3
    _build.launch(
        "gccnmf_kl_nmf", dev,
        v3.data_ptr(), int(v3.dtype == torch.bfloat16), fv, w.data_ptr(), h.data_ptr(),
        0 if wb is None else wb.data_ptr(), 0 if hb is None else hb.data_ptr(), row_pad(k),
        0 if q is None else q.data_ptr(), 0 if q is None else q.shape[-1], part.data_ptr(),
        stats[0].data_ptr(), stats[1].data_ptr(), stats[2].data_ptr(), v_sum.data_ptr(), b, t,
        f, k, int(num_iterations), splits, split_rows, float(sparsity_alpha), float(epsilon),
        mode,
    )
    kl_nmf_cuda.launches += 1
    kl_nmf_cuda.q_on_chip += int(on_chip)
    return w, h


def _v_rows(v3: torch.Tensor, f: int, mode: int) -> tuple[torch.Tensor, int]:
    """V as the on-chip route's tile copies take it, with its row length:
    rows of whole 16-byte chunks from a 16-byte aligned start, in bf16 in
    ``"bfloat16_q"`` (whose ratio rounds V to bf16 first, so the cast
    changes nothing). ``v3`` as it is where it already lies so; else one
    copy of its first F columns. The padding past F is left unwritten: it
    meets no row of W, so H·Wᵀ there is an exact zero and the ratio's
    guard gives 0 whatever it holds."""
    dt = torch.bfloat16 if mode == 2 else v3.dtype
    per_chunk = 128 // torch.finfo(dt).bits  # elements a 16-byte chunk
    fv = v3.shape[-1]
    if v3.dtype == dt and fv % per_chunk == 0 and v3.data_ptr() % 16 == 0:
        return v3, fv
    out = torch.empty((*v3.shape[:-1], -(-f // per_chunk) * per_chunk), device=v3.device,
                      dtype=dt)
    out[..., :f].copy_(v3[..., :f])
    return out, out.shape[-1]


kl_nmf_cuda.launches = 0
kl_nmf_cuda.q_on_chip = 0  # calls that kept Q on chip (q_on_chip)
