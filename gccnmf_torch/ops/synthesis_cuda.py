"""Kernel 2: the fused masked synthesis on Hopper (``csrc/synthesis.cu``)
and its plain twin.

Replaces ``gccnmf_tpu/ops/synthesis_pallas.py::masked_synthesis_pallas``:
per target s and channel c, magnitudes ``(H_c ⊙ [winner == s])·Wᵀ`` with the
mixture phase re-applied, a windowed and gained inverse DFT, overlap-add
and a window/2 center trim. The TPU kernel carries the overlap-add tail
between time tiles on its sequential grid; on Hopper blocks run in any
order, so the overlap-add is a separate gather (each output sample sums
the frames that cover it) and nothing carries between blocks. The products
bound it (≈16.7 GFLOP per utterance at the reference shape, 3 targets),
nearly all in the iDFT. In the bf16 mode the iDFT runs on the tensor cores
(``wgmma``, ``csrc/istft.cuh`` ``tc_frames_kernel``) as one 2F-deep product
over the spectrum rows ``[Re X | Im X | 0]`` of every utterance, target and
channel (laid out as :func:`idft_rows` lays them out) against the basis rows
``[A ; −B]`` (:func:`synthesis_basis`'s ``rows``), both bf16 on zero-padded
16-byte rows. In float32 the iDFT is a hand-written FFT
(``csrc/istft.cuh`` ``fft_frames_kernel``): exact fp32 rules out the tensor
cores, and as a GEMM the iDFT is some 80 times the operations of an FFT
(2·N·2F against 2.5·N·log2 N a frame), so the kernel runs the FFT of
:func:`fft_plan` with the twiddles of :func:`fft_twiddles`, one block a few
frames in shared memory; the least it must do is read X once and write the
frames once.

The result equals ``istft(masked_reconstruction(...), conjugate=True,
center_trim=True) * gain``: (B, N, C, (T-1)·hop) fp32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gccnmf_torch import _build
from gccnmf_torch.ops.nmf_cuda import row_pad
from gccnmf_torch.ops.stft import idft_matrices, overlap_add
from gccnmf_torch.precision import bf16_operands, round_bf16

__all__ = [
    "FFT_MAX_SMEM",
    "FFT_SMEM_TARGET",
    "SynthesisBasis",
    "fft_plan",
    "fft_row_len",
    "fft_twiddles",
    "synthesis_basis",
    "idft_rows",
    "idft_frames_plain",
    "istft_plain",
    "masked_spectra_plain",
    "masked_synthesis_cuda",
    "masked_synthesis_plain",
]


# Shared memory a block may use on Hopper (227 KB): the float32 FFT holds
# two rows of fft_row_len(win) complex fp32 values a frame, so one frame
# must fit (win up to 29,052 samples when even, 14,525 when odd).
FFT_MAX_SMEM = 232448
# Shared memory a float32 FFT block aims at (csrc/fft.cuh FFT_SMEM_TARGET):
# the transforms it holds at once, at most 16
FFT_SMEM_TARGET = 40960


class SynthesisBasis(NamedTuple):
    """The iDFT constants of :func:`synthesis_basis`: ``a``, ``b_neg`` (F,
    win) fp32 (the plain versions' GEMM basis), in the bf16 mode ``rows``,
    the same values in bf16 in the tensor-core layout (None in float32),
    then the float32 FFT's ``scale`` (win,) = window·gain, ``twiddle``
    (win, 2) of :func:`fft_twiddles` and ``plan``, the int32 radices of
    :func:`fft_plan`."""

    a: torch.Tensor
    b_neg: torch.Tensor
    rows: torch.Tensor | None
    scale: torch.Tensor
    twiddle: torch.Tensor
    plan: torch.Tensor


def fft_plan(win: int) -> list[int]:
    """The radices of the float32 iDFT's complex FFT of length L (win/2 for
    an even window, whose real output packs two samples in each complex
    one; win for an odd window), one Stockham pass each, in order: radix
    4 while 4 divides, a 2 for what is left of the powers of two, then 3s,
    5s, and every other prime factor as a generic radix (a direct p-point
    DFT in one pass). Their product is L."""
    left = win // 2 if win % 2 == 0 else win
    plan = []
    for p in (4, 2, 3, 5):
        while left % p == 0:
            plan.append(p)
            left //= p
    p = 7
    while left > 1:
        while left % p == 0:
            plan.append(p)
            left //= p
        p += 2
    return plan


def fft_twiddles(win: int) -> np.ndarray:
    """(win, 2) fp32: ``e^{+2πi m/win}`` (cos, sin) for m < win, computed in
    float64 and rounded once. Every twiddle of the float32 FFT is one of
    them: a power of the L-th root is the entry at win/L times its
    exponent, and the even window's pre-twiddle takes the win-th roots."""
    ang = 2.0 * np.pi * np.arange(win, dtype=np.float64) / win
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


def fft_row_len(win: int) -> int:
    """Complex values a frame's row of the FFT's shared-memory buffers
    holds: at least L + 1 (the F bins of X are staged there first), the
    odd of L + 1 and L + 2 so that the rows of a block's frames start in
    different banks."""
    length = win // 2 if win % 2 == 0 else win
    return (length + 1) | 1


def synthesis_basis(window, gain: float, matmul_dtype: str = "bfloat16",
                    device=None) -> SynthesisBasis:
    """The iDFT basis with synthesis window and gain folded in, ``A`` and
    ``−B``, each ``(F, win)`` fp32. The minus undoes the conjugated forward
    transform: frames = Re X·A − Im X·B. With ``matmul_dtype="bfloat16"``
    also ``rows``: (win, :func:`row_pad` ``(2F)``) bf16, row j =
    ``[A[:, j] | −B[:, j] | 0]``, the K-major operand of the tensor-core
    iDFT (the layout of the soft mask's fold), stored once, so that
    ``idft_rows(xr, xi) @ rows.T`` are the frames. Then the constants of
    the float32 FFT, built once on the host: ``scale`` = window·gain,
    ``twiddle`` (:func:`fft_twiddles`) and ``plan`` (:func:`fft_plan`), so
    that frames = scale ⊙ irfft(conj X, n=win)."""
    window = np.asarray(window, np.float32)
    win = window.shape[0]
    a_m, b_m = idft_matrices(win)
    a = torch.as_tensor(a_m * window[None, :] * gain, device=device)
    b_neg = torch.as_tensor(-(b_m * window[None, :] * gain), device=device)
    rows = None
    if bf16_operands(matmul_dtype):
        rows = idft_rows(a.T, b_neg.T)
    scale = torch.as_tensor(window * np.float32(gain), device=device)
    twiddle = torch.as_tensor(fft_twiddles(win), device=device)
    plan = torch.as_tensor(np.asarray(fft_plan(win), np.int32), device=device)
    return SynthesisBasis(a, b_neg, rows, scale, twiddle, plan)


def idft_rows(xr, xi, f=None, dtype=torch.bfloat16):
    """Planes (..., R, >= F) as rows ``[xr[:F] | xi[:F] | 0]`` of
    :func:`row_pad` ``(2F)`` elements in ``dtype``, the leading dimensions
    flattened into rows (F defaults to the planes' width): the layout in
    which the spectra kernels write X for the tensor-core iDFT (their plain
    twin), of the basis rows, and of the coherence rows that the soft
    mask's kernel packs (the plain twin of ``coherence_rows_kernel``)."""
    f = xr.shape[-1] if f is None else f
    rows = torch.zeros((xr[..., 0].numel(), row_pad(2 * f)), device=xr.device, dtype=dtype)
    rows[:, :f] = xr[..., :f].reshape(-1, f)
    rows[:, f : 2 * f] = xi[..., :f].reshape(-1, f)
    return rows


def idft_frames_plain(xr, xi, basis, matmul_dtype="bfloat16"):
    """Frames ``Re X·A − Im X·B`` (..., T, win) of spectra (..., T, F) at
    JAX's ``make_mm`` rounding points: in bf16 the spectra, the basis and
    the frames are rounded, the sums fp32."""
    r = round_bf16 if bf16_operands(matmul_dtype) else (lambda x: x)
    a, b_neg = basis[:2]
    return r(r(xr) @ r(a) + r(xi) @ r(b_neg))


def istft_plain(xr, xi, basis, hop_size, matmul_dtype):
    """The tail both syntheses share, from spectra (..., T, F): the frames
    of :func:`idft_frames_plain`, overlap-add, window/2 center trim."""
    win = basis[0].shape[1]
    y = overlap_add(idft_frames_plain(xr, xi, basis, matmul_dtype), hop_size)
    t = xr.shape[-2]
    return y[..., win // 2 : win // 2 + (t - 1) * hop_size]


def masked_spectra_plain(spec_re, spec_im, winner, w, h_stereo, *, num_targets,
                         matmul_dtype="bfloat16"):
    """X = ``((H_c ⊙ [winner == s])·Wᵀ)·phase``, ``(Re X, Im X)`` each
    (B, S, C, T, F) fp32: the spectra that the iDFT of
    :func:`masked_synthesis_plain` reads (bf16 operands in the bf16 mode)."""
    r = round_bf16 if bf16_operands(matmul_dtype) else (lambda x: x)
    f = w.shape[-2]
    re = spec_re[..., :f].to(torch.float32)  # (B, C, T, F)
    im = spec_im[..., :f].to(torch.float32)
    mag2 = re * re + im * im
    ok = mag2 > 0.0
    inv = torch.where(ok, torch.rsqrt(torch.where(ok, mag2, 1.0)), 0.0)
    pr = torch.where(ok, re * inv, 1.0)
    pi = im * inv
    targets = torch.arange(num_targets, device=winner.device)
    mask = (winner[:, None] == targets[None, :, None, None]).to(torch.float32)  # (B,S,T,K)
    hm = h_stereo.to(torch.float32)[:, None] * mask[:, :, None]  # (B, S, C, T, K)
    mag = r(hm) @ r(w.to(torch.float32)).transpose(-1, -2)[:, None, None]  # (B,S,C,T,F)
    return mag * pr[:, None], mag * pi[:, None]


def masked_synthesis_plain(spec_re, spec_im, winner, w, h_stereo, basis, *,
                           num_targets, hop_size, matmul_dtype="bfloat16"):
    """Plain torch version of :func:`masked_synthesis_cuda`."""
    xr, xi = masked_spectra_plain(spec_re, spec_im, winner, w, h_stereo,
                                  num_targets=num_targets, matmul_dtype=matmul_dtype)
    return istft_plain(xr, xi, basis, hop_size, matmul_dtype)


def check_idft_basis(name, basis, rnd, f, win, dev):
    """The operands of a CUDA call's iDFT from its basis (a
    :class:`SynthesisBasis` or the same fields as a tuple), validated:
    ``((scale, twiddle, plan), None)`` for the float32 FFT, ``(None,
    rows)`` for the bf16 tensor-core iDFT. A call whose basis lacks its
    mode's constants raises, as nothing falls back to another iDFT."""
    a, b_neg = basis[:2]
    if a.shape != (f, win) or b_neg.shape != (f, win):
        raise ValueError(f"{name}: the iDFT basis must be (F, win)")
    if f != win // 2 + 1:
        raise ValueError(f"{name}: the iDFT basis must have win // 2 + 1 bins")
    if not rnd:
        scale, twiddle, plan = basis[3:6] if len(basis) >= 6 else (None,) * 3
        if (scale is None or scale.shape != (win,) or twiddle.shape != (win, 2)
                or plan.dtype != torch.int32 or plan.dim() != 1):
            raise ValueError(f"{name}: matmul_dtype float32 needs the FFT's scale, twiddle "
                             "and plan of synthesis_basis")
        if 16 * fft_row_len(win) > FFT_MAX_SMEM:
            raise ValueError(f"{name}: window {win} is too long for the float32 FFT, which "
                             "holds a frame in one block's shared memory")
        if any(v.device != dev for v in (scale, twiddle, plan)):
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        fft = (scale.to(torch.float32).contiguous(), twiddle.to(torch.float32).contiguous(),
               plan.contiguous())
        return fft, None
    rows = basis[2] if len(basis) > 2 else None
    if rows is None or rows.shape != (win, row_pad(2 * f)) or rows.dtype != torch.bfloat16:
        raise ValueError(f"{name}: matmul_dtype bfloat16 needs the (win, row_pad(2F)) bf16 "
                         "rows of synthesis_basis(..., 'bfloat16')")
    if rows.device != dev:
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    return None, rows.contiguous()


def idft_args(fft, rows):
    """The iDFT's pointer arguments of a launch from
    :func:`check_idft_basis`'s result: the FFT's scale, twiddles, radices
    and pass count, then the bf16 basis rows (0 where the mode has none)."""
    ptr = lambda v: 0 if v is None else v.data_ptr()  # noqa: E731
    scale, twiddle, plan = fft if fft is not None else (None, None, None)
    return (ptr(scale), ptr(twiddle), ptr(plan), 0 if plan is None else plan.numel(),
            ptr(rows))


def masked_synthesis_cuda(spec_re, spec_im, winner, w, h_stereo, basis, *,
                          num_targets, hop_size, matmul_dtype="bfloat16"):
    """Fused masked reconstruction + ISTFT (conjugate + center-trim).

    ``spec_re``/``spec_im``: (B, C, T, Fp) fp32 or bf16 mixture planes,
    ``Fp >= F``; ``winner``: (B, T, K) int32 winning-target index;
    ``w``: (B, F, K); ``h_stereo``: (B, C, T, K); ``basis``: from
    :func:`synthesis_basis` in the same ``matmul_dtype``.
    ``matmul_dtype="bfloat16"`` rounds where JAX's ``make_mm`` does: the mag
    operands, the iDFT operands and the frames entering the overlap-add, and
    runs the iDFT on the tensor cores. Launches the CUDA kernel for CUDA
    planes; CPU planes take :func:`masked_synthesis_plain`.
    ``masked_synthesis_cuda.launches`` counts its calls, not the device
    kernels each one launches."""
    rnd = bf16_operands(matmul_dtype)
    if spec_re.device.type == "cpu":
        return masked_synthesis_plain(spec_re, spec_im, winner, w, h_stereo, basis,
                                      num_targets=num_targets, hop_size=hop_size,
                                      matmul_dtype=matmul_dtype)
    dev = _build.require_cuda("masked_synthesis_cuda", spec_re, spec_im, winner, w, h_stereo,
                              *basis[:2])
    b, c, t, fp = spec_re.shape
    f, win = basis[0].shape
    k = w.shape[-1]
    if win % hop_size:
        raise ValueError("masked_synthesis_cuda: window length must be a multiple of hop_size")
    if spec_im.shape != spec_re.shape or spec_im.dtype != spec_re.dtype:
        raise ValueError("masked_synthesis_cuda: spec planes disagree")
    if spec_re.dtype not in (torch.float32, torch.bfloat16) or fp < f:
        raise ValueError("masked_synthesis_cuda: planes must be fp32/bf16 with >= F bins")
    if w.shape != (b, f, k) or h_stereo.shape != (b, c, t, k) or winner.shape != (b, t, k):
        raise ValueError("masked_synthesis_cuda: W, H or winner shape disagrees")
    if winner.dtype != torch.int32:
        raise ValueError("masked_synthesis_cuda: winner must be int32")
    fft, rows = check_idft_basis("masked_synthesis_cuda", basis, rnd, f, win, dev)
    sre, sim = spec_re.contiguous(), spec_im.contiguous()
    win_idx = winner.contiguous()
    w32 = w.to(torch.float32).contiguous()
    h32 = h_stereo.to(torch.float32).contiguous()
    z = b * num_targets * c
    ldj = row_pad(2 * f)
    # X scratch: bf16 spectrum rows for the tensor cores, or two fp32 planes
    x = (torch.empty((z * t, ldj), device=dev, dtype=torch.bfloat16) if rnd
         else torch.empty((2, z, t, f), device=dev, dtype=torch.float32))
    frames = torch.empty((z, t, win), device=dev, dtype=x.dtype)
    out = torch.empty((b, num_targets, c, (t - 1) * hop_size), device=dev,
                      dtype=torch.float32)
    _build.launch(
        "gccnmf_masked_synthesis", dev,
        sre.data_ptr(), sim.data_ptr(), int(sre.dtype == torch.bfloat16), fp,
        win_idx.data_ptr(), w32.data_ptr(), h32.data_ptr(), *idft_args(fft, rows), ldj,
        x.data_ptr(), frames.data_ptr(), out.data_ptr(),
        b, num_targets, c, t, f, k, win, hop_size, int(rnd),
    )
    masked_synthesis_cuda.launches += 1
    return out


masked_synthesis_cuda.launches = 0
