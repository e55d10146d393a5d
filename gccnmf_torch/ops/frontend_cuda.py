"""Kernel 3: the fused analysis front-end on Hopper (``csrc/frontend.cu``)
and its plain twin.

Replaces ``gccnmf_tpu/ops/frontend_pallas.py::stft_gcc_frontend_pallas``:
one pass over raw stereo producing the conjugated spectrogram planes, the
magnitudes |X| (the NMF's V), the PHAT coherence planes and the angular
spectrogram. Any hop works (the TPU kernel needs hop | window). In bf16
the products bound it (≈5.6 GFLOP per utterance at the reference shape);
in float32 the bytes of the planes do.

In the bf16 mode the products run on the tensor cores (``wgmma``,
``csrc/tc_gemm.cuh``). The rDFT is one product of the frames, read from a
bf16 copy of the signal with a row stride of hop (or, for a hop or window
that is not a multiple of 8, from frame rows written once), against the
basis rows of :func:`dft_rows`: bins in groups of 64, each the cos rows then
the sin rows, so one output tile holds Re and Im of the same bins. Its
epilogue writes the planes and the coherence as rows ``[Re c | Im c | 0]``
(the layout of :func:`synthesis_cuda.idft_rows`); the angular spectrogram is
one product of those rows against the steering fold
``[cos_mᵀ | sin_mᵀ | 0]``. :func:`frontend_basis` stores both bf16 operands
once. In float32, where no tensor-core path is exact, the rDFT is a
hand-written FFT (``csrc/frontend.cu`` ``fft_coherence_kernel`` on the
Stockham passes of ``csrc/fft.cuh``, which the syntheses' float32 iDFT
runs too): a block transforms a few frames of both channels in shared
memory from :func:`frontend_basis`'s window, twiddle table and radix plan
(:func:`synthesis_cuda.fft_plan`, :func:`synthesis_cuda.fft_twiddles`) and
writes the planes and the coherence from the same block; the angular
spectrogram stays an fp32 product on the SIMT cores. Any window up to
29,052 samples (even) or 14,525 (odd) runs; a longer one raises.

Planes are exactly F wide (the port pads nothing); the TPU kernel's
contract is equality on ``[..., :F]``. The angular spectrogram is computed
from the coherence as stored, which is what the TPU kernel's bf16 GEMM
operands see in the throughput mode and exact in float32 mode.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gccnmf_torch import _build
from gccnmf_torch.ops.nmf_cuda import row_pad
from gccnmf_torch.ops.stft import dft_matrices, frame_signal, num_frames
from gccnmf_torch.ops.synthesis_cuda import (
    FFT_MAX_SMEM, FFT_SMEM_TARGET, fft_plan, fft_row_len, fft_twiddles, idft_rows,
)
from gccnmf_torch.precision import bf16_operands, round_bf16

__all__ = [
    "FrontendBasis",
    "frontend_basis",
    "dft_rows",
    "reads_signal",
    "check_frontend_basis",
    "fft_channels_apart",
    "stft_gcc_frontend_cuda",
    "stft_gcc_frontend_plain",
    "BIN_GROUP",
    "PLANE_DTYPES",
]

PLANE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BIN_GROUP = 64  # bins a tensor-core output tile: their cos rows, then their sin rows


class FrontendBasis(NamedTuple):
    """The front-end's constants (:func:`frontend_basis`): ``wcos``, ``wsin``
    (win, F) fp32 (the plain version's GEMM basis), in the bf16 mode
    ``rows``, the rDFT basis in the tensor-core layout of :func:`dft_rows`,
    and ``steer``, the (D, row_pad(2F)) bf16 steering fold (both None in
    float32), then the float32 FFT's ``window`` (win,) fp32, ``twiddle``
    (win, 2) of :func:`synthesis_cuda.fft_twiddles`, ``plan``, the int32
    radices of :func:`synthesis_cuda.fft_plan`, and ``conjugate``, the
    spectrum's sign, built in every mode."""

    wcos: torch.Tensor
    wsin: torch.Tensor
    rows: torch.Tensor | None
    steer: torch.Tensor | None
    window: torch.Tensor
    twiddle: torch.Tensor
    plan: torch.Tensor
    conjugate: bool


def frontend_basis(window, conjugate: bool = True, device=None, matmul_dtype: str = "float32",
                   steering=None) -> FrontendBasis:
    """The windowed rDFT basis ``(window·cos, ±window·sin)``, each
    ``(win, F)`` fp32, with the conjugation sign folded into the sin half
    (rfft's imaginary part is ``-frames@sin``; conjugating flips it). With
    ``matmul_dtype="bfloat16"`` also the tensor-core operands, stored once:
    ``rows`` (:func:`dft_rows`) and ``steer``, the rows
    ``[cos_m[:, d] | sin_m[:, d] | 0]`` of the ``steering=(cos_m, sin_m)``
    (F, D) planes in bf16, which that mode needs. In every mode the
    constants of the float32 FFT, built once on the host: the window, the
    twiddle table and the radix plan of the win-point real transform."""
    window = np.asarray(window, np.float32)
    win = window.shape[0]
    dcos, dsin = dft_matrices(win)
    sign = 1.0 if conjugate else -1.0
    wcos = torch.as_tensor(window[:, None] * dcos, device=device)
    wsin = torch.as_tensor((sign * window)[:, None] * dsin, device=device)
    fft = (torch.as_tensor(window, device=device),
           torch.as_tensor(fft_twiddles(win), device=device),
           torch.as_tensor(np.asarray(fft_plan(win), np.int32), device=device), bool(conjugate))
    if not bf16_operands(matmul_dtype):
        return FrontendBasis(wcos, wsin, None, None, *fft)
    if steering is None:
        raise ValueError("frontend_basis: matmul_dtype bfloat16 needs steering=(cos_m, sin_m) "
                         "for the angular product's fold")
    cos_m, sin_m = (torch.as_tensor(m, dtype=torch.float32, device=wcos.device)
                    for m in steering)
    return FrontendBasis(wcos, wsin, dft_rows(wcos, wsin), idft_rows(cos_m.T, sin_m.T), *fft)


def dft_rows(wcos, wsin, dtype=torch.bfloat16):
    """The (win, F) basis halves as the tensor-core kernel's K-major B
    operand: (Nb, :func:`row_pad` ``(win)``) in ``dtype`` with Nb = 128 ·
    ceil(F / 64), group g of 128 rows = ``[wcos[:, 64g : 64g + 64]ᵀ ;
    wsin[:, 64g : 64g + 64]ᵀ]``, zero rows past F and zero columns past win,
    so that output column 128g + c of ``frames @ rows.T`` is Re X of bin
    64g + c (c < 64) or Im X of bin 64g + c − 64."""
    win, f = wcos.shape
    groups = -(-f // BIN_GROUP)
    out = torch.zeros((groups, 2, BIN_GROUP, row_pad(win)), device=wcos.device, dtype=dtype)
    for half, m in enumerate((wcos, wsin)):
        cols = torch.zeros((win, groups * BIN_GROUP), device=m.device, dtype=torch.float32)
        cols[:, :f] = m
        out[:, half, :, :win] = cols.T.reshape(groups, BIN_GROUP, win)
    return out.reshape(-1, row_pad(win))


def reads_signal(hop_size: int, win: int) -> bool:
    """Whether the bf16 kernel reads its frames straight from the bf16 copy
    of the signal (every frame and 64-deep slice starts on 16 bytes), else
    from frame rows staged once."""
    return hop_size % 8 == 0 and win % 8 == 0


def fft_channels_apart(win: int) -> bool:
    """Whether the float32 kernel transforms a frame's two channels one
    after the other (one frame a block, channel 0's bins held in an fp32
    scratch row): a block's shared-memory target holds fewer than two
    transforms' pairs of rows (even windows from 2,558 samples, odd from
    1,279)."""
    return 2 * 2 * 8 * fft_row_len(win) > FFT_SMEM_TARGET


def check_frontend_basis(basis, rnd: bool, win: int, f: int, d: int, dev):
    """The operands of a CUDA call from its basis, validated: ``(fft,
    None)`` in float32, ``fft = (window, twiddle, plan, conjugate)`` for the
    FFT, or ``(None, (rows, steer))`` in bf16, the tensor-core operands,
    contiguous. A call whose basis lacks its mode's constants (a bf16 call
    without :func:`frontend_basis`'s bf16 ``rows`` and ``steer`` for these
    shapes, a float32 call without the FFT's) raises, as nothing falls back
    to another DFT; so does a float32 window too long for one transform in
    a block's shared memory."""
    if not rnd:
        window, twiddle, plan, conjugate = basis[4:8] if len(basis) >= 8 else (None,) * 4
        if (window is None or window.shape != (win,) or twiddle.shape != (win, 2)
                or plan.dtype != torch.int32 or plan.dim() != 1 or conjugate is None):
            raise ValueError("stft_gcc_frontend_cuda: matmul_dtype float32 needs the FFT's "
                             "window, twiddle and plan of frontend_basis")
        if 16 * fft_row_len(win) > FFT_MAX_SMEM:
            raise ValueError(f"stft_gcc_frontend_cuda: window {win} is too long for the float32 "
                             "FFT, which holds a transform in one block's shared memory")
        if any(m.device != dev for m in (window, twiddle, plan)):
            raise ValueError("stft_gcc_frontend_cuda: all tensors must be on one CUDA device")
        return (window.to(torch.float32).contiguous(), twiddle.to(torch.float32).contiguous(),
                plan.contiguous(), bool(conjugate)), None
    rows, steer = (basis[2], basis[3]) if len(basis) >= 4 else (None, None)
    want = ((2 * BIN_GROUP * -(-f // BIN_GROUP), row_pad(win)), (d, row_pad(2 * f)))
    for m, shape in zip((rows, steer), want):
        if m is None or m.shape != shape or m.dtype != torch.bfloat16:
            raise ValueError("stft_gcc_frontend_cuda: matmul_dtype bfloat16 needs the bf16 rows "
                             "and steering fold of frontend_basis(..., 'bfloat16', "
                             "(cos_m, sin_m)) for these shapes")
        if m.device != dev:
            raise ValueError("stft_gcc_frontend_cuda: all tensors must be on one CUDA device")
    return None, (rows.contiguous(), steer.contiguous())


def _check_dtypes(matmul_dtype: str, plane_dtype: str):
    rnd = bf16_operands(matmul_dtype)
    if plane_dtype not in PLANE_DTYPES:
        raise ValueError(f"plane_dtype must be float32 or bfloat16, got {plane_dtype!r}")
    return rnd, PLANE_DTYPES[plane_dtype]


def stft_gcc_frontend_plain(stereo, basis, cos_m, sin_m, *, hop_size,
                            matmul_dtype="bfloat16", plane_dtype="float32"):
    """Plain torch version of :func:`stft_gcc_frontend_cuda`."""
    rnd, pd = _check_dtypes(matmul_dtype, plane_dtype)
    r = round_bf16 if rnd else (lambda x: x)
    wcos, wsin = basis[:2]
    frames = r(frame_signal(stereo.to(torch.float32), wcos.shape[0], hop_size))
    re = frames @ r(wcos)  # (..., 2, T, F)
    im = frames @ r(wsin)
    mag = torch.sqrt(re * re + im * im)
    den = mag[..., 0, :, :] * mag[..., 1, :, :]
    ok = den > 1e-30
    inv = torch.where(ok, 1.0 / torch.where(ok, den, 1.0), 0.0)
    re0, re1 = re[..., 0, :, :], re[..., 1, :, :]
    im0, im1 = im[..., 0, :, :], im[..., 1, :, :]
    cre = ((re0 * re1 + im0 * im1) * inv).to(pd)
    cim = ((im0 * re1 - re0 * im1) * inv).to(pd)
    ang = r(cre.to(torch.float32)) @ r(cos_m) + r(cim.to(torch.float32)) @ r(sin_m)
    return re.to(pd), im.to(pd), mag.to(pd), cre, cim, ang


def stft_gcc_frontend_cuda(stereo, basis, cos_m, sin_m, *, hop_size,
                           matmul_dtype="bfloat16", plane_dtype="float32"):
    """Fused front-end. ``stereo``: (..., 2, n) fp32; ``basis``: from
    :func:`frontend_basis`, built for ``matmul_dtype`` with these steering
    planes in the bf16 mode; ``cos_m``/``sin_m``: (F, D) fp32 steering
    planes.

    Returns ``(spec_re, spec_im, v, coh_re, coh_im, ang)``: spec planes and
    magnitudes (..., 2, T, F), coherence planes (..., T, F), all in
    ``plane_dtype``, and the angular spectrogram (..., T, D) fp32.
    ``matmul_dtype="bfloat16"`` rounds every GEMM operand to bf16 (fp32
    accumulation) and runs the products on the tensor cores, from the
    basis's ``rows`` and ``steer`` (the kernel reads no fp32 operand then);
    ``"float32"`` runs the rDFT as the FFT of the basis's ``window``,
    ``twiddle`` and ``plan``.
    Launches the CUDA kernels for a CUDA ``stereo``; a CPU ``stereo`` takes
    :func:`stft_gcc_frontend_plain`. ``stft_gcc_frontend_cuda.launches``
    counts its calls, not the device kernels each one launches."""
    rnd, pd = _check_dtypes(matmul_dtype, plane_dtype)
    if stereo.device.type == "cpu":
        return stft_gcc_frontend_plain(stereo, basis, cos_m, sin_m, hop_size=hop_size,
                                       matmul_dtype=matmul_dtype, plane_dtype=plane_dtype)
    wcos, wsin = basis[:2]
    dev = _build.require_cuda("stft_gcc_frontend_cuda", stereo, wcos, wsin, cos_m, sin_m)
    *batch, c, n = stereo.shape
    win, f = wcos.shape
    d = cos_m.shape[-1]
    if c != 2:
        raise ValueError("stft_gcc_frontend_cuda: expects stereo (..., 2, n)")
    if n < win:
        raise ValueError(f"stft_gcc_frontend_cuda: signal shorter than the {win}-sample window")
    if wsin.shape != (win, f) or cos_m.shape != (f, d) or sin_m.shape != (f, d):
        raise ValueError("stft_gcc_frontend_cuda: basis/steering shapes disagree")
    fft, tc_ops = check_frontend_basis(basis, rnd, win, f, d, dev)
    if not rnd:
        for name, m in (("cos_m", cos_m), ("sin_m", sin_m)):
            if m.dtype != torch.float32 or not m.is_contiguous():
                raise ValueError(f"stft_gcc_frontend_cuda: {name} must be contiguous float32")
    t = num_frames(n, win, hop_size)
    x = stereo.reshape(-1, 2, n).to(torch.float32).contiguous()
    b = x.shape[0]
    planes = torch.empty((3, b, 2, t, f), device=dev, dtype=pd)
    coh = torch.empty((2, b, t, f), device=dev, dtype=pd)
    ang = torch.empty((b, t, d), device=dev, dtype=torch.float32)
    if rnd:  # the bf16 operands, and scratch: signal (or frame) rows, coherence rows
        rows, steer = tc_ops
        frame_rows, ldx = not reads_signal(hop_size, win), row_pad(n)
        stage = torch.empty((b * 2 * t, rows.shape[1]) if frame_rows else (b * 2, ldx),
                            device=dev, dtype=torch.bfloat16)
        crows = torch.empty((b * t, steer.shape[1]), device=dev, dtype=torch.bfloat16)
        fp32 = (0,) * 8
        tc = (rows.data_ptr(), *rows.shape, steer.data_ptr(), steer.shape[1], stage.data_ptr(),
              ldx, int(frame_rows), crows.data_ptr())
    else:  # the FFT's constants, channel 0's bins for a long window, the steering planes
        window, twiddle, plan, conjugate = fft
        y0 = (torch.empty((b * t, f, 2), device=dev, dtype=torch.float32)
              if fft_channels_apart(win) else None)
        fp32 = (window.data_ptr(), twiddle.data_ptr(), plan.data_ptr(), plan.numel(),
                int(conjugate), 0 if y0 is None else y0.data_ptr(), cos_m.data_ptr(),
                sin_m.data_ptr())
        tc = (0,) * 9
    _build.launch(
        "gccnmf_frontend", dev, x.data_ptr(), b, n, hop_size, win, *fp32, *tc,
        t, f, d, int(rnd), int(pd == torch.bfloat16),
        planes[0].data_ptr(), planes[1].data_ptr(), planes[2].data_ptr(),
        coh[0].data_ptr(), coh[1].data_ptr(), ang.data_ptr(),
    )
    stft_gcc_frontend_cuda.launches += 1
    return (
        *(p.reshape(*batch, 2, t, f) for p in planes),
        *(p.reshape(*batch, t, f) for p in coh),
        ang.reshape(*batch, t, d),
    )


stft_gcc_frontend_cuda.launches = 0
