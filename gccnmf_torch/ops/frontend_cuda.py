"""Kernel 3: the fused analysis front-end on Hopper (``csrc/frontend.cu``)
and its plain twin.

Replaces ``gccnmf_tpu/ops/frontend_pallas.py::stft_gcc_frontend_pallas``:
one pass over raw stereo producing the conjugated spectrogram planes, the
magnitudes |X| (the NMF's V), the PHAT coherence planes and the angular
spectrogram. Frame t is a strided view ``x[t*hop + j]`` staged straight into
shared memory, so no frame tensor reaches device memory, and any hop works
(the TPU kernel needs hop | window). The products bound it (≈5.6 GFLOP per
utterance at the reference shape).

Planes are exactly F bins wide (the port pads nothing); the TPU kernel's
contract is equality on ``[..., :F]``. The angular spectrogram is computed
from the planes as stored, which is what the TPU kernel's bf16 GEMM
operands see in the throughput mode and exact in float32 mode.
"""

from __future__ import annotations

import numpy as np
import torch

from gccnmf_torch import _build
from gccnmf_torch.ops.stft import dft_matrices, frame_signal, num_frames
from gccnmf_torch.precision import bf16_operands, round_bf16

__all__ = [
    "frontend_basis",
    "stft_gcc_frontend_cuda",
    "stft_gcc_frontend_plain",
    "PLANE_DTYPES",
]

PLANE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def frontend_basis(window, conjugate: bool = True, device=None):
    """The windowed rDFT basis ``(window·cos, ±window·sin)``, each
    ``(win, F)`` fp32, with the conjugation sign folded into the sin half
    (rfft's imaginary part is ``-frames@sin``; conjugating flips it)."""
    window = np.asarray(window, np.float32)
    dcos, dsin = dft_matrices(window.shape[0])
    sign = 1.0 if conjugate else -1.0
    wcos = window[:, None] * dcos
    wsin = (sign * window)[:, None] * dsin
    return (torch.as_tensor(wcos, device=device), torch.as_tensor(wsin, device=device))


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
    wcos, wsin = basis
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
    :func:`frontend_basis`; ``cos_m``/``sin_m``: (F, D) fp32 steering planes.

    Returns ``(spec_re, spec_im, v, coh_re, coh_im, ang)``: spec planes and
    magnitudes (..., 2, T, F), coherence planes (..., T, F), all in
    ``plane_dtype``, and the angular spectrogram (..., T, D) fp32.
    ``matmul_dtype="bfloat16"`` rounds every GEMM operand to bf16 (fp32
    accumulation). Launches the CUDA kernel for a CUDA ``stereo``; a CPU
    ``stereo`` takes :func:`stft_gcc_frontend_plain`."""
    rnd, pd = _check_dtypes(matmul_dtype, plane_dtype)
    if stereo.device.type == "cpu":
        return stft_gcc_frontend_plain(stereo, basis, cos_m, sin_m, hop_size=hop_size,
                                       matmul_dtype=matmul_dtype, plane_dtype=plane_dtype)
    wcos, wsin = basis
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
    for name, m in (("basis", wcos), ("basis", wsin), ("cos_m", cos_m), ("sin_m", sin_m)):
        if m.dtype != torch.float32 or not m.is_contiguous():
            raise ValueError(f"stft_gcc_frontend_cuda: {name} must be contiguous float32")
    t = num_frames(n, win, hop_size)
    x = stereo.reshape(-1, 2, n).to(torch.float32).contiguous()
    b = x.shape[0]
    planes = torch.empty((3, b, 2, t, f), device=dev, dtype=pd)
    coh = torch.empty((2, b, t, f), device=dev, dtype=pd)
    ang = torch.empty((b, t, d), device=dev, dtype=torch.float32)
    _build.launch(
        "gccnmf_frontend", dev,
        x.data_ptr(), b, n, hop_size, win, wcos.data_ptr(), wsin.data_ptr(),
        cos_m.data_ptr(), sin_m.data_ptr(), t, f, d, int(rnd), int(pd == torch.bfloat16),
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
