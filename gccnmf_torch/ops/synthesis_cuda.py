"""Kernel 2: the fused masked synthesis on Hopper (``csrc/synthesis.cu``)
and its plain twin.

Replaces ``gccnmf_tpu/ops/synthesis_pallas.py::masked_synthesis_pallas``:
per target s and channel c, magnitudes ``(H_c ⊙ [winner == s])·Wᵀ`` with the
mixture phase re-applied, a windowed and gained inverse DFT, overlap-add
and a window/2 center trim. The TPU kernel carries the overlap-add tail
between time tiles on its sequential grid; on Hopper blocks run in any
order, so the overlap-add is a separate gather (each output sample sums
the frames that cover it) and nothing carries between blocks. The products
bound it (≈16.7 GFLOP per utterance at the reference shape, 3 targets).

The result equals ``istft(masked_reconstruction(...), conjugate=True,
center_trim=True) * gain``: (B, N, C, (T-1)·hop) fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from gccnmf_torch import _build
from gccnmf_torch.ops.stft import idft_matrices, overlap_add
from gccnmf_torch.precision import bf16_operands, round_bf16

__all__ = ["synthesis_basis", "masked_synthesis_cuda", "masked_synthesis_plain"]


def synthesis_basis(window, gain: float, device=None):
    """The iDFT basis with synthesis window and gain folded in, ``(A, −B)``,
    each ``(F, win)`` fp32. The minus undoes the conjugated forward
    transform: frames = Re X·A − Im X·B."""
    window = np.asarray(window, np.float32)
    a_m, b_m = idft_matrices(window.shape[0])
    a = a_m * window[None, :] * gain
    b = b_m * window[None, :] * gain
    return (torch.as_tensor(a, device=device), torch.as_tensor(-b, device=device))


def masked_synthesis_plain(spec_re, spec_im, winner, w, h_stereo, basis, *,
                           num_targets, hop_size, matmul_dtype="bfloat16"):
    """Plain torch version of :func:`masked_synthesis_cuda`."""
    r = round_bf16 if bf16_operands(matmul_dtype) else (lambda x: x)
    a, b_neg = basis
    f, win = a.shape
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
    frames = r(mag * pr[:, None]) @ r(a) + r(mag * pi[:, None]) @ r(b_neg)
    y = overlap_add(r(frames), hop_size)
    t = spec_re.shape[-2]
    return y[..., win // 2 : win // 2 + (t - 1) * hop_size]


def masked_synthesis_cuda(spec_re, spec_im, winner, w, h_stereo, basis, *,
                          num_targets, hop_size, matmul_dtype="bfloat16"):
    """Fused masked reconstruction + ISTFT (conjugate + center-trim).

    ``spec_re``/``spec_im``: (B, C, T, Fp) fp32 or bf16 mixture planes,
    ``Fp >= F``; ``winner``: (B, T, K) int32 winning-target index;
    ``w``: (B, F, K); ``h_stereo``: (B, C, T, K); ``basis``: from
    :func:`synthesis_basis`. ``matmul_dtype="bfloat16"`` rounds where JAX's
    ``make_mm`` does: the mag operands, the iDFT operands and the frames
    entering the overlap-add. Launches the CUDA kernel for CUDA planes; CPU
    planes take :func:`masked_synthesis_plain`."""
    rnd = bf16_operands(matmul_dtype)
    if spec_re.device.type == "cpu":
        return masked_synthesis_plain(spec_re, spec_im, winner, w, h_stereo, basis,
                                      num_targets=num_targets, hop_size=hop_size,
                                      matmul_dtype=matmul_dtype)
    a, b_neg = basis
    dev = _build.require_cuda("masked_synthesis_cuda", spec_re, spec_im, winner, w,
                              h_stereo, a, b_neg)
    b, c, t, fp = spec_re.shape
    f, win = a.shape
    k = w.shape[-1]
    if win % hop_size:
        raise ValueError("masked_synthesis_cuda: window length must be a multiple of hop_size")
    if spec_im.shape != spec_re.shape or spec_im.dtype != spec_re.dtype:
        raise ValueError("masked_synthesis_cuda: spec planes disagree")
    if spec_re.dtype not in (torch.float32, torch.bfloat16) or fp < f:
        raise ValueError("masked_synthesis_cuda: planes must be fp32/bf16 with >= F bins")
    if w.shape != (b, f, k) or h_stereo.shape != (b, c, t, k) or winner.shape != (b, t, k):
        raise ValueError("masked_synthesis_cuda: W, H or winner shape disagrees")
    if winner.dtype != torch.int32 or b_neg.shape != (f, win):
        raise ValueError("masked_synthesis_cuda: winner must be int32 and the basis (F, win)")
    sre, sim = spec_re.contiguous(), spec_im.contiguous()
    win_idx = winner.contiguous()
    w32 = w.to(torch.float32).contiguous()
    h32 = h_stereo.to(torch.float32).contiguous()
    a, b_neg = a.contiguous(), b_neg.contiguous()
    z = b * num_targets * c
    sdt = torch.bfloat16 if rnd else torch.float32
    xri = torch.empty((2, z, t, f), device=dev, dtype=sdt)
    frames = torch.empty((z, t, win), device=dev, dtype=sdt)
    out = torch.empty((b, num_targets, c, (t - 1) * hop_size), device=dev,
                      dtype=torch.float32)
    _build.launch(
        "gccnmf_masked_synthesis", dev,
        sre.data_ptr(), sim.data_ptr(), int(sre.dtype == torch.bfloat16), fp,
        win_idx.data_ptr(), w32.data_ptr(), h32.data_ptr(), a.data_ptr(), b_neg.data_ptr(),
        xri[0].data_ptr(), xri[1].data_ptr(), frames.data_ptr(), out.data_ptr(),
        b, num_targets, c, t, f, k, win, hop_size, int(rnd),
    )
    masked_synthesis_cuda.launches += 1
    return out


masked_synthesis_cuda.launches = 0
