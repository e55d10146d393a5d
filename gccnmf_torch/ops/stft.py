"""Batched STFT / ISTFT on tensors (counterpart of ``gccnmf_tpu/ops/stft.py``).

Layout is **time-major** as in the JAX package: spectrograms are
``(..., num_frames, num_freq)``.

Reference semantics replicated behind flags:

- ``conjugate=True`` reproduces the reference STFT's output conjugation
  (gccNMF/librosaSTFT.py:177-179); its ISTFT undoes it by conjugating the
  half-spectrum before the inverse transform (librosaSTFT.py:278).
- left-aligned frames, ``1 + (n - frame_len)//hop`` frames total
  (librosaSTFT.py:425), i.e. ``center=False`` framing.
- ``center_trim=True`` on the ISTFT trims ``fft_size//2`` samples from
  both ends (librosaSTFT.py:283-284).

Three compute paths: ``method="fft"`` (``torch.fft``), ``method="matmul"``
(the real DFT as two fp32 GEMMs against cos/sin matrices) and
``method="conv"``: framing, windowing and the real DFT as one strided
``conv1d`` whose filters are the windowed DFT rows, so no frame tensor is
built; its inverse is the matching ``conv_transpose1d``, whose
scatter-accumulate is the overlap-add. cuDNN runs it in exact fp32 (TF32
off, ``precision.py``). The fused analysis front-end kernel lives in
``ops/frontend_cuda.py``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from gccnmf_torch.precision import set_fp32_precision

__all__ = [
    "num_frames",
    "frame_signal",
    "pad_center_window",
    "stft",
    "istft",
    "inverse_frames",
    "overlap_add",
    "dft_matrices",
    "idft_matrices",
]


def num_frames(n: int, frame_length: int, hop_size: int) -> int:
    """Number of left-aligned frames fully contained in a length-n signal."""
    return 1 + (n - frame_length) // hop_size


def frame_signal(y: torch.Tensor, frame_length: int, hop_size: int) -> torch.Tensor:
    """Overlapping frames ``(..., T, frame_length)`` of ``(..., n)`` as a
    strided view (no copy)."""
    t = num_frames(y.shape[-1], frame_length, hop_size)
    return y.unfold(-1, frame_length, hop_size)[..., :t, :]


@functools.lru_cache(maxsize=None)
def dft_matrices(fft_size: int, dtype=np.float32):
    """(cos, sin) forward rDFT matrices of shape ``(fft_size, F)``.

    ``X[f] = frames @ cos - 1j * (frames @ sin)`` equals ``rfft(frames)``.
    """
    f = np.arange(fft_size // 2 + 1)
    n = np.arange(fft_size)
    ang = 2.0 * np.pi * np.outer(n, f) / fft_size
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


@functools.lru_cache(maxsize=None)
def idft_matrices(fft_size: int, dtype=np.float32):
    """(A, B) inverse rDFT matrices of shape ``(F, fft_size)``.

    ``y = Re(X) @ A + Im(X) @ B`` equals ``irfft(X, n=fft_size)``.
    """
    num_freq = fft_size // 2 + 1
    f = np.arange(num_freq)
    n = np.arange(fft_size)
    coef = np.full(num_freq, 2.0)
    coef[0] = 1.0
    if fft_size % 2 == 0:
        coef[-1] = 1.0
    ang = 2.0 * np.pi * np.outer(f, n) / fft_size
    a = (coef[:, None] * np.cos(ang) / fft_size).astype(dtype)
    b = (-coef[:, None] * np.sin(ang) / fft_size).astype(dtype)
    return a, b


def _as_window(window, device) -> torch.Tensor:
    if isinstance(window, torch.Tensor):
        return window.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(window, np.float32), device=device)


def _stft_conv(y: torch.Tensor, window: torch.Tensor, hop_size: int, fft_size: int):
    """Frame, window and rDFT as one strided ``conv1d``: output channel
    ``f < F`` is ``Σ_tap y[t·hop + tap]·window[tap]·cos(2π f tap/N)``,
    channels ``F..2F`` the sin part. Returns (real, imag) of the
    unconjugated rfft, shapes ``(..., T, F)``."""
    cos_m, sin_m = (torch.as_tensor(m, device=y.device) for m in dft_matrices(fft_size))
    filt = torch.cat([cos_m, sin_m], dim=1) * window[:, None]  # (fft, 2F)
    *batch, n = y.shape
    set_fp32_precision()
    out = torch.nn.functional.conv1d(y.reshape(-1, 1, n).to(torch.float32),
                                     filt.T[:, None, :], stride=hop_size)  # (N, 2F, T)
    out = out.transpose(-1, -2).reshape(*batch, out.shape[-1], filt.shape[1])
    num_freq = fft_size // 2 + 1
    return out[..., :num_freq], -out[..., num_freq:]


def _istft_conv(spec: torch.Tensor, window: torch.Tensor, hop_size: int, fft_size: int):
    """Inverse rDFT, synthesis window and overlap-add as one strided
    ``conv_transpose1d`` over the ``[Re X | Im X]`` channels: frame ``t``'s
    windowed inverse lands at ``t·hop`` and the overlaps sum."""
    a, b = (torch.as_tensor(m, device=spec.device) for m in idft_matrices(fft_size))
    filt = torch.cat([a, b], dim=0) * window[None, :]  # (2F, fft)
    *batch, t, f = spec.shape
    lhs = torch.cat([spec.real, spec.imag], dim=-1).reshape(-1, t, 2 * f)
    set_fp32_precision()
    y = torch.nn.functional.conv_transpose1d(lhs.transpose(-1, -2), filt[:, None, :],
                                             stride=hop_size)  # (N, 1, n)
    return y.reshape(*batch, y.shape[-1])


def pad_center_window(window: torch.Tensor, fft_size: int) -> torch.Tensor:
    """Center-pad a window shorter than the frame with zeros — librosa's
    ``pad_center`` semantics (left pad ``(size - n) // 2``)."""
    n = window.shape[-1]
    if n == fft_size:
        return window
    if n > fft_size:
        raise ValueError(f"window length {n} exceeds frame length {fft_size}")
    lpad = (fft_size - n) // 2
    return torch.nn.functional.pad(window, (lpad, fft_size - n - lpad))


def stft(
    y: torch.Tensor,
    window,
    hop_size: int,
    *,
    fft_size: Optional[int] = None,
    conjugate: bool = False,
    method: str = "fft",
) -> torch.Tensor:
    """Left-aligned STFT of ``(..., n)`` real audio → ``(..., T, F)``
    complex64, ``F = fft_size//2 + 1``."""
    window = _as_window(window, y.device)
    if fft_size is None:
        fft_size = window.shape[-1]
    window = pad_center_window(window, fft_size)
    if method == "conv":
        spec = torch.complex(*_stft_conv(y, window, hop_size, fft_size))
        return spec.conj().resolve_conj() if conjugate else spec
    frames = frame_signal(y.to(torch.float32), fft_size, hop_size) * window
    if method == "fft":
        spec = torch.fft.rfft(frames, n=fft_size, dim=-1).to(torch.complex64)
    elif method == "matmul":
        cos_m, sin_m = (
            torch.as_tensor(m, device=y.device) for m in dft_matrices(fft_size)
        )
        spec = torch.complex(frames @ cos_m, -(frames @ sin_m))
    else:
        raise ValueError(f"unknown stft method: {method}")
    return spec.conj().resolve_conj() if conjugate else spec


def overlap_add(frames: torch.Tensor, hop_size: int) -> torch.Tensor:
    """Overlap-add ``(..., T, L)`` frames at ``hop_size`` → ``(..., n)``,
    ``n = L + (T - 1) * hop_size``."""
    *batch, t, length = frames.shape
    n_out = length + (t - 1) * hop_size
    if length % hop_size == 0:
        r = length // hop_size
        chunks = frames.reshape(*batch, t, r, hop_size)
        out = frames.new_zeros((*batch, t + r - 1, hop_size))
        for k in range(r):
            out[..., k : k + t, :] += chunks[..., :, k, :]
        return out.reshape(*batch, n_out)
    out = frames.new_zeros((*batch, n_out))
    for i in range(t):
        out[..., i * hop_size : i * hop_size + length] += frames[..., i, :]
    return out


def inverse_frames(spec: torch.Tensor, fft_size: int, method: str = "fft") -> torch.Tensor:
    """Per-frame inverse rDFT: ``(..., T, F)`` complex → ``(..., T,
    fft_size)`` float32 frames (no window, no overlap-add)."""
    if method == "fft":
        return torch.fft.irfft(spec, n=fft_size, dim=-1).to(torch.float32)
    if method == "matmul":
        a, b = (torch.as_tensor(m, device=spec.device) for m in idft_matrices(fft_size))
        return spec.real @ a + spec.imag @ b
    raise ValueError(f"unknown istft method: {method}")


def istft(
    spec: torch.Tensor,
    window,
    hop_size: int,
    *,
    conjugate: bool = False,
    center_trim: bool = False,
    method: str = "fft",
) -> torch.Tensor:
    """Inverse STFT of ``(..., T, F)`` complex → ``(..., n)`` float32.

    ``window`` is the synthesis window (length ``fft_size = 2*(F-1)``),
    applied to each inverse-transformed frame before overlap-add."""
    fft_size = 2 * (spec.shape[-1] - 1)
    window = pad_center_window(_as_window(window, spec.device), fft_size)
    if conjugate:
        spec = spec.conj().resolve_conj()
    if method == "conv":
        y = _istft_conv(spec, window, hop_size, fft_size)
    else:
        y = overlap_add(inverse_frames(spec, fft_size, method) * window, hop_size)
    if center_trim:
        half = fft_size // 2
        y = y[..., half:-half]
    return y
