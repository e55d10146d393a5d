"""GCC-PHAT: coherence, steering matrices, angular spectrograms
(counterpart of ``gccnmf_tpu/ops/gcc.py``).

The angular spectrogram is a pair of real GEMMs (``Re(C)@cos + Im(C)@sin``)
instead of the reference's complex einsum (gccNMF/gccNMFFunctions.py:85-92).
Layout: coherence is time-major ``(..., T, F)``; angular spectrograms are
``(..., T, D)`` with ``D = num_tdoas``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gccnmf_torch.defs import SPEED_OF_SOUND_M_S

__all__ = [
    "max_tdoa",
    "tdoa_grid",
    "frequency_grid",
    "steering_cos_sin",
    "coherence",
    "angular_spectrogram",
    "mean_angular_spectrum",
]


def max_tdoa(mic_separation_m: float) -> float:
    """Largest possible |TDOA| in seconds (reference gccNMFFunctions.py:50)."""
    return mic_separation_m / SPEED_OF_SOUND_M_S


def tdoa_grid(mic_separation_m: float, num_tdoas: int) -> np.ndarray:
    """Uniform TDOA candidate grid in seconds, ±max_tdoa inclusive."""
    m = max_tdoa(mic_separation_m)
    return np.linspace(-m, m, num_tdoas)


def frequency_grid(sample_rate: float, num_freq: int) -> np.ndarray:
    """rFFT bin center frequencies in Hz: linspace(0, sr/2, F)."""
    return np.linspace(0, sample_rate / 2.0, num_freq)


@functools.lru_cache(maxsize=None)
def steering_cos_sin(
    sample_rate: float, num_freq: int, mic_separation_m: float, num_tdoas: int
):
    """Real/imag parts of the steering matrix ``exp(-i 2π f τ)``: float32
    NumPy arrays ``(F, D)``; the complex matrix is ``cos_m - 1j*sin_m``."""
    freqs = frequency_grid(sample_rate, num_freq)
    ang = 2.0 * np.pi * np.outer(freqs, tdoa_grid(mic_separation_m, num_tdoas))
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def coherence(spec: torch.Tensor, eps: float = 0.0, guard_zeros: bool = False) -> torch.Tensor:
    """PHAT-weighted cross-spectral coherence ``X0 · conj(X1) / (|X0||X1|)``.

    ``spec``: ``(..., 2, T, F)`` complex → ``(..., T, F)`` complex. The
    reference divides unprotected (NaN at exact zeros); ``guard_zeros`` maps
    those bins to 0 instead, bit-identical elsewhere.
    """
    x0 = spec[..., 0, :, :]
    x1 = spec[..., 1, :, :]
    cross = x0 * x1.conj()
    denom = x0.abs() * x1.abs()
    if eps:
        denom = denom + eps
    if guard_zeros:
        ok = denom > 0.0
        return torch.where(ok, cross / torch.where(ok, denom, 1.0), 0.0)
    return cross / denom


def angular_spectrogram(coh: torch.Tensor, cos_m, sin_m) -> torch.Tensor:
    """Angular spectrogram ``(..., T, D)`` from coherence ``(..., T, F)``:
    ``Re(C)@cos + Im(C)@sin``."""
    cos_m = torch.as_tensor(cos_m, dtype=torch.float32, device=coh.device)
    sin_m = torch.as_tensor(sin_m, dtype=torch.float32, device=coh.device)
    return coh.real @ cos_m + coh.imag @ sin_m


def mean_angular_spectrum(angular: torch.Tensor) -> torch.Tensor:
    """Time-averaged angular spectrum ``(..., D)``."""
    return angular.mean(dim=-2)
