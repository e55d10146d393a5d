"""Analysis/synthesis windows (counterpart of ``gccnmf_tpu/ops/windows.py``).

Built host-side with NumPy and returned as float32. The reference uses three
window conventions that matter for waveform parity:

- offline STFT analysis and synthesis: the NumPy-style *symmetric* Hann
  (reference: gccNMF/gccNMFFunctions.py:65, 155);
- streaming: sqrt(symmetric Hamming) for both analysis and synthesis
  (reference: gccNMF/realtime/gccNMFProcessor.py:186-187);
- low-latency streaming: an asymmetric analysis/synthesis pair whose
  synthesis window is nonzero only over its final ``synthesis_length``
  samples (the reference's CHAT 2017 paper, README.md:48).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "hann_symmetric",
    "hann_periodic",
    "hamming_symmetric",
    "sqrt_hamming",
    "asymmetric_analysis_synthesis_pair",
    "cola_check",
]


def hann_symmetric(length: int) -> np.ndarray:
    """NumPy-convention symmetric Hann window (zero endpoints)."""
    if length == 1:
        return np.ones(1, np.float32)
    n = np.arange(length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / (length - 1))).astype(np.float32)


def hann_periodic(length: int) -> np.ndarray:
    """Periodic (DFT-even) Hann window, scipy.signal.hann(sym=False)."""
    n = np.arange(length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / length)).astype(np.float32)


def hamming_symmetric(length: int) -> np.ndarray:
    """NumPy-convention symmetric Hamming window."""
    if length == 1:
        return np.ones(1, np.float32)
    n = np.arange(length)
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * n / (length - 1))).astype(np.float32)


def sqrt_hamming(length: int) -> np.ndarray:
    """sqrt(Hamming): the RT analysis *and* synthesis window.

    Reference: gccNMF/realtime/gccNMFProcessor.py:186.
    """
    return np.sqrt(hamming_symmetric(length)).astype(np.float32)


def asymmetric_analysis_synthesis_pair(
    window_size: int, synthesis_length: int, hop_size: int
) -> tuple[np.ndarray, np.ndarray]:
    """Asymmetric low-latency analysis/synthesis window pair.

    Construction (following the standard asymmetric-windowing recipe used by
    the reference's low-latency variant, README.md:78):

    - analysis window ``wa``: a long square-root-Hann rise over the first
      ``window_size - synthesis_length/2`` samples followed by a
      square-root-Hann fall over the final ``synthesis_length/2`` samples.
    - synthesis window ``ws``: nonzero only over the final
      ``synthesis_length`` samples; its first half is chosen so that
      ``wa * ws`` overlap-adds to a constant at the given hop (COLA), its
      second half is a square-root-Hann fall matching ``wa``'s fall so the
      product is exactly ``hann`` there.

    Requires ``synthesis_length % 2 == 0`` and ``synthesis_length >= 2*hop``.
    Returns float32 arrays of length ``window_size``.
    """
    if synthesis_length % 2:
        raise ValueError("synthesis_length must be even")
    if synthesis_length < 2 * hop_size:
        raise ValueError("synthesis_length must be >= 2*hop_size for COLA")
    if synthesis_length % hop_size:
        raise ValueError("hop_size must divide synthesis_length for exact COLA")
    if synthesis_length > window_size:
        raise ValueError("synthesis_length must be <= window_size")

    m = synthesis_length // 2
    rise_len = window_size - m

    # Halves of a *periodic* Hann: rise(m) ++ fall(m) is exactly
    # hann_periodic(2m), whose shifted copies at any hop dividing 2m sum to a
    # constant — this makes the analysis*synthesis product exactly COLA.
    def hann_rise(n: int) -> np.ndarray:
        k = np.arange(n)
        return 0.5 - 0.5 * np.cos(np.pi * k / n)

    def hann_fall(n: int) -> np.ndarray:
        k = np.arange(n)
        return 0.5 + 0.5 * np.cos(np.pi * k / n)

    wa = np.concatenate([np.sqrt(hann_rise(rise_len)), np.sqrt(hann_fall(m))])

    ws = np.zeros(window_size)
    # Synthesis rise: product wa*ws must equal hann_rise over the first half
    # of the synthesis region so that, together with the hann fall, shifted
    # copies at the hop sum to a constant.
    rise_region = slice(window_size - synthesis_length, window_size - m)
    ws[rise_region] = hann_rise(m) / np.maximum(wa[rise_region], 1e-12)
    ws[window_size - m :] = np.sqrt(hann_fall(m))

    return wa.astype(np.float32), ws.astype(np.float32)


def cola_check(product_window: np.ndarray, hop_size: int) -> float:
    """Max relative deviation of steady-state overlap-add from constant.

    ``product_window`` is the elementwise product of analysis and synthesis
    windows. In steady state, the OLA value at output phase ``r`` is
    ``sum_j p[r + j*hop]``; COLA holds iff these per-residue sums are equal.
    """
    p = np.asarray(product_window, np.float64)
    pad = (-len(p)) % hop_size
    if pad:
        p = np.concatenate([p, np.zeros(pad)])
    residue_sums = p.reshape(-1, hop_size).sum(axis=0)
    mean = residue_sums.mean()
    if mean == 0:
        return np.inf
    return float(np.max(np.abs(residue_sums - mean)) / mean)
