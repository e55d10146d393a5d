"""The yardstick of the kernels: the least time of each kernel's function
at the shapes it is called with, frozen here so that a later change to the
program is measured against the same work.

The arithmetic is the port's own kernel table (``chip_smoke.py``'s
``bound``, ``dft_flops``, ``basis_len`` and the per-kernel operation and
byte counts of its ``kernel`` phase), copied as it stood. A kernel's least
time is the larger of its bytes over the HBM rate and its least
operations over the peak rate of its operand type. Inputs are counted
read once and outputs written once. A float32 DFT counts as an FFT; in the
bf16 modes the DFT basis is rounded to bf16, which no FFT reproduces, so
the GEMM against that basis is the least work.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit.
"""

from __future__ import annotations

import math

HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {"float32": 67e12, "bfloat16": 989e12, "bfloat16_q": 989e12,
               "bfloat16_q_simul": 989e12}


def bound(flops: float, nbytes: float, mode: str) -> tuple[float, str]:
    """Least time (ms) for the work and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOP_S[mode]
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def dft_flops(frames: int, win: int, mode: str) -> float:
    """Least operations of a real DFT (or its inverse) of ``frames``
    windows of ``win`` samples: an FFT's 2.5·N·log2 N in float32, the
    4·N·F of the GEMM on the bf16-rounded basis otherwise."""
    if mode == "float32":
        return frames * 2.5 * win * math.log2(win)
    return frames * 4 * win * (win // 2 + 1)


def basis_len(win: int, mode: str) -> int:
    """fp32 words of transform constants that DFT reads: the window for an
    FFT, the two (N, F) basis planes for the GEMM."""
    return win if mode == "float32" else 2 * win * (win // 2 + 1)


def nmf_work(b: int, rows: int, f: int, k: int, iterations: int, mode: str,
             v_bytes: int) -> tuple[float, float]:
    """Kernel 1 (KL-NMF over V (B, rows, F), K atoms): four GEMMs of
    2·rows·F·K an iteration (three in the turbo mode); V read once, W and
    H read and written once."""
    gemms = 3 if mode == "bfloat16_q_simul" else 4
    flops = 2 * gemms * b * rows * f * k * iterations
    nbytes = b * rows * f * v_bytes + 2 * 4 * b * (f * k + rows * k)
    return flops, nbytes


def frontend_work(b: int, n: int, t: int, f: int, d: int, win: int, mode: str,
                  plane_bytes: int) -> tuple[float, float]:
    """Kernel 3 (STFT + GCC-PHAT front-end of (B, 2, n) float32 signals):
    the rDFT of B·2·T frames and the (T, F) × (F, D) angular product; the
    signal, the constants, five (T, F) planes a channel pair and the
    angular plane moved once."""
    flops = dft_flops(b * 2 * t, win, mode) + b * 4 * t * f * d
    nbytes = (b * 2 * n * 4 + 4 * (basis_len(win, mode) + 2 * f * d)
              + b * plane_bytes * (3 * 2 * t * f + 2 * t * f) + b * t * d * 4)
    return flops, nbytes


def synthesis_work(b: int, s: int, t: int, f: int, k: int, win: int, hop: int, mode: str,
                   plane_bytes: int) -> tuple[float, float]:
    """Kernel 2 (masked synthesis of S targets × 2 channels): the masked
    W·H product and the inverse DFT of B·S·2·T frames; the spectrum planes,
    winner, W, H and constants read once, the overlap-added signals written
    once."""
    flops = 2 * b * s * 2 * t * f * k + dft_flops(b * s * 2 * t, win, mode)
    nbytes = (b * (2 * 2 * t * f * plane_bytes + t * k * 4 + f * k * 4 + 2 * t * k * 4)
              + 4 * basis_len(win, mode) + b * s * 2 * (t - 1) * hop * 4)
    return flops, nbytes


def span_share(rec: dict, span: str):
    """A kernel's roofline share (%) in a run record: the least time of
    every call made in its span in the traced window over the device time
    of the operations launched inside those spans; None without a trace,
    a call or device time."""
    tr = rec.get("trace")
    if not tr:
        return None
    calls = tr.get("calls", {}).get(span)
    device_s = tr.get("device_s_by_span", {}).get(span, 0.0)
    if not calls or device_s <= 0:
        return None
    least_ms = sum(bound(flops, nbytes, mode)[0] for flops, nbytes, mode in calls)
    return 100.0 * least_ms / (device_s * 1e3)
