"""The yardstick of kernels 4 and 5, the offline enhancer's soft mask and
Wiener synthesis: each call's least operations and bytes at the shapes it
is called with, frozen here beside ``roofline.py``'s counts of kernels 1–3
(the port's kernel table, ``chip_smoke.py``'s ``kernel`` phase, copied as
it stood). Inputs are counted read once and outputs written once; the
peaks and :func:`roofline.bound` are ``roofline.py``'s.
"""

from __future__ import annotations

from harness.roofline import basis_len, dft_flops


def soft_mask_work(b: int, t: int, f: int, d: int, k: int, mode: str,
                   plane_bytes: int) -> tuple[float, float]:
    """Kernel 4 (the soft coefficient mask of (B, T) frames, D TDOAs, K
    atoms): in bf16, where the folded product ``cos_d·W`` is rounded, the
    scores' 4·B·T·F·D·K flop; in float32 Re c·cos_d + Im c·sin_d formed
    first, then one GEMM against W (2·B·T·F·D·K + 3·B·T·F·D). The two
    coherence planes, W, the steering planes and the (B, 4) mask
    parameters read once, the (B, T, K) fp32 mask written once."""
    if mode == "float32":
        flops = 2 * b * t * f * d * k + 3 * b * t * f * d
    else:
        flops = 4 * b * t * f * d * k
    nbytes = b * 2 * t * f * plane_bytes + 4 * (f * k + 2 * f * d) + b * 16 + b * t * k * 4
    return flops, nbytes


def tf_synthesis_work(b: int, c: int, t: int, f: int, k: int, win: int, hop: int, mode: str,
                      plane_bytes: int) -> tuple[float, float]:
    """Kernel 5 (the Wiener-masked ISTFT of C channels): the Wiener
    product's 2·B·T·K·F flop and the inverse DFT of B·C·T frames, counted
    as ``roofline.synthesis_work`` counts it; the spectrum planes, the
    mask, W and the constants read once, the overlap-added signals
    written once."""
    flops = 2 * b * t * k * f + dft_flops(b * c * t, win, mode)
    nbytes = (b * c * 2 * t * f * plane_bytes + b * t * k * 4 + k * f * 4
              + 4 * basis_len(win, mode) + b * c * (t - 1) * hop * 4)
    return flops, nbytes
