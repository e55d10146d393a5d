"""Plain PyTorch reference of real-time GCC-NMF enhancement, one stream at
a time over its whole signal.

The function that ``rt_default_serve`` cells time, written out from the
published real-time algorithm (Wood and Rouat, "Real-time Speech
Enhancement with GCC-NMF", Interspeech 2017; the reference
implementation's ``gccNMFProcessor.py`` at ``realtime/config.py``'s
defaults), independent of the program under test. The program runs it as
a step per 512-sample block with state carried between blocks; this
computes the same output from the whole signal at once:

    frame j   = x[(j−1)·hop, (j+1)·hop) (zeros before the start) · √hamming
    X_j       = rfft(frame j)                                  (C, F)
    C_j       = X_0 · conj(X_1) / (|X_0| |X_1|)   (0 where a channel is 0)
    A_j       = (Re C_j · cos + Im C_j · sin) / F              (D,)
    target_j  = D/2 for j = 0, else argmax of the mean of A over frames
                max(0, j−6) … j−1 (in float64)
    d_j[k]    = argmax_d Σ_f (Re C_j cos_d + Im C_j sin_d)[f] · W[f, k]
    mask_j[k] = exp(−(|d_j[k] − target_j| / ε)^β),  ε = 5, β = 2
    G_j[f]    = Σ_k mask_j[k] W[f, k] / Σ_k W[f, k]
    out frame = irfft(G_j · X_j) · √hamming, overlap-added at hop; block i
                is samples [(i−1)·512, i·512) of the sum
    int16 wire: clamp(y, −1, 1 − 2⁻¹⁵) · 32768 truncated, read as / 32768

Products run in float32 with TF32 off. ``precision="tf32"`` is the
control: the same with TF32 on for every matrix product, the step below
the program's float32.

A frame whose localization is a near-tie (its two best TDOAs' means
within ``AMBIGUOUS`` of each other, relative to the best) may rightly go
either way in a program that sums in another order; the two blocks its
target shapes are marked, so that a check can leave them out.
"""

from __future__ import annotations

import numpy as np
import torch

SPEED_OF_SOUND_M_S = 340.29
TINY = 1e-30
AMBIGUOUS = 1e-5


def sqrt_hamming(n: int) -> np.ndarray:
    k = np.arange(n)
    return np.sqrt((0.54 - 0.46 * np.cos(2.0 * np.pi * k / (n - 1))).astype(np.float32))


def steering(sample_rate: float, num_freq: int, spacing_m: float, num_tdoas: int):
    max_tdoa = spacing_m / SPEED_OF_SOUND_M_S
    freqs = np.linspace(0.0, sample_rate / 2.0, num_freq)
    tdoas = np.linspace(-max_tdoa, max_tdoa, num_tdoas)
    ang = 2.0 * np.pi * np.outer(freqs, tdoas)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def enhance(x_i16: torch.Tensor, w: torch.Tensor, cfg: dict, precision: str = "float32",
            rows: int = 4096) -> torch.Tensor:
    """Enhance int16 streams ``(S, 2, L·block)`` with dictionary ``w``
    (F, K) → (the blocks the server emits, ``(S, 2, L·block)`` float32 on
    the int16 grid; the blocks shaped by a near-tie localization, ``(S,
    L)`` bool)."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        outs = [_enhance_one(x, w, cfg, rows) for x in x_i16]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _enhance_one(x_i16, w, cfg, rows):
    dev = x_i16.device
    win, hop, blk = cfg["window_size"], cfg["hop_size"], cfg["block_size"]
    if hop != blk or win != 2 * hop:
        raise ValueError("the reference covers one frame a block (window = 2 · hop = 2 · block)")
    f, d_count = win // 2 + 1, cfg["num_tdoas"]
    x = x_i16.to(torch.float32) / 32768.0  # (2, n)
    n = x.shape[-1]
    frames_n = n // blk
    padded = torch.cat([torch.zeros((2, win - hop), device=dev), x], dim=-1)
    window = torch.as_tensor(sqrt_hamming(win), device=dev)
    frames = padded.unfold(-1, win, hop)[:, :frames_n] * window  # (2, J, win)
    spec = torch.fft.rfft(frames, n=win, dim=-1)  # (2, J, F)
    cross = spec[0] * spec[1].conj()
    den = spec[0].abs() * spec[1].abs()
    ok = den > 0.0
    coh = torch.where(ok, cross / torch.where(ok, den, torch.ones_like(den)), 0.0)
    cos_np, sin_np = steering(float(cfg["sample_rate"]), f, cfg["mic_separation_m"], d_count)
    cos_m, sin_m = torch.as_tensor(cos_np, device=dev), torch.as_tensor(sin_np, device=dev)
    w = w.to(device=dev, dtype=torch.float32)
    k = w.shape[1]
    cw = (cos_m[:, :, None] * w[:, None, :]).reshape(f, d_count * k)
    sw = (sin_m[:, :, None] * w[:, None, :]).reshape(f, d_count * k)
    argmax_d = torch.empty((frames_n, k), device=dev)
    for i in range(0, frames_n, rows):  # the (J, D·K) scores a block of rows at a time
        re, im = coh.real[i:i + rows].contiguous(), coh.imag[i:i + rows].contiguous()
        scores = (re @ cw + im @ sw).reshape(-1, d_count, k)
        argmax_d[i:i + rows] = scores.argmax(dim=1).to(torch.float32)
    ang = (coh.real.contiguous() @ cos_m + coh.imag.contiguous() @ sin_m) / f  # (J, D)

    # the localized target of each frame: frames before it, at most six
    lw = cfg["localization_window"]
    csum = torch.cat([torch.zeros((1, d_count), dtype=torch.float64, device=dev),
                      torch.cumsum(ang.double(), dim=0)])
    j = torch.arange(frames_n, device=dev)
    lo = torch.clamp(j - lw, min=0)
    count = torch.clamp(j - lo, min=1).to(torch.float64)
    mean = (csum[j] - csum[lo]) / count[:, None]
    target = torch.where(j > 0, mean.argmax(dim=1).to(torch.float32),
                         torch.full_like(j, d_count // 2, dtype=torch.float32))
    top2 = mean.topk(2, dim=1).values
    tie = (j > 0) & (top2[:, 0] - top2[:, 1] <= AMBIGUOUS * top2[:, 0].abs().clamp(min=TINY))
    ambiguous = tie.clone()
    ambiguous[1:] |= tie[:-1]  # frame j's target shapes blocks j and j + 1

    eps, beta = cfg["target_epsilon"], cfg["target_beta"]
    mask = torch.exp(-((argmax_d - target[:, None]).abs() / eps) ** beta)  # (J, K)
    gain = (mask @ w.T) / w.sum(dim=1)  # (J, F)
    out = torch.fft.irfft(spec * gain, n=win, dim=-1) * window  # (2, J, win)
    y = torch.zeros((2, (frames_n + 1) * hop), device=dev)
    y[:, :frames_n * hop] += out[..., :hop].reshape(2, -1)
    y[:, hop:(frames_n + 1) * hop] += out[..., hop:].reshape(2, -1)
    y = y[:, :frames_n * blk]
    pcm = (torch.clamp(y, -1.0, 1.0 - 2.0**-15) * 32768.0).to(torch.int16)
    return pcm.to(torch.float32) / 32768.0, ambiguous


def block_errors(out: torch.Tensor, ref: torch.Tensor, block: int):
    """Per stream and block, ``(S, L)`` float64: the RMS of ``out − ref``
    over the block; and per stream, ``(S,)``, the RMS of ``ref`` over the
    whole stream, which scales both."""
    s = out.shape[0]
    d = (out.double() - ref.double()).reshape(s, 2, -1, block)
    num = d.pow(2).mean(dim=(1, 3)).sqrt()
    den = ref.double().reshape(s, -1).pow(2).mean(dim=1).sqrt().clamp(min=1e-12)
    return num, den
