"""Plain PyTorch reference of offline GCC-NMF blind separation.

The function that ``sisec_dev1_sep`` cells time, written out from the
published algorithm (Wood et al., "Blind Speech Separation and Enhancement
With GCC-NMF", IEEE/ACM TASLP 2017; the reference implementation's
``runGCCNMF.py``), independent of the program under test: it imports
nothing of it and takes nothing it made. Every step in float32, matrix
products with TF32 off:

    X    = conj(rfft(hann · frame(x)))            (left-aligned frames)
    V    = [|X_0| ; |X_1|]                         (2T, F)
    W, H = 100 KL multiplicative updates from numpy RandomState(0) draws
    C    = X_0 · conj(X_1) / (|X_0| |X_1|)         (GCC-PHAT)
    A    = Re C · cos + Im C · sin                 (T, D) angular spectrogram
    targets = the S highest interior local maxima of mean_t A, ascending
    winner[t, k] = argmax_s Σ_f (Re C cos_s + Im C sin_s)[t, f] W[f, k]
    Ŷ_s,c = ((H_c ⊙ [winner = s]) Wᵀ) · X_c / |X_c|
    y_s,c = istft(conj Ŷ) · hop / window · 2, trimmed by window/2 each end
    int16 output: clamp(y · 32768) truncated, read back as / 32768

Two controls, each the step below a configuration's precision:
``precision="fp8"`` (below bfloat16) rounds every stored plane and every
matrix-product operand to float8 e4m3 under a per-tensor scale (amax to
448); ``precision="tf32"`` (below float32) runs every matrix product in
TF32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SPEED_OF_SOUND_M_S = 340.29
TINY = 1e-30
FP8_MAX = 448.0


def rounder(precision: str):
    """The operand rounding of ``precision``: none for float32 and TF32,
    per-tensor scaled float8 e4m3 for the fp8 control."""
    if precision in ("float32", "tf32"):
        return lambda x: x
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")

    def fp8(x: torch.Tensor) -> torch.Tensor:
        amax = x.detach().abs().amax().clamp(min=TINY)
        scale = FP8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale

    return fp8


def hann_symmetric(n: int) -> np.ndarray:
    k = np.arange(n)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / (n - 1))).astype(np.float32)


def steering(sample_rate: float, num_freq: int, spacing_m: float, num_tdoas: int):
    """cos and sin of 2π f τ on the linear frequency and TDOA grids, (F, D)."""
    max_tdoa = spacing_m / SPEED_OF_SOUND_M_S
    freqs = np.linspace(0.0, sample_rate / 2.0, num_freq)
    tdoas = np.linspace(-max_tdoa, max_tdoa, num_tdoas)
    ang = 2.0 * np.pi * np.outer(freqs, tdoas)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def nmf_init(num_freq: int, atoms: int, rows: int, epsilon: float):
    """The reference's seeded init: RandomState(0), W then H, float32 + ε;
    H returned time-major (rows, K)."""
    rs = np.random.RandomState(0)
    w0 = rs.random_sample((num_freq, atoms)).astype(np.float32) + epsilon
    h0 = rs.random_sample((atoms, rows)).astype(np.float32) + epsilon
    return w0, np.ascontiguousarray(h0.T)


def _div(a, b):
    ok = b > TINY
    return torch.where(ok, a / torch.where(ok, b, torch.ones_like(b)), torch.zeros_like(a))


def kl_nmf(v, w, h, iterations: int, epsilon: float, r):
    """Sequential KL updates (H, then W from a fresh ratio), per-atom
    renormalisation; ``r`` rounds every product operand."""
    for _ in range(iterations):
        q = _div(v, r(h) @ r(w).transpose(-1, -2))
        h = h * (r(q) @ r(w)) / (w.sum(dim=-2, keepdim=True) + epsilon)
        q = _div(v, r(h) @ r(w).transpose(-1, -2))
        w = w * _div(r(q).transpose(-1, -2) @ r(h), h.sum(dim=-2, keepdim=True))
        norms = torch.sqrt((w * w).sum(dim=-2, keepdim=True))
        w, h = _div(w, norms), h * norms
    return w, h


def top_peaks(a: torch.Tensor, count: int) -> torch.Tensor:
    """The ``count`` highest strict interior local maxima of each row of
    ``a`` (B, D), the lower index first among equals, sorted ascending; a
    row short of peaks repeats its global argmax."""
    mid = a[:, 1:-1]
    peak = torch.zeros_like(a, dtype=torch.bool)
    peak[:, 1:-1] = (mid > a[:, :-2]) & (mid > a[:, 2:])
    out = []
    for row, is_peak in zip(a.tolist(), peak.tolist()):
        idx = sorted((i for i in range(len(row)) if is_peak[i]), key=lambda i: (-row[i], i))
        best = max(range(len(row)), key=lambda i: (row[i], -i))
        idx = (idx + [best] * count)[:count]
        out.append(sorted(idx))
    return torch.tensor(out, dtype=torch.long, device=a.device)


def separate(x_i16: torch.Tensor, cfg: dict, precision: str = "float32", block: int = 4,
             targets: torch.Tensor | None = None):
    """Separate int16 mixtures ``(B, 2, n)`` → ``(targets (B, S) int64,
    estimates (B, S, 2, n_out) float32, mean angular spectra (B, D))``,
    ``block`` mixtures at a time. Given ``targets`` (B, S), separate for
    those instead of the peaks picked here."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        parts = [_separate(x_i16[i:i + block], cfg, precision,
                           None if targets is None else targets[i:i + block])
                 for i in range(0, x_i16.shape[0], block)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return tuple(torch.cat([p[k] for p in parts]) for k in range(3))


def _separate(x_i16, cfg, precision, targets=None):
    r = rounder(precision)
    dev = x_i16.device
    win, hop = cfg["window_size"], cfg["hop_size"]
    f = win // 2 + 1
    eps = cfg["epsilon"]
    x = x_i16.to(torch.float32) / 32768.0
    b, _, n = x.shape
    t = 1 + (n - win) // hop
    window = torch.as_tensor(hann_symmetric(win), device=dev)
    frames = x.unfold(-1, win, hop)[..., :t, :] * window
    spec = torch.fft.rfft(frames, n=win, dim=-1).conj()  # (B, 2, T, F)
    sre, sim = r(spec.real.contiguous()), r(spec.imag.contiguous())
    mag = torch.sqrt(sre * sre + sim * sim)

    v = r(torch.cat([mag[:, 0], mag[:, 1]], dim=-2))  # (B, 2T, F)
    w0, h0 = nmf_init(f, cfg["dictionary_size"], 2 * t, eps)
    w = torch.as_tensor(w0, device=dev).expand(b, -1, -1).contiguous()
    h = torch.as_tensor(h0, device=dev).expand(b, -1, -1).contiguous()
    w, h = kl_nmf(v, w, h, cfg["num_iterations"], eps, r)

    # GCC-PHAT coherence and the angular spectrogram
    cross_re = sre[:, 0] * sre[:, 1] + sim[:, 0] * sim[:, 1]
    cross_im = sim[:, 0] * sre[:, 1] - sre[:, 0] * sim[:, 1]
    den = mag[:, 0] * mag[:, 1]
    cre, cim = r(_div(cross_re, den)), r(_div(cross_im, den))
    cos_np, sin_np = steering(float(cfg["sample_rate"]), f, cfg["mic_separation_m"],
                              cfg["num_tdoas"])
    cos_m, sin_m = torch.as_tensor(cos_np, device=dev), torch.as_tensor(sin_np, device=dev)
    mean_ang = (cre @ r(cos_m) + cim @ r(sin_m)).mean(dim=-2)  # (B, D)
    if targets is None:
        targets = top_peaks(mean_ang, cfg["num_sources"])  # (B, S)

    # attribution: each (frame, atom) to the target that scores highest
    cs, ss = cos_m.T[targets].transpose(-1, -2), sin_m.T[targets].transpose(-1, -2)  # (B, F, S)
    s = targets.shape[-1]
    cw = r((cs[..., None] * w[:, :, None, :]).reshape(b, f, -1))
    sw = r((ss[..., None] * w[:, :, None, :]).reshape(b, f, -1))
    scores = (cre @ cw + cim @ sw).reshape(b, t, s, -1)  # (B, T, S, K)
    winner = scores.argmax(dim=-2)  # (B, T, K); the first of equals

    # masked magnitudes with the mixture's phase, inverse STFT
    h_st = torch.stack([h[:, :t], h[:, t:]], dim=1)  # (B, 2, T, K)
    phase_re, phase_im = _div(sre, mag), _div(sim, mag)
    phase_re = torch.where(mag > TINY, phase_re, torch.ones_like(phase_re))
    synth = torch.as_tensor(hann_symmetric(win), device=dev)
    gain = hop / float(win) * 2.0
    n_out = (t - 1) * hop
    est = torch.empty((b, s, 2, n_out), device=dev)
    wt = r(w).transpose(-1, -2)
    for i in range(s):
        sel = (winner == i).to(torch.float32)[:, None]  # (B, 1, T, K)
        mags = r(h_st * sel) @ wt[:, None]  # (B, 2, T, F)
        est_spec = torch.complex(r(mags * phase_re), r(mags * phase_im)).conj()
        fr = torch.fft.irfft(est_spec, n=win, dim=-1) * synth  # (B, 2, T, win)
        est[:, i] = _overlap_add(fr, hop)[..., win // 2: win // 2 + n_out] * gain
    pcm = torch.clamp(est * 32768.0, -32768.0, 32767.0).to(torch.int16)
    return targets, pcm.to(torch.float32) / 32768.0, mean_ang


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add ``(..., T, L)`` frames at ``hop`` (L a multiple of hop)."""
    *lead, t, length = frames.shape
    r_ = length // hop
    if r_ * hop != length:
        raise ValueError(f"window {length} is not a multiple of hop {hop}")
    chunks = frames.reshape(*lead, t, r_, hop)
    out = frames.new_zeros((*lead, t + r_ - 1, hop))
    for k in range(r_):
        out[..., k:k + t, :] += chunks[..., :, k, :]
    return out.reshape(*lead, (t + r_ - 1) * hop)


def target_gaps(mean_ang: torch.Tensor, want: torch.Tensor, got: torch.Tensor) -> torch.Tensor:
    """How far targets ``got`` (B, S) fall short of ``want`` on the mean
    angular spectra (B, D) that picked ``want``: the heights given up, over
    the spectrum's range; 0 where the sets agree."""
    span = (mean_ang.amax(dim=1) - mean_ang.amin(dim=1)).clamp(min=TINY)
    lost = mean_ang.gather(1, want).sum(dim=1) - mean_ang.gather(1, got).sum(dim=1)
    same = (torch.sort(want, dim=1).values == torch.sort(got, dim=1).values).all(dim=1)
    return torch.where(same, 0.0, (lost / span).clamp(min=0.0))


def relative_errors(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per mixture: ‖est − ref‖₂ / ‖ref‖₂ over its targets, channels and
    samples, in float64."""
    d = (est.double() - ref.double()).flatten(1)
    return d.norm(dim=1) / ref.double().flatten(1).norm(dim=1).clamp(min=math.ulp(1.0))
