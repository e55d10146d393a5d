"""Plain PyTorch reference of offline GCC-NMF speech enhancement with a
pre-learned dictionary.

The function that ``sisec16_bgn_enh_k1024`` cells time, written out from
the published algorithm (Wood et al., "Blind Speech Separation and
Enhancement With GCC-NMF", IEEE/ACM TASLP 2017, and the reference
implementation's real-time enhancer, ``gccNMFProcessor.py``'s window-function
target mode and Wiener mask), independent of the program under test: it
imports nothing of it and takes nothing it made. Every step in float32,
matrix products with TF32 off:

    X      = conj(rfft(hann · frame(x)))               (B, 2, T, F), left-aligned frames
    C      = X_0 · conj(X_1) / (|X_0| |X_1|)           (GCC-PHAT; 0 where a bin is 0)
    A      = Re C · cos + Im C · sin                   (T, D) angular spectrogram
    target = argmax_d mean_t A                         (the first of equals)
    d*[t, k] = argmax_d Σ_f (Re C cos_d + Im C sin_d)[t, f] · W[f, k]
    h[t, k]  = exp(−(|d* − target| / ε)^β) / (1 + floor) + floor
    M[t, f]  = Σ_k h[t, k] · W[f, k] / Σ_k W[f, k]     (the Wiener mask)
    y_c    = istft(conj(M ⊙ X_c)) · hop / window · 2, trimmed by window/2 each end
    int16 output: clamp(y · 32768) truncated, read back as / 32768

Departures from the published description, each as the program has it:

- the whole utterance has one target, the peak of its time-averaged
  angular spectrum (the real-time enhancer tracks a target over blocks);
- the Wiener mask weighs every atom by the flat prior Σ_k W (no H is
  inferred: ``num_h_updates`` 0);
- distance 0 to the target is pinned to a mask of 1 (``0^β`` read as 0),
  which differs from ``0^β`` only at β = 0;
- the scores run ``tdoa_block`` TDOAs at a time into a running
  (max, argmax) with a strict ``>``, so that 16 mixtures of 60 s at
  K = 1,024 fit on one card (a whole (T, D, K) array is 1.96 GB a mixture);
  the first maximum wins, as in one argmax over all TDOAs.

The control, the step below bfloat16: ``precision="fp8"`` rounds every
stored plane and every matrix-product operand to float8 e4m3 under a
per-tensor scale (``offline_gccnmf.rounder``).
"""

from __future__ import annotations

import torch

from reference.offline_gccnmf import (
    TINY, _div, _overlap_add, hann_symmetric, relative_errors, rounder, steering,
)

__all__ = ["enhance", "target_gaps", "relative_errors"]


def enhance(x_i16: torch.Tensor, cfg: dict, w: torch.Tensor, precision: str = "float32",
            block: int = 2, tdoa_block: int = 16, targets: torch.Tensor | None = None):
    """Enhance int16 mixtures ``(B, 2, n)`` with the dictionary ``w`` (F, K)
    → ``(targets (B,) int64, enhanced (B, 2, n_out) float32, mean angular
    spectra (B, D))``, ``block`` mixtures at a time. Given ``targets`` (B,),
    enhance around those instead of the peaks picked here."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        parts = [_enhance(x_i16[i:i + block], cfg, w, precision, tdoa_block,
                          None if targets is None else targets[i:i + block])
                 for i in range(0, x_i16.shape[0], block)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return tuple(torch.cat([p[k] for p in parts]) for k in range(3))


def _enhance(x_i16, cfg, w, precision, tdoa_block, targets=None):
    r = rounder(precision)
    dev = x_i16.device
    win, hop = cfg["window_size"], cfg["hop_size"]
    f = win // 2 + 1
    x = x_i16.to(torch.float32) / 32768.0
    b, _, n = x.shape
    t = 1 + (n - win) // hop
    window = torch.as_tensor(hann_symmetric(win), device=dev)
    frames = x.unfold(-1, win, hop)[..., :t, :] * window
    spec = torch.fft.rfft(frames, n=win, dim=-1).conj()  # (B, 2, T, F)
    sre, sim = r(spec.real.contiguous()), r(spec.imag.contiguous())
    mag = torch.sqrt(sre * sre + sim * sim)

    # GCC-PHAT coherence, the angular spectrogram and the target
    cross_re = sre[:, 0] * sre[:, 1] + sim[:, 0] * sim[:, 1]
    cross_im = sim[:, 0] * sre[:, 1] - sre[:, 0] * sim[:, 1]
    den = mag[:, 0] * mag[:, 1]
    cre, cim = r(_div(cross_re, den)), r(_div(cross_im, den))  # (B, T, F)
    cos_np, sin_np = steering(float(cfg["sample_rate"]), f, cfg["mic_separation_m"],
                              cfg["num_tdoas"])
    cos_m, sin_m = torch.as_tensor(cos_np, device=dev), torch.as_tensor(sin_np, device=dev)
    mean_ang = (cre @ r(cos_m) + cim @ r(sin_m)).mean(dim=-2)  # (B, D)
    if targets is None:
        targets = mean_ang.argmax(dim=-1)

    # each (frame, atom) to the TDOA whose steered coherence scores highest
    w = w.to(device=dev, dtype=torch.float32)
    k = w.shape[1]
    rw = r(w)
    best = torch.full((b, t, k), -torch.inf, device=dev)
    arg = torch.zeros((b, t, k), dtype=torch.long, device=dev)
    for d0 in range(0, cfg["num_tdoas"], tdoa_block):
        cs, ss = cos_m[:, d0:d0 + tdoa_block].T, sin_m[:, d0:d0 + tdoa_block].T  # (db, F)
        steered = r(cre[:, :, None, :] * cs + cim[:, :, None, :] * ss)  # (B, T, db, F)
        scores = steered @ rw  # (B, T, db, K)
        top, at = scores.max(dim=2)  # the first maximum within the block
        upd = top > best
        best = torch.where(upd, top, best)
        arg = torch.where(upd, at + d0, arg)
        del steered, scores

    # the soft coefficient mask around the target, the Wiener mask, ISTFT
    eps, beta, floor = cfg["target_epsilon"], cfg["target_beta"], cfg["noise_floor"]
    dist = (arg - targets[:, None, None]).abs().to(torch.float32) / eps
    pw = torch.where(dist > 0, dist.clamp(min=TINY) ** beta, torch.zeros_like(dist))
    h_mask = torch.exp(-pw) / (1.0 + floor) + floor  # (B, T, K)
    wn = (w / w.sum(dim=-1, keepdim=True)).T  # (K, F)
    tf = (r(h_mask) @ r(wn))[:, None]  # (B, 1, T, F)
    est_spec = torch.complex(r(tf * sre), r(tf * sim)).conj()
    fr = torch.fft.irfft(est_spec, n=win, dim=-1) * window  # (B, 2, T, win)
    n_out = (t - 1) * hop
    gain = hop / float(win) * 2.0
    out = _overlap_add(fr, hop)[..., win // 2: win // 2 + n_out] * gain
    pcm = torch.clamp(out * 32768.0, -32768.0, 32767.0).to(torch.int16)
    return targets, pcm.to(torch.float32) / 32768.0, mean_ang


def target_gaps(mean_ang: torch.Tensor, want: torch.Tensor, got: torch.Tensor) -> torch.Tensor:
    """How far targets ``got`` (B,) fall short of ``want`` on the mean
    angular spectra (B, D) that picked ``want``: the height given up, over
    the spectrum's range; 0 where they agree."""
    span = (mean_ang.amax(dim=1) - mean_ang.amin(dim=1)).clamp(min=TINY)
    lost = mean_ang.gather(1, want[:, None]) - mean_ang.gather(1, got[:, None])
    return torch.where(want == got, 0.0, (lost[:, 0] / span).clamp(min=0.0))
