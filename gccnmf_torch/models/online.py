"""Online (frame-wise causal) GCC-NMF speech enhancement (counterpart of
``gccnmf_tpu/models/online.py``).

The target is localized from causally accumulated GCC-PHAT statistics and
the NMF coefficients are inferred per frame against a frozen pre-learned
dictionary (the reference plumbs this as ``numHUpdates``,
realtime/config.py:73). The semantics are a causal per-frame recurrence,
computed as batched GEMMs and prefix sums with no loop over frames:

- per-frame angular spectra: one (T, F) x (F, D) GEMM pair;
- causal smoothing (cumulative / sliding / exponential): ``cumsum``, or a
  log-depth scan of the exponential recurrence;
- per-frame target index: the argmax of the smoothed spectra;
- H inference: ``num_h_updates`` multiplicative updates over all frames at
  once (the init does not depend on the frame, so batching is exact);
- masking and the ISTFT, as in the offline enhancer's plain path.

Output frame t depends only on input frames <= t. The JAX package runs
this as XLA ops and reaches no Pallas kernel; the port runs it as torch
ops on either device, and launches none of the CUDA kernels.

Batch invariance: two argmaxes (the per-frame target and the per-(frame,
atom) TDOA) flip on a last-bit difference, and cuBLAS or cuFFT may sum a
batched call in another order than a single one. So a batch runs one
utterance at a time, each through the call a batch of one makes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gccnmf_torch.convert import from_numpy_state
from gccnmf_torch.device import resolve_device
from gccnmf_torch.ops import gcc, masks, nmf, stft as stft_ops
from gccnmf_torch.ops import windows as win_ops
from gccnmf_torch.precision import set_fp32_precision

__all__ = ["OnlineConfig", "OnlineGCCNMFEnhancer"]


@dataclass(frozen=True)
class OnlineConfig:
    sample_rate: int = 16000
    window_size: int = 1024
    hop_size: int = 512
    num_tdoas: int = 64
    mic_separation_m: float = 0.1
    num_h_updates: int = 0  # 0 → W-only Wiener mask (RT rule)
    smoothing: str = "sliding"  # "sliding" | "cumulative" | "exponential"
    smoothing_window: int = 6  # frames, for "sliding"
    smoothing_alpha: float = 0.9  # for "exponential"
    target_epsilon: float = 5.0
    target_beta: float = 2.0
    noise_floor: float = 0.0
    epsilon: float = 1e-16

    @property
    def num_freq(self) -> int:
        return self.window_size // 2 + 1


def _causal_smooth(ang: torch.Tensor, cfg: OnlineConfig) -> torch.Tensor:
    """Causally smooth per-frame angular spectra ``(..., T, D)``."""
    t = ang.shape[-2]
    if cfg.smoothing == "cumulative":
        counts = torch.arange(1, t + 1, dtype=torch.float32, device=ang.device)[:, None]
        return torch.cumsum(ang, dim=-2) / counts
    if cfg.smoothing == "sliding":
        l = cfg.smoothing_window
        csum = torch.cumsum(ang, dim=-2)
        padded = torch.cat([torch.zeros_like(csum[..., :l, :]), csum], dim=-2)
        window_sum = csum - padded[..., :t, :]
        counts = torch.clamp(torch.arange(1, t + 1, dtype=torch.float32, device=ang.device),
                             max=float(l))[:, None]
        return window_sum / counts
    if cfg.smoothing == "exponential":
        # y_t = a·y_{t-1} + (1-a)·x_t as a Hillis-Steele scan over (coef,
        # value) pairs, JAX's associative combine: (ca, va) then (cb, vb)
        # → (ca·cb, vb + cb·va). The closed form a^t·cumsum(a^-s·x_s)
        # overflows float32 past ~840 frames at a = 0.9.
        a = cfg.smoothing_alpha
        value = (1 - a) * ang
        coef = torch.full((t, 1), a, dtype=torch.float32, device=ang.device)
        step = 1
        while step < t:
            value = torch.cat([value[..., :step, :],
                               value[..., step:, :] + coef[step:] * value[..., :-step, :]],
                              dim=-2)
            coef = torch.cat([coef[:step], coef[step:] * coef[:-step]])
            step *= 2
        return value
    raise ValueError(f"unknown smoothing mode: {cfg.smoothing}")


class OnlineGCCNMFEnhancer:
    """Causal frame-wise enhancement with a pre-learned dictionary ``w``
    (F, K). ``device=None`` means CUDA, and raises when there is no card;
    pass ``device="cpu"`` for the CPU."""

    def __init__(self, w: np.ndarray, config: OnlineConfig = OnlineConfig(), device=None):
        self.config = config
        self.device = resolve_device(device)
        set_fp32_precision()
        cfg = config
        cos_m, sin_m = gcc.steering_cos_sin(
            float(cfg.sample_rate), cfg.num_freq, cfg.mic_separation_m, cfg.num_tdoas
        )
        state = from_numpy_state({"w": np.asarray(w, np.float32), "cos": cos_m, "sin": sin_m,
                                  "window": win_ops.sqrt_hamming(cfg.window_size)},
                                 self.device)
        self.w, self._window = state["w"], state["window"]
        self._cos_sin = (state["cos"], state["sin"])
        self._cos_w, self._sin_w = masks.fold_steering_dictionary(*self._cos_sin, self.w)

    def _enhance_one(self, stereo: torch.Tensor):
        """One (2, n) utterance → ``(enhanced (2, n'), target (T,),
        coefficient mask (T, K))``, JAX's ``_enhance_jit_impl`` op for op."""
        cfg = self.config
        spec = stft_ops.stft(stereo, self._window, cfg.hop_size)  # (2, T, F)
        # guard_zeros: digital silence must not NaN-poison the causal
        # localization smoother (bit-identical on nonzero bins)
        coh = gcc.coherence(spec, guard_zeros=True)  # (T, F)
        ang = gcc.angular_spectrogram(coh, *self._cos_sin) / cfg.num_freq
        smoothed = _causal_smooth(ang, cfg)  # (T, D)
        target_idx = torch.argmax(smoothed, dim=-1).to(torch.float32)  # (T,)
        argmax_d = masks.argmax_tdoa(coh.real, coh.imag, self._cos_w, self._sin_w,
                                     cfg.num_tdoas)  # (T, K)
        h_mask = masks.soft_tdoa_coefficient_mask(
            argmax_d, target_idx[:, None], cfg.target_epsilon, cfg.target_beta,
            cfg.noise_floor,
        )  # (T, K)
        if cfg.num_h_updates > 0:
            v = spec.abs().mean(dim=-3)  # (T, F) channel-average magnitudes
            h0 = torch.ones(v.shape[:-1] + (self.w.shape[1],), dtype=torch.float32,
                            device=v.device)
            h = nmf.h_infer(v, self.w, h0, cfg.num_h_updates, epsilon=cfg.epsilon)
            tf_mask = masks.wiener_tf_mask_h(self.w, h, h_mask, cfg.epsilon)
        else:
            tf_mask = masks.wiener_tf_mask(self.w, h_mask)
        out = stft_ops.istft(tf_mask[None] * spec, self._window, cfg.hop_size)
        return out, target_idx, h_mask

    def enhance(self, stereo: np.ndarray):
        """Enhance (2, n) or (..., 2, n) causally. Returns a dict of NumPy
        arrays: ``enhanced`` (same leading shape), the per-frame
        ``target_tdoa_index`` and the ``coefficient_masks``."""
        x = torch.as_tensor(np.asarray(stereo, np.float32), device=self.device)
        lead = x.shape[:-2]
        flat = x.reshape(-1, *x.shape[-2:])
        parts = [self._enhance_one(flat[i]) for i in range(flat.shape[0])]
        out, target_idx, h_mask = (torch.stack(col).reshape(*lead, *col[0].shape)
                                   for col in zip(*parts))
        return dict(
            enhanced=out.cpu().numpy(),
            target_tdoa_index=target_idx.cpu().numpy(),
            coefficient_masks=h_mask.cpu().numpy(),
        )
