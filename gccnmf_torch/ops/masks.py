"""Atom-to-TDOA attribution, coefficient masks and masked reconstruction
(counterpart of ``gccnmf_tpu/ops/masks.py``).

Separation: per-(atom, frame) attribution scores for each target TDOA,
argmax over targets → binary coefficient masks → masked ``W·H`` magnitudes
with the mixture phase (reference: gccNMF/gccNMFFunctions.py:118-151).
Enhancement: the per-(frame, atom) argmax over all TDOAs from a
steering-folded dictionary → a soft (generalized-Gaussian) or boxcar
coefficient mask around the target → a Wiener TF mask (reference:
gccNMF/realtime/gccNMFProcessor.py:259-269). Layouts are time-major:
scores ``(N, T, K)``, masks ``(N, T, K)``, TF masks ``(..., T, F)``.

``torch.argmax`` treats NaN as the maximum; the JAX package maps NaN to
−inf before every argmax, and so does this module.
"""

from __future__ import annotations

import torch

__all__ = [
    "target_attribution",
    "attribution_winner",
    "attribution_winner_planes",
    "hard_coefficient_masks",
    "winner_one_hot",
    "masked_reconstruction",
    "fold_steering_dictionary",
    "argmax_tdoa",
    "soft_tdoa_coefficient_mask",
    "boxcar_tdoa_coefficient_mask",
    "wiener_tf_mask",
    "wiener_tf_mask_h",
]


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _nan_to_neginf(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), -torch.inf, x)


def target_attribution(coh, cos_m, sin_m, target_indexes, w) -> torch.Tensor:
    """Per-target atom attribution scores ``(N, T, K)``:
    ``Re( Σ_f W[f,k] · coh[t,f] · exp(-i 2π f τ_n) )`` as real GEMMs
    (reference gccNMFFunctions.py:132-133)."""
    idx = torch.as_tensor(target_indexes, dtype=torch.long, device=coh.device)
    cos_sel = _f32(cos_m, coh.device)[:, idx]  # (F, N)
    sin_sel = _f32(sin_m, coh.device)[:, idx]
    re = (
        coh.real[..., None, :, :] * cos_sel.T[:, None, :]
        + coh.imag[..., None, :, :] * sin_sel.T[:, None, :]
    )  # (N, T, F)
    return re @ w


def attribution_winner(coh, cos_m, sin_m, target_indexes, w) -> torch.Tensor:
    """Batched per-(frame, atom) winning-target index ``(B, T, K)`` int32.

    ``coh``: (B, T, F) complex; ``target_indexes``: (B, N); ``w``: (B, F, K).
    """
    return attribution_winner_planes(
        coh.real, coh.imag, cos_m, sin_m, target_indexes, w
    )


def attribution_winner_planes(coh_re, coh_im, cos_m, sin_m, target_indexes, w) -> torch.Tensor:
    """:func:`attribution_winner` on coherence planes ``(B, T, Fp)`` (f32
    or bf16, ``Fp >= F``; bins past F must be zero). The steering columns
    are folded into the dictionary, so the scores are two flat GEMMs
    ``(T, F) x (F, N·K)`` in fp32 and the (B, N, T, F) broadcast never
    exists.

    A batch runs one utterance at a time, each through the call a batch of
    one makes, on tensors of its own: cuBLAS may sum a batched product in
    another order than a single one, and where two targets score within
    rounding of each other the argmax then flips, so a batch element would
    not give what it gives alone."""
    dev = coh_re.device
    idx = torch.as_tensor(target_indexes, dtype=torch.long, device=dev)
    if coh_re.dim() == 3 and coh_re.shape[0] > 1:
        return torch.cat([
            attribution_winner_planes(coh_re[i:i + 1].clone(), coh_im[i:i + 1].clone(), cos_m,
                                      sin_m, idx[i:i + 1], w[i:i + 1].clone())
            for i in range(coh_re.shape[0])
        ])
    cos_sel = _f32(cos_m, dev).T[idx].transpose(-1, -2)  # (B, F, N)
    sin_sel = _f32(sin_m, dev).T[idx].transpose(-1, -2)
    b, f, n = cos_sel.shape
    k = w.shape[-1]
    w = w.to(torch.float32)
    cw = (cos_sel[..., None] * w[..., None, :]).reshape(b, f, n * k)
    sw = (sin_sel[..., None] * w[..., None, :]).reshape(b, f, n * k)
    fp = coh_re.shape[-1]
    if fp != f:
        cw = torch.nn.functional.pad(cw, (0, 0, 0, fp - f))
        sw = torch.nn.functional.pad(sw, (0, 0, 0, fp - f))
    flat = coh_re.to(torch.float32) @ cw + coh_im.to(torch.float32) @ sw
    scores = flat.reshape(*coh_re.shape[:-1], n, k)  # (B, T, N, K)
    return torch.argmax(_nan_to_neginf(scores), dim=-2).to(torch.int32)


def hard_coefficient_masks(scores: torch.Tensor) -> torch.Tensor:
    """Binary one-hot masks over the leading target axis, NaN-tolerant like
    the reference's ``nanargmax`` (gccNMFFunctions.py:138)."""
    winner = torch.argmax(_nan_to_neginf(scores), dim=0)
    return winner_one_hot(winner, scores.shape[0]).to(scores.dtype)


def winner_one_hot(winner: torch.Tensor, num_targets: int) -> torch.Tensor:
    """``(..., T, K)`` winner indexes → ``(N, ..., T, K)`` float32 one-hot
    over a new leading target axis."""
    oh = torch.nn.functional.one_hot(winner.long(), num_targets)
    return oh.movedim(-1, 0).to(torch.float32)


def masked_reconstruction(masks, spec, w, h_stereo) -> torch.Tensor:
    """Per-target complex spectrogram estimates ``(N, 2, T, F)``.

    ``masks``: (N, T, K) shared across channels; ``spec``: (2, T, F);
    ``h_stereo``: (2, T, K). Magnitudes ``(H ⊙ mask) Wᵀ`` carry the mixture
    phase ``exp(i·angle(X))``, which is 1 where X == 0
    (reference gccNMFFunctions.py:145-151)."""
    masked_h = h_stereo[None] * masks[:, None]  # (N, 2, T, K)
    mags = masked_h @ w.transpose(-1, -2)
    phase = torch.polar(torch.ones_like(spec.real), torch.angle(spec))
    return mags.to(torch.complex64) * phase[None]


def fold_steering_dictionary(cos_m, sin_m, w) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold steering ⊗ dictionary into flat ``(F, D·K)`` GEMM operands, so
    the score ``s[t,d,k] = Σ_f (Re c·cos_d + Im c·sin_d)[t,f]·W[f,k]`` is two
    flat GEMMs against them."""
    w = torch.as_tensor(w, dtype=torch.float32)
    cos_m, sin_m = _f32(cos_m, w.device), _f32(sin_m, w.device)
    f, d = cos_m.shape
    k = w.shape[-1]
    cos_w = (cos_m[:, :, None] * w[:, None, :]).reshape(f, d * k)
    sin_w = (sin_m[:, :, None] * w[:, None, :]).reshape(f, d * k)
    return cos_w, sin_w


def argmax_tdoa(coh_re, coh_im, cos_w, sin_w, num_tdoas: int) -> torch.Tensor:
    """Per-(frame, atom) argmax-TDOA ``(..., T, K)`` int32 from coherence
    planes ``(..., T, F)`` (f32 or bf16) and the folded operands of
    :func:`fold_steering_dictionary`. NaN scores are −inf before the argmax,
    so they never win; an all-NaN column gives TDOA 0."""
    flat = coh_re.to(torch.float32) @ cos_w + coh_im.to(torch.float32) @ sin_w
    scores = flat.reshape(*coh_re.shape[:-1], num_tdoas, -1)
    return torch.argmax(_nan_to_neginf(scores), dim=-2).to(torch.int32)


def soft_tdoa_coefficient_mask(argmax_tdoa, target_tdoa_index, epsilon, beta,
                               noise_floor) -> torch.Tensor:
    """Generalized-Gaussian soft mask over the argmax-TDOA distance,
    ``exp(-(|d - target|/ε)^β) / (1 + floor) + floor`` (reference
    TARGET_MODE_WINDOW_FUNCTION, gccNMFProcessor.py:265). Like the JAX
    function it takes ``0**β`` literally (``0**0 = 1``); the fused kernel
    pins distance 0 to a mask of 1 instead (``ops/enhance_cuda.py``)."""
    dist = torch.abs(argmax_tdoa.to(torch.float32) - target_tdoa_index)
    return torch.exp(-((dist / epsilon) ** beta)) / (1.0 + noise_floor) + noise_floor


def boxcar_tdoa_coefficient_mask(argmax_tdoa, target_tdoa_index, epsilon) -> torch.Tensor:
    """Hard boxcar mask: 1 within ε of the target TDOA index, else 0
    (reference TARGET_MODE_BOXCAR, gccNMFProcessor.py:263)."""
    dist = torch.abs(argmax_tdoa.to(torch.float32) - target_tdoa_index)
    return torch.where(dist < epsilon, 1.0, 0.0).to(torch.float32)


def wiener_tf_mask(w, h_mask) -> torch.Tensor:
    """Wiener-style TF mask ``(..., T, F)`` from a coefficient mask
    ``(..., T, K)``: ``(h_mask Wᵀ) / Σ_k W[f,k]`` (reference
    gccNMFProcessor.py:267-269)."""
    return (h_mask @ w.transpose(-1, -2)) / w.sum(dim=-1)


def wiener_tf_mask_h(w, h, h_mask, epsilon: float = 1e-16) -> torch.Tensor:
    """H-aware Wiener mask ``W·(H⊙mask) / (W·H + ε)``: the coefficient
    energies that :func:`wiener_tf_mask` replaces with a flat prior."""
    wt = w.transpose(-1, -2)
    return ((h * h_mask) @ wt) / ((h @ wt) + epsilon)
