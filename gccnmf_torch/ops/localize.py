"""TDOA localization: peak picking (counterpart of
``gccnmf_tpu/ops/localize.py``).

The tensor parts (local-maxima mask, top-k peak selection, the 2-means
source count of :func:`auto_count_targets`) are fixed-shape and run on the
device; the host path (:func:`estimate_target_tdoa_indexes`, with 2-means
source counting) runs in NumPy on a length-``num_tdoas`` vector.

Reference: gccNMFFunctions.estimateTargetTDOAIndexesFromAngularSpectrum
(gccNMFFunctions.py:94-116).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "local_maxima_mask",
    "top_k_peaks",
    "peak_count",
    "auto_count_targets",
    "estimate_target_tdoa_indexes",
    "sliding_argmax_tdoa",
]


def local_maxima_mask(a: torch.Tensor) -> torch.Tensor:
    """Boolean mask of strict interior local maxima along the last axis
    (scipy.signal.argrelmax(order=1) on interior points; endpoints are
    never maxima)."""
    mid = a[..., 1:-1]
    mask = (mid > a[..., :-2]) & (mid > a[..., 2:])
    pad = torch.zeros_like(a[..., :1], dtype=torch.bool)
    return torch.cat([pad, mask, pad], dim=-1)


def top_k_peaks(a: torch.Tensor, k: int) -> torch.Tensor:
    """Indexes of the ``k`` highest local maxima, sorted ascending (the
    reference's sorted() at gccNMFFunctions.py:113).

    Equal heights pick the lower index first, as ``jax.lax.top_k`` does: a
    stable descending sort, since ``torch.topk`` promises no order among
    ties. If fewer than ``k`` peaks exist, the missing slots repeat the
    global argmax (see :func:`peak_count` to detect the shortfall)."""
    heights = torch.where(local_maxima_mask(a), a, -torch.inf)
    vals, idx = torch.sort(heights, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    best = torch.argmax(a, dim=-1, keepdim=True).to(idx.dtype)
    idx = torch.where(torch.isneginf(vals), best, idx)
    return torch.sort(idx, dim=-1).values.to(torch.int32)


def peak_count(a: torch.Tensor) -> torch.Tensor:
    """Number of interior local maxima along the last axis (int32)."""
    return local_maxima_mask(a).sum(dim=-1).to(torch.int32)


def auto_count_targets(
    a: torch.Tensor, max_sources: int, num_iterations: int = 50
) -> tuple[torch.Tensor, torch.Tensor]:
    """Source counting on the device: a fixed-iteration 2-means over the
    heights of the interior local maxima (the tensor counterpart of the
    host path's 2-means).

    ``a``: angular spectrum ``(..., D)``. Returns ``(targets (...,
    max_sources) int32, counts (...,) int32)``: the high cluster's size,
    clamped to ``[1, max_sources]``, and that many highest peaks sorted
    left-to-right in positions ``[0, count)``; the other slots repeat the
    dominant peak, whose duplicated score column loses every argmax to the
    first, so those estimates are silent. A row without a peak counts 1 and
    targets its global argmax."""
    mask = local_maxima_mask(a)
    heights = torch.where(mask, a, -torch.inf)
    # the highest peaks, the lower index first among equal heights, as
    # jax.lax.top_k picks them (top_k_peaks)
    vals, idx = torch.sort(heights, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :max_sources], idx[..., :max_sources]
    best = torch.argmax(a, dim=-1, keepdim=True).to(idx.dtype)  # the first maximum
    idx = torch.where(torch.isneginf(vals), best, idx)

    # masked 1-D Lloyd's, 2 clusters, centres initialised at (min, max) peak
    w = mask.to(a.dtype)
    has_peak = mask.any(dim=-1)
    fallback = a.max(dim=-1).values  # peakless rows: both centres there, count 1
    c0 = torch.where(has_peak, torch.where(mask, a, torch.inf).min(dim=-1).values, fallback)
    c1 = torch.where(has_peak, heights.max(dim=-1).values, fallback)
    for _ in range(num_iterations):
        in_hi = ((a - c0[..., None]).abs() > (a - c1[..., None]).abs()).to(a.dtype)
        w1, w0 = w * in_hi, w * (1.0 - in_hi)
        n0, n1 = w0.sum(dim=-1), w1.sum(dim=-1)
        c0 = torch.where(n0 > 0, (w0 * a).sum(dim=-1) / n0.clamp(min=1.0), c0)
        c1 = torch.where(n1 > 0, (w1 * a).sum(dim=-1) / n1.clamp(min=1.0), c1)
    hi, lo = torch.maximum(c0, c1), torch.minimum(c0, c1)
    in_hi = mask & ((a - lo[..., None]).abs() > (a - hi[..., None]).abs())
    counts = in_hi.sum(dim=-1).clamp(1, max_sources).to(torch.int32)

    keep = torch.arange(max_sources, device=a.device) < counts[..., None]
    sentinel = a.shape[-1] + 1  # sorts after every real index
    sorted_idx = torch.sort(torch.where(keep, idx, sentinel), dim=-1).values
    targets = torch.where(keep, sorted_idx, idx[..., :1]).to(torch.int32)
    return targets, counts


def _two_means_1d(values: np.ndarray, num_iterations: int = 50):
    """Lloyd's algorithm, 2 clusters, 1-D. Returns (labels, centers)."""
    lo, hi = float(values.min()), float(values.max())
    centers = np.array([lo, hi])
    labels = np.zeros(len(values), np.int32)
    for _ in range(num_iterations):
        labels = (np.abs(values - centers[0]) > np.abs(values - centers[1])).astype(
            np.int32
        )
        new_centers = centers.copy()
        for c in (0, 1):
            sel = values[labels == c]
            if sel.size:
                new_centers[c] = sel.mean()
        if np.allclose(new_centers, centers):
            break
        centers = new_centers
    return labels, centers


def estimate_target_tdoa_indexes(
    mean_angular_spectrum: np.ndarray, num_sources: int | None = None
) -> list[int]:
    """Pick target TDOA indexes from a time-averaged angular spectrum.

    With ``num_sources`` given: the N highest interior local maxima
    (raises if fewer exist — the reference's equivalent path aborts,
    gccNMFFunctions.py:102-104). With ``num_sources=None``: 2-means
    clustering on peak heights, keep the high cluster. Returns indexes
    sorted left-to-right.
    """
    a = np.asarray(mean_angular_spectrum)
    mask = np.zeros(len(a), bool)
    mask[1:-1] = (a[1:-1] > a[:-2]) & (a[1:-1] > a[2:])
    peak_idx = np.nonzero(mask)[0]

    if num_sources:
        if len(peak_idx) < num_sources:
            raise ValueError(
                f"found only {len(peak_idx)} angular-spectrum peaks, "
                f"need {num_sources}"
            )
        chosen = peak_idx[np.argsort(a[peak_idx])[-num_sources:]]
    else:
        if len(peak_idx) == 0:
            raise ValueError("no angular-spectrum peaks found")
        labels, centers = _two_means_1d(a[peak_idx].astype(np.float64))
        chosen = peak_idx[labels == int(np.argmax(centers))]
    return sorted(int(i) for i in chosen)


def sliding_argmax_tdoa(gcc_phat_history: torch.Tensor, window: int) -> torch.Tensor:
    """Streaming localization: the argmax over the mean of the last
    ``window`` frames of a GCC-PHAT history ``(..., T_hist, D)``
    (reference: gccNMF/realtime/gccNMFProcessor.py:220-226). The first
    maximum wins, as in ``jnp.argmax``."""
    recent = gcc_phat_history[..., -window:, :]
    return torch.argmax(recent.mean(dim=-2), dim=-1)
