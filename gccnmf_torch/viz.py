"""Notebook and report plots (matplotlib, on the host; counterpart of
``gccnmf_tpu/viz.py``).

The reference's plotting module (gccNMF/gccNMFPlotting.py:33-282):
waveforms, cube-root compressed spectrograms, GCC-PHAT angular
spectrograms with their localized peaks, NMF dictionary and coefficient
decompositions, coefficient-mask grids, and the ``describe_*`` narration
printers of the tutorial notebooks.

Inputs are NumPy arrays or tensors on any device (copied to the host);
nothing here runs on the card. Spectrogram-like arrays are time-major,
``(T, F)`` / ``(T, D)``, and transposed for display so that frequency or
TDOA runs up the y-axis, as in the reference's figures. matplotlib is
imported at the first plot, never at import: the card's machine has none.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "plot_waveform",
    "plot_spectrogram",
    "plot_angular_spectrogram",
    "plot_localization",
    "plot_nmf_decomposition",
    "plot_coefficient_masks",
    "describe_mixture_signal",
    "describe_spectrogram",
    "describe_nmf",
]


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array-like as NumPy."""
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _compress(mag: np.ndarray, power: float = 1.0 / 3.0) -> np.ndarray:
    """Cube-root magnitude compression for display (reference
    gccNMFPlotting's ** (1/3) convention)."""
    return np.abs(_np(mag)) ** power


def plot_waveform(signal: np.ndarray, sample_rate: int, ax=None, title=None):
    """(C, n) or (n,) waveform vs seconds."""
    plt = _plt()
    ax = ax or plt.gca()
    signal = np.atleast_2d(_np(signal))
    t = np.arange(signal.shape[-1]) / sample_rate
    for c, chan in enumerate(signal):
        ax.plot(t, chan, linewidth=0.5, label=f"ch{c}")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("amplitude")
    if title:
        ax.set_title(title)
    if signal.shape[0] > 1:
        ax.legend(loc="upper right", fontsize="small")
    return ax


def plot_spectrogram(
    spec: np.ndarray, sample_rate: int, hop_size: int, ax=None, title=None
):
    """Magnitude spectrogram ``(T, F)`` (complex accepted), cube-root
    compressed, seconds × kHz axes."""
    plt = _plt()
    ax = ax or plt.gca()
    mag = _compress(spec).T  # display (F, T)
    t_max = mag.shape[1] * hop_size / sample_rate
    ax.imshow(
        mag,
        origin="lower",
        aspect="auto",
        extent=(0, t_max, 0, sample_rate / 2000.0),
        cmap="magma",
    )
    ax.set_xlabel("time (s)")
    ax.set_ylabel("frequency (kHz)")
    if title:
        ax.set_title(title)
    return ax


def plot_angular_spectrogram(
    angular: np.ndarray,
    sample_rate: int | None = None,
    hop_size: int | None = None,
    ax=None,
    title="GCC-PHAT angular spectrogram",
):
    """Angular spectrogram ``(T, D)`` as a TDOA-index × time image."""
    plt = _plt()
    ax = ax or plt.gca()
    a = _np(angular).T  # (D, T)
    t_max = (
        a.shape[1] * hop_size / sample_rate if sample_rate and hop_size else a.shape[1]
    )
    ax.imshow(
        a, origin="lower", aspect="auto", extent=(0, t_max, 0, a.shape[0]), cmap="magma"
    )
    ax.set_xlabel("time (s)" if sample_rate and hop_size else "frame")
    ax.set_ylabel("TDOA index")
    if title:
        ax.set_title(title)
    return ax


def plot_localization(
    mean_angular: np.ndarray, target_indexes=None, ax=None, title="GCC-PHAT localization"
):
    """Time-averaged angular spectrum ``(D,)`` with localized peaks marked
    (reference plotGCCPHATLocalization)."""
    plt = _plt()
    ax = ax or plt.gca()
    a = _np(mean_angular)
    ax.plot(a, linewidth=1.0)
    if target_indexes is not None:
        idx = _np(target_indexes).astype(int)
        ax.plot(idx, a[idx], "r^", markersize=8, label="targets")
        ax.legend(loc="upper right", fontsize="small")
    ax.set_xlabel("TDOA index")
    ax.set_ylabel("mean GCC-PHAT")
    if title:
        ax.set_title(title)
    return ax


def plot_nmf_decomposition(
    w: np.ndarray, h: np.ndarray, fig=None, title="NMF decomposition"
):
    """Dictionary ``W (F, K)`` next to coefficients ``H (T, K)``
    (reference plotNMFDecomposition), cube-root compressed."""
    plt = _plt()
    fig = fig or plt.figure(figsize=(10, 4))
    ax_w, ax_h = fig.subplots(1, 2, width_ratios=[1, 2])
    ax_w.imshow(_compress(w), origin="lower", aspect="auto", cmap="magma")
    ax_w.set_xlabel("atom")
    ax_w.set_ylabel("frequency bin")
    ax_w.set_title("W")
    ax_h.imshow(_compress(_np(h).T), origin="lower", aspect="auto", cmap="magma")
    ax_h.set_xlabel("frame")
    ax_h.set_ylabel("atom")
    ax_h.set_title("H")
    fig.suptitle(title)
    return fig


def plot_coefficient_masks(masks: np.ndarray, fig=None):
    """Per-target coefficient masks ``(num_targets, T, K)`` as a grid
    (reference's coefficient-mask figures)."""
    plt = _plt()
    masks = _np(masks)
    n = masks.shape[0]
    fig = fig or plt.figure(figsize=(8, 2.2 * n))
    axes = fig.subplots(n, 1, squeeze=False)[:, 0]
    for i, ax in enumerate(axes):
        ax.imshow(masks[i].T, origin="lower", aspect="auto", cmap="gray")
        ax.set_ylabel(f"target {i}\natom")
    axes[-1].set_xlabel("frame")
    fig.suptitle("coefficient masks")
    return fig


# ------------------------------------------------------------- describe_*


def describe_mixture_signal(signal: np.ndarray, sample_rate: int) -> str:
    """Narration printer (reference describeMixtureSignals)."""
    signal = np.atleast_2d(_np(signal))
    desc = (
        f"mixture: {signal.shape[0]} channels x {signal.shape[-1]} samples "
        f"({signal.shape[-1] / sample_rate:.2f} s @ {sample_rate} Hz), "
        f"peak {np.abs(signal).max():.3f}, rms {np.sqrt((signal ** 2).mean()):.4f}"
    )
    print(desc)
    return desc


def describe_spectrogram(spec: np.ndarray, window_size: int, hop_size: int) -> str:
    """Narration printer (reference describeMixtureSpectrograms)."""
    spec = _np(spec)
    desc = (
        f"spectrogram: {spec.shape[-2]} frames x {spec.shape[-1]} bins "
        f"(window {window_size}, hop {hop_size}), dtype {spec.dtype}"
    )
    print(desc)
    return desc


def describe_nmf(w: np.ndarray, h: np.ndarray) -> str:
    """Narration printer (reference describeNMFDecomposition)."""
    w, h = _np(w), _np(h)
    desc = (
        f"NMF: W {w.shape} (atoms unit-L2: "
        f"{np.allclose(np.linalg.norm(w, axis=0), 1.0, atol=1e-3)}), H {h.shape}"
    )
    print(desc)
    return desc
