"""Headless view-model for the realtime GUI's mask-function editor
(counterpart of ``gccnmf_tpu/gui_model.py``).

The reference GUI's signature interaction is a draggable target-TDOA
region drawn over the live mean-GCC-PHAT plot with a generalized-Gaussian
window-function curve on top (reference:
gccNMF/realtime/gccNMFInterface.py:256-274 ``initMaskFunctionPlot``,
:534-578 ``TargetWindowFunctionPlot``, :531-532 ``generalizedGaussian``).
Four 0-100 sliders map to the mask parameters (μ, α, β, floor); the
region mirrors (μ ± α). In the reference the coupling is one-way (a
region drag merely re-sends slider-derived params,
``tdoaRegionChanged`` at :469-477); here the binding is genuinely
two-way: dragging the region edits center/width, moving the sliders
moves the region.

Everything in this module is pure NumPy — no Tk, no matplotlib — so the
widget logic is unit-testable without a display. The rendering shells
(:mod:`gccnmf_torch.gui`) consume it.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "generalized_gaussian",
    "target_window_curve",
    "MaskEditorModel",
    "visualized_dictionary",
    "normalized_mean_gcc",
]


def generalized_gaussian(
    x: np.ndarray, alpha: float, beta: float, mu: float
) -> np.ndarray:
    """``exp(-(|x-mu|/alpha)^beta)`` (reference gccNMFInterface.py:531-532)."""
    return np.exp(-((np.abs(np.asarray(x, np.float64) - mu) / alpha) ** beta))


def target_window_curve(
    num_tdoas: int, mu: float, alpha: float, beta: float, noise_floor: float
) -> np.ndarray:
    """The displayed window-function curve over the TDOA grid.

    Normalization follows the reference exactly: subtract the min, scale the
    max to 1, then compress into ``[noise_floor, 1]``
    (reference TargetWindowFunctionPlot.updateData, gccNMFInterface.py:550-558).
    """
    tdoas = np.arange(num_tdoas, dtype=np.float64)
    data = generalized_gaussian(tdoas, alpha, beta, mu)
    data = data - data.min()
    peak = data.max()
    if peak > 0.0:
        data = data / peak
    return (data * (1.0 - noise_floor) + noise_floor).astype(np.float32)


class MaskEditorModel:
    """Slider fractions ↔ mask parameters ↔ TDOA region, with clamping.

    Slider state is stored as fractions in ``[0, 1]`` (the reference uses
    0-100 integer Qt sliders and divides by 100; fractions are the same
    thing without the quantization). The value mappings reproduce the
    reference's ``TargetWindowFunctionPlot`` getters exactly
    (gccNMFInterface.py:560-577):

    - center:  ``tdoa = frac * num_tdoas``
    - width:   ``alpha = frac * num_tdoas``
    - shape:   ``beta = exp(frac * 10 - 5)``
    - floor:   ``noise_floor = frac``
    """

    #: smallest usable window half-width (α=0 divides by zero in the mask)
    MIN_WIDTH = 1e-2

    def __init__(
        self,
        num_tdoas: int,
        center_frac: float = 0.5,
        width_frac: float = 0.5,
        shape_frac: float = 0.5,
        floor_frac: float = 0.0,
    ):
        self.num_tdoas = int(num_tdoas)
        self.center_frac = float(np.clip(center_frac, 0.0, 1.0))
        self.width_frac = float(np.clip(width_frac, 0.0, 1.0))
        self.shape_frac = float(np.clip(shape_frac, 0.0, 1.0))
        self.floor_frac = float(np.clip(floor_frac, 0.0, 1.0))

    # ------------------------------------------------- fraction → parameter

    @property
    def tdoa(self) -> float:
        """Window center μ in TDOA-index units (reference getTDOA, :575-577)."""
        return self.center_frac * self.num_tdoas

    @property
    def window_width(self) -> float:
        """Half-width α in TDOA-index units (reference getWindowWidth, :571-573)."""
        return max(self.width_frac * self.num_tdoas, self.MIN_WIDTH)

    @property
    def beta(self) -> float:
        """Shape exponent β = exp(10·frac − 5) (reference getBeta, :561-566)."""
        return float(np.exp(self.shape_frac * 10.0 - 5.0))

    @property
    def noise_floor(self) -> float:
        """Mask floor in [0, 1] (reference getNoiseFloor, :568-569)."""
        return self.floor_frac

    # ------------------------------------------------- parameter → fraction

    def set_tdoa(self, mu: float) -> None:
        self.center_frac = float(np.clip(mu / self.num_tdoas, 0.0, 1.0))

    def set_window_width(self, alpha: float) -> None:
        self.width_frac = float(np.clip(alpha / self.num_tdoas, 0.0, 1.0))

    def set_beta(self, beta: float) -> None:
        self.shape_frac = float(
            np.clip((np.log(max(beta, 1e-12)) + 5.0) / 10.0, 0.0, 1.0)
        )

    def set_noise_floor(self, floor: float) -> None:
        self.floor_frac = float(np.clip(floor, 0.0, 1.0))

    # ----------------------------------------------------------- region view

    @property
    def region(self) -> tuple[float, float]:
        """(lo, hi) = μ ± α clipped to the grid — the draggable span, matching
        the reference's LinearRegionItem bounds (gccNMFInterface.py:268-269)."""
        lo = float(np.clip(self.tdoa - self.window_width, 0.0, self.num_tdoas - 1))
        hi = float(np.clip(self.tdoa + self.window_width, 0.0, self.num_tdoas - 1))
        return lo, hi

    def set_region(self, lo: float, hi: float) -> None:
        """Region drag → center/width (the two-way half the reference lacks)."""
        lo, hi = sorted(
            (
                float(np.clip(lo, 0.0, self.num_tdoas - 1)),
                float(np.clip(hi, 0.0, self.num_tdoas - 1)),
            )
        )
        self.set_tdoa((lo + hi) / 2.0)
        self.set_window_width(max((hi - lo) / 2.0, self.MIN_WIDTH))

    def shift_region(self, delta: float) -> None:
        """Drag the whole region by ``delta`` TDOA indexes (width preserved,
        center clamped so the span stays on the grid)."""
        width = self.window_width
        max_center = self.num_tdoas - 1.0
        self.set_tdoa(float(np.clip(self.tdoa + delta, 0.0, max_center)))
        self.set_window_width(width)

    # -------------------------------------------------------------- products

    def curve(self) -> np.ndarray:
        """The window-function curve to draw over the mean GCC-PHAT plot."""
        return target_window_curve(
            self.num_tdoas, self.tdoa, self.window_width, self.beta, self.noise_floor
        )

    def stream_params(self) -> dict:
        """kwargs for :meth:`RealtimeGCCNMF.set_target_window` — the hot
        no-recompile control path (the analogue of the reference's
        tdoaRegionChanged queue message, gccNMFInterface.py:469-477)."""
        return dict(
            target_tdoa_index=self.tdoa,
            epsilon=self.window_width,
            beta=self.beta,
            noise_floor=self.noise_floor,
        )


def visualized_dictionary(w: np.ndarray) -> np.ndarray:
    """Dictionary image the way the reference displays it: atoms ordered by
    spectral centroid, max-normalized, cube-root compressed, inverted
    (reference getVisualizedDictionariesW gccNMFInterface.py:580-591 +
    getOrderedDictionary gccNMFPretraining.py:60-66)."""
    from gccnmf_torch.ops.nmf import order_atoms_by_centroid

    v = np.asarray(w, np.float64)
    v = order_atoms_by_centroid(v)
    peak = v.max()
    if peak > 0:
        v = v / peak
    v = v ** (1.0 / 3.0)
    return (1.0 - v).astype(np.float32)


def normalized_mean_gcc(gcc_history: np.ndarray) -> np.ndarray | None:
    """Min-max-normalized mean GCC-PHAT curve over a history window — the
    black live curve under the editor (reference updateGCCPHATPlot,
    gccNMFInterface.py:385-390). Returns None when the history is empty or
    flat (nothing meaningful to draw)."""
    g = np.asarray(gcc_history, np.float64)
    if g.size == 0:
        return None
    curve = g.mean(axis=0)
    curve = curve - curve.min()
    peak = curve.max()
    if peak <= 0.0:
        return None
    return (curve / peak).astype(np.float32)
