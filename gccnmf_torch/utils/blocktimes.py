"""Rolling per-block durations (counterpart of the NumPy path of
``gccnmf_tpu/native/runtime.py`` ``BlockTimes``; reference:
gccNMF/realtime/audioProcessor.py:98-102).

The server's tick and delivery statistics record into one of these from the
tick thread and read percentiles from a snapshot of the held window.
"""

from __future__ import annotations

import numpy as np

__all__ = ["BlockTimes"]


class BlockTimes:
    """A ring of the last ``capacity`` durations: ``record()`` from the hot
    loop, ``stats()`` → (min, max, mean, count) from anywhere (tearing
    tolerated)."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._values = np.zeros(capacity, np.float64)
        self._count = 0

    def record(self, seconds: float) -> None:
        self._values[self._count % self.capacity] = seconds
        self._count += 1

    def stats(self) -> tuple[float, float, float, int]:
        held = min(self._count, self.capacity)
        if held == 0:
            return 0.0, 0.0, 0.0, 0
        v = self._values[:held]
        return float(v.min()), float(v.max()), float(v.mean()), held

    def snapshot(self) -> np.ndarray:
        """Copy of the held window (unordered): the raw samples behind
        ``stats()``, for host-side percentile math."""
        held = min(self._count, self.capacity)
        return self._values[:held].copy()

    def percentiles(self, qs=(50.0, 99.0)) -> tuple[float, ...]:
        """Window percentiles in the recorded unit; zeros when empty."""
        window = self.snapshot()
        if window.size == 0:
            return tuple(0.0 for _ in qs)
        return tuple(float(np.percentile(window, q)) for q in qs)
