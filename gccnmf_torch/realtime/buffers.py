"""History ring buffers for telemetry and visualization (counterpart of
``gccnmf_tpu/realtime/buffers.py``).

The reference shares telemetry between its DSP process and GUI through
lock-free ``multiprocessing.Array`` circular buffers
(reference: gccNMF/realtime/utils.py:34-70, SharedMemoryCircularBuffer).
Here everything runs in one process, so a plain NumPy ring buffer with the
same interface (``set``/``get``/``get_unraveled``) suffices; reads are
tolerant of concurrent writes by design, exactly like the reference's GUI
reads (visual tearing is acceptable, synchronization is not required).
"""

from __future__ import annotations

import numpy as np

__all__ = ["CircularBuffer"]


class CircularBuffer:
    """Fixed-capacity ring of ``(size, *item_shape)`` float32 values.

    ``set(values)`` appends one or more items; ``get(n)`` returns the last
    ``n`` items oldest-first; ``get_unraveled()`` returns the whole history
    oldest-first (zeros where nothing has been written yet) — the layout the
    reference GUI uses for waterfall images (utils.py:66-70).
    """

    def __init__(self, item_shape: tuple[int, ...] | int, size: int):
        if isinstance(item_shape, int):
            item_shape = (item_shape,)
        self._values = np.zeros((size,) + tuple(item_shape), np.float32)
        self._size = size
        self._index = 0  # next write position
        self._count = 0  # total items ever written (saturates at size)

    @property
    def size(self) -> int:
        return self._size

    @property
    def num_values(self) -> int:
        """Items currently held (≤ size)."""
        return min(self._count, self._size)

    def set(self, values: np.ndarray) -> None:
        """Append one item (matching item_shape) or a leading-axis batch."""
        values = np.asarray(values, np.float32)
        if values.shape == self._values.shape[1:]:
            values = values[None]
        n = values.shape[0]
        if n >= self._size:
            self._values[:] = values[-self._size :]
            self._index = 0
            self._count += n
            return
        end = self._index + n
        if end <= self._size:
            self._values[self._index : end] = values
        else:
            first = self._size - self._index
            self._values[self._index :] = values[:first]
            self._values[: end - self._size] = values[first:]
        self._index = end % self._size
        self._count += n

    def get(self, n: int | None = None) -> np.ndarray:
        """Last ``n`` items (default: all held), oldest-first."""
        available = self.num_values
        n = available if n is None else min(n, available)
        idx = (self._index - n + np.arange(n)) % self._size
        return self._values[idx]

    def get_unraveled(self) -> np.ndarray:
        """Full buffer oldest-first (including never-written zeros)."""
        idx = (self._index + np.arange(self._size)) % self._size
        return self._values[idx]
