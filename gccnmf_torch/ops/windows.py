"""Analysis/synthesis windows (counterpart of ``gccnmf_tpu/ops/windows.py``).

Built host-side with NumPy and returned as float32; the offline pipeline
uses the NumPy-style symmetric Hann for analysis and synthesis
(reference: gccNMF/gccNMFFunctions.py:65, 155).
"""

from __future__ import annotations

import numpy as np

__all__ = ["hann_symmetric"]


def hann_symmetric(length: int) -> np.ndarray:
    """NumPy-convention symmetric Hann window (zero endpoints)."""
    if length == 1:
        return np.ones(1, np.float32)
    n = np.arange(length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / (length - 1))).astype(np.float32)
