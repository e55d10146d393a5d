"""Profiling and per-stage timing utilities (counterpart of
``gccnmf_tpu/profiling.py``).

The reference's only telemetry is ad-hoc wall-clock logging of per-block
processing times (reference: gccNMF/realtime/audioProcessor.py:98-102,130;
a richer logProcessingTimes at :162-181 is dead code). Here it is two
layers:

- :func:`trace` — a context manager around ``torch.profiler`` that writes a
  Chrome/Perfetto trace (host ops, CUDA kernels and copies when a card is
  present) into a directory;
- :class:`StageTimer` — host-side wall-clock stage timing, fenced with
  :func:`block_all`, for benchmark harnesses and pipeline stage breakdowns
  (first-call capture vs steady state).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = ["trace", "annotate", "StageTimer", "block_all"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block into ``log_dir/trace.json`` (``torch.profiler``;
    CUDA activity too when a card is present).

    View it in Perfetto or ``chrome://tracing``. Wrap steady-state
    iterations only (a first call's graph capture drowns the timeline).
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


def annotate(name: str):
    """Named host annotation visible in profiler traces
    (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):  # NamedTuples too
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def block_all(tree) -> None:
    """Wait for every card that holds a tensor of a pytree (dicts, lists,
    tuples) to finish its queued work (timing fence); other leaves are
    ignored."""
    devices = {leaf.device for leaf in _leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


@dataclass
class StageTimer:
    """Accumulates named stage durations; prints a breakdown.

    >>> timer = StageTimer()
    >>> with timer.stage("stft"):
    ...     out = stft(...); block_all(out)
    >>> timer.summary()
    """

    stages: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> dict:
        out = {}
        for name, times in self.stages.items():
            t = np.asarray(times)
            out[name] = dict(
                calls=len(t),
                total_s=round(float(t.sum()), 4),
                mean_ms=round(float(t.mean() * 1e3), 3),
                p50_ms=round(float(np.percentile(t, 50) * 1e3), 3),
                max_ms=round(float(t.max() * 1e3), 3),
            )
        return out

    def log_summary(self) -> None:
        logger.info("stage timing: %s", json.dumps(self.summary()))
