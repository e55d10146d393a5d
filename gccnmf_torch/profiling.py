"""Profiler traces and program spans (counterpart of
``gccnmf_tpu/profiling.py``).

The reference's only telemetry is ad-hoc wall-clock logging of per-block
processing times (reference: gccNMF/realtime/audioProcessor.py:98-102,130;
a richer logProcessingTimes at :162-181 is dead code). Here it is two
pieces:

- :func:`trace` — a context manager around ``torch.profiler`` that writes a
  Chrome/Perfetto trace (host ops, CUDA kernels and copies when a card is
  present) into a directory;
- :func:`annotate` — a named host span (``record_function``) that lands in
  such a trace on the same clock as the device's kernels, so each idle
  interval of the card can be laid beside what the host thread was inside.
  With no profiler running it costs one flag read.

The program's spans are opened through :func:`annotate` under fixed names
(no per-call suffix), all on the thread that calls the program, none open
across a ``yield``. Each is listed with its parent and the reader
(``portbench/metrics/``, run by ``portbench/tools/program_spans.py``) that
it is for:

- the stages of ``models/offline.py``'s ``pipelined``, under the prefix
  ``gccnmf.offline`` in ``GCCNMFSeparator.separate_batches`` and
  ``gccnmf.enhance`` in ``GCCNMFEnhancer.enhance_batches``; named here
  under the first: ``gccnmf.offline.upload`` (scaling, pinned staging,
  the H2D enqueue), ``gccnmf.offline.compute`` (the host time to enqueue
  a chunk's device work: ``offline.enqueue_ms_per_chunk``),
  ``gccnmf.offline.download`` (the D2H enqueue) and
  ``gccnmf.offline.materialize`` (its self time:
  ``offline.materialize_ms_per_chunk``) with the children
  ``gccnmf.offline.wait`` (the download's event, on the card only) and
  ``gccnmf.offline.copy_out`` (the estimates copied into pageable memory
  because the page-locked ones the caller holds fill their budget; read by
  no metric: in a trace it shows when that fallback engages);
- ``gccnmf.hostmem.trim``: ``utils/hostmem.PeriodicTrim``'s
  ``malloc_trim`` when it fires, inside ``upload`` or ``materialize``.

``offline.idle_unattributed_pct`` reads them all: the share of the traced
window in which the card is idle and none of these spans is open. In the
enhancement cell ``enhance.enqueue_ms_per_chunk`` reads
``gccnmf.enhance.compute``.
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch
import torch.autograd.profiler as _autograd_profiler

logger = logging.getLogger(__name__)

__all__ = ["trace", "annotate"]

_OFF = contextlib.nullcontext()


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
    """A named host span in profiler traces (``record_function``) while a
    profiler runs; otherwise one shared no-op context, since
    ``record_function`` costs microseconds even when nothing records it."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)
