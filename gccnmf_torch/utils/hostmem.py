"""Host-memory hygiene for long-lived processes (counterpart of
``gccnmf_tpu/utils/hostmem.py``).

A loop that streams many chunks through the card allocates and frees host
buffers per chunk: NumPy inputs and outputs, pinned staging blocks, writer
queues. glibc's allocator may keep freed ``[heap]`` chunks instead of
returning them to the kernel, so the resident set of an hour-long run can
creep up from fragmentation alone. This module bounds that and makes it
visible:

- :func:`trim_host_heap` / :class:`PeriodicTrim`: ``malloc_trim(0)`` for the
  loop's own allocator churn, fired every 256 MB of accounted traffic
  (``GCCNMFSeparator.separate_batches`` accounts each chunk's input bytes,
  and its output bytes where they are copied into pageable memory);
- :func:`rss_anon_mib` / :class:`HostMemWatchdog`: a cheap, rate-limited
  reading of the process's anonymous resident set against a budget, for
  long-lived streaming and serving processes to report in their health
  lines (recycling the worker process is the remedy past the budget).

None of this touches memory that CUDA or PyTorch's caching host
allocator holds (pinned blocks are cached for reuse by design).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import time

from gccnmf_torch import profiling

__all__ = ["trim_host_heap", "PeriodicTrim", "rss_anon_mib", "HostMemWatchdog"]

_libc = None
_trim_available: bool | None = None


def _load() -> bool:
    global _libc, _trim_available
    if _trim_available is not None:
        return _trim_available
    try:
        path = ctypes.util.find_library("c")
        lib = ctypes.CDLL(path) if path else ctypes.CDLL(None)
        lib.malloc_trim.restype = ctypes.c_int
        lib.malloc_trim.argtypes = [ctypes.c_size_t]
        _libc = lib
        _trim_available = True
    except (OSError, AttributeError):  # no libc, or a libc without malloc_trim
        _trim_available = False
    return _trim_available


def trim_host_heap() -> bool:
    """Return freed glibc heap chunks to the kernel (``malloc_trim(0)``).

    True when the call was made (glibc present), False on platforms without
    ``malloc_trim``; never raises."""
    if not _load():
        return False
    _libc.malloc_trim(0)
    return True


class PeriodicTrim:
    """Trim the host heap every ``every_bytes`` of accounted traffic.

    A chunked loop calls :meth:`account` with each chunk's host byte count;
    the trim fires at the threshold, in a ``gccnmf.hostmem.trim`` span, and
    the counter resets."""

    def __init__(self, every_bytes: int = 256 * 1024 * 1024):
        self.every_bytes = int(every_bytes)
        self._since = 0
        self.trims = 0  # how many trims fired

    def account(self, nbytes: int) -> bool:
        """Add ``nbytes`` of traffic; trim if the threshold is crossed.
        Returns True when a trim fired."""
        self._since += int(nbytes)
        if self._since < self.every_bytes:
            return False
        self._since = 0
        with profiling.annotate("gccnmf.hostmem.trim"):
            trimmed = trim_host_heap()
        if trimmed:
            self.trims += 1
        return trimmed


def rss_anon_mib() -> float:
    """This process's anonymous resident set in MiB (0.0 off Linux)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("RssAnon:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


class HostMemWatchdog:
    """Budgeted RssAnon monitor for long-lived processes.

    :meth:`check` samples RssAnon (at most once per ``min_interval_s``; the
    ``/proc`` read takes microseconds) and reports it against the budget,
    so a streaming or serving process can say in its telemetry when it is
    time to recycle the worker."""

    def __init__(self, budget_mib: float = 6144.0, min_interval_s: float = 10.0,
                 _now=None, _sample=None):
        self.budget_mib = float(budget_mib)
        self.min_interval_s = float(min_interval_s)
        self._now = _now or time.monotonic
        self._sample = _sample or rss_anon_mib
        self._last_t = -float("inf")
        self._last: dict = {"anon_mib": 0.0, "budget_mib": self.budget_mib, "exceeded": False}
        self.baseline_mib = self._sample()

    def check(self) -> dict:
        """Latest ``{anon_mib, budget_mib, exceeded}`` (rate-limited)."""
        now = self._now()
        if now - self._last_t >= self.min_interval_s:
            self._last_t = now
            anon = self._sample()
            self._last = {"anon_mib": round(anon, 1), "budget_mib": self.budget_mib,
                          "exceeded": bool(anon > self.budget_mib)}
        return self._last
