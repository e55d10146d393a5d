"""What the metric readers of ``metrics/`` take from a run record, one
function each; a reader file names its metric's unit, layer and the
end-to-end metric it moves, and calls one of these. Each returns None when
the record holds nothing to read."""

from __future__ import annotations

from harness.common import quantile
from harness.roofline import bound, span_share


def audio_s_per_s(rec):
    """The audio of the chunks completed in the window over its length."""
    off = rec.get("offline")
    if not off or off["window_s"] <= 0:
        return None
    return off["audio_s"] / off["window_s"]


def roofline(span: str):
    """A kernel's roofline share (%) over the calls in its span."""
    return lambda rec: span_share(rec, span)


def step_mfu(rec):
    """The least time of all the traced chunks' kernel work, each call
    against its own roofline, over the traced window's wall time (%)."""
    tr = rec.get("trace")
    if not tr or not tr.get("calls") or tr["window_s"] <= 0:
        return None
    least_ms = sum(bound(f, b, m)[0] for calls in tr["calls"].values() for f, b, m in calls)
    return 100.0 * least_ms / (tr["window_s"] * 1e3) if least_ms > 0 else None


def other_device_ms_per_chunk(rec):
    """Device ms a chunk of everything launched outside the kernel spans."""
    tr = rec.get("trace")
    if not tr or not tr.get("steps") or "calls" not in tr:
        return None
    return 1e3 * tr["device_s_outside_spans"] / tr["steps"]


def launches_per_chunk(rec):
    """Device kernels launched a chunk, counted in the trace."""
    tr = rec.get("trace")
    if not tr or not tr.get("steps") or "calls" not in tr:
        return None
    return tr["kernels"] / tr["steps"]


def idle_pct(section: str):
    """Share (%) of the traced window in which no kernel or copy ran, for
    records of ``section`` (``offline`` or ``serve``)."""
    def read(rec):
        tr = rec.get("trace")
        if not tr or section not in rec or tr["window_s"] <= 0:
            return None
        return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
    return read


def chunk_p95_ms(rec):
    """p95 of the wall time between successive chunks of the window."""
    off = rec.get("offline")
    if not off or not off["chunk_gaps_s"]:
        return None
    return 1e3 * quantile(off["chunk_gaps_s"], 0.95)
