"""The traced window: ``torch.profiler`` over a few steps, reduced to the
numbers the per-layer readers take.

The harness marks the window with a ``portbench.window`` span (its last
act a device synchronise, so the span's end is after the last device
operation) and wraps program calls in spans of its own
(``portbench.<name>``). A device operation belongs to the span inside
which the host launched it: its correlation id leads to the runtime call
(``cudaLaunchKernel``, ``cudaGraphLaunch``, …), and that call's time to
the span.
"""

from __future__ import annotations

import bisect
import contextlib
import json
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"


@contextlib.contextmanager
def span(name: str):
    """A harness span (``portbench.<name>``) in the trace; free when no
    profiler runs."""
    import torch

    with torch.profiler.record_function(f"portbench.{name}"):
        yield


def profile(out_path: Path):
    """A CPU and CUDA profiler that exports its trace to ``out_path`` when
    it stops."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(
        activities=acts, record_shapes=False, with_stack=False,
        on_trace_ready=lambda p: p.export_chrome_trace(str(out_path)))


def _union(intervals):
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _gaps(intervals, lo, hi):
    """Idle intervals of one device inside [lo, hi]."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def reduce(path: Path, span_names=()) -> dict:
    """The numbers of one traced window (times in seconds)."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"{path}: no {WINDOW} span")
    w = win[-1]
    lo, hi, host_tid = w["ts"], w["ts"] + w["dur"], w["tid"]

    dev = [e for e in events if e.get("cat") in DEVICE_CATS and lo <= e["ts"] <= hi]
    launch_ts = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len("portbench."):])
                   for e in events if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("portbench.") and e["name"] != WINDOW)
    starts = [s[0] for s in spans]

    def owner(ts):
        i = bisect.bisect_right(starts, ts) - 1
        while i >= 0:
            s, e, name = spans[i]
            if s <= ts <= e:
                return name
            if ts - s > 60e6:
                break
            i -= 1
        return None

    by_device = defaultdict(list)
    span_s = defaultdict(float)
    span_kernels = defaultdict(int)
    op_s = defaultdict(float)
    kernels = copies = 0
    for e in dev:
        s, d = e["ts"], e.get("dur", 0.0)
        by_device[e.get("args", {}).get("device", e.get("pid"))].append((s, min(s + d, hi)))
        launched = launch_ts.get(e.get("args", {}).get("correlation"))
        if launched is not None and launched < lo:
            continue  # launched before the window: busy time, but no step's work
        name = owner(-1.0 if launched is None else launched)
        key = name if name in span_names else None
        span_s[key] += d * 1e-6
        if e["cat"] == "kernel":
            kernels += 1
            span_kernels[key] += 1
        else:
            copies += 1
        op_s[e["name"]] += d * 1e-6
    busy = [_union(iv) * 1e-6 for iv in by_device.values()]

    # what the host was doing while the (first) device sat idle
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in events
                  if e.get("tid") == host_tid and e.get("name") != WINDOW
                  and e.get("cat") in ("cpu_op", "cuda_runtime", "user_annotation"))
    host_starts = [h[0] for h in host]
    gap_s = defaultdict(float)
    first = by_device[next(iter(by_device))] if by_device else []
    for gs, ge in _gaps(first, lo, hi):
        mid, label = 0.5 * (gs + ge), "host (no traced op)"
        i = bisect.bisect_right(host_starts, mid) - 1
        for j in range(i, max(i - 64, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        gap_s[label] += (ge - gs) * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return dict(
        window_s=(hi - lo) * 1e-6,
        busy_s=sum(busy) / len(busy) if busy else 0.0,
        devices=len(busy),
        kernels=kernels,
        copies=copies,
        device_s_by_span={k: v for k, v in span_s.items() if k is not None},
        device_s_outside_spans=span_s.get(None, 0.0),
        kernels_by_span={k: v for k, v in span_kernels.items() if k is not None},
        device_ops=top(op_s),
        idle_gaps=top(gap_s),
    )
