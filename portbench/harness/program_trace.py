"""The program's own spans in a traced window, laid beside the device.

``gccnmf_torch`` opens ``gccnmf.*`` spans through ``profiling.annotate``
(that module's docstring lists them) around the host stages of its
pipelined separation. From the Chrome trace that an offline entry exports,
:func:`reduce` takes, for the ``portbench.window`` span:

- the count, time and self time of each ``gccnmf.*`` span on the window's
  thread, self time being the part of a span that no child ``gccnmf.*``
  span covers;
- the first device's idle intervals, as ``trace.py`` finds them, split by
  the innermost ``gccnmf.*`` span open over each part of each interval
  (interval arithmetic over the whole gap); the rest is unattributed.

The span readers below take that result from ``record["trace"]["program"]``
(where ``tools/program_spans.py`` stores it), with the window's chunk
count from ``record["trace"]["steps"]``, and return None where the record
holds no such span (a program without them). :func:`kernel_launches_per_chunk`
reads ``trace.py``'s own count of the kernels launched inside the harness's
spans around the kernel wrappers.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

from harness.trace import DEVICE_CATS, WINDOW, _gaps

PREFIX = "gccnmf."


def _innermost(spans):
    """Properly nested ``(start, end, name)`` spans as disjoint segments in
    time order, each named by the innermost span open over it."""
    out, stack, t = [], [], None
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, inner = stack.pop()
            out.append((t, end, inner))
            t = end
        if stack:
            out.append((t, s, stack[-1][1]))
        stack.append((e, name))
        t = s
    while stack:
        end, inner = stack.pop()
        out.append((t, end, inner))
        t = end
    return [(s, e, n) for s, e, n in out if e > s]


def _overlap(segments, gaps):
    """Time of each name's segments inside the gaps (both disjoint and in
    time order)."""
    by_name = defaultdict(float)
    i = 0
    for gs, ge in gaps:
        while i < len(segments) and segments[i][1] <= gs:
            i += 1
        j = i
        while j < len(segments) and segments[j][0] < ge:
            s, e, name = segments[j]
            by_name[name] += min(e, ge) - max(s, gs)
            j += 1
    return by_name


def reduce(path: Path) -> dict:
    """The program's spans of the traced window at ``path`` (times in s)."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"{path}: no {WINDOW} span")
    w = win[-1]
    lo, hi, host_tid = w["ts"], w["ts"] + w["dur"], w["tid"]

    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("tid") == host_tid
             and e.get("name", "").startswith(PREFIX) and lo <= e["ts"] <= hi]
    segments = _innermost(spans)
    stats = defaultdict(lambda: dict(count=0, s=0.0, self_s=0.0))
    for s, e, name in spans:
        stats[name]["count"] += 1
        stats[name]["s"] += (e - s) * 1e-6
    for s, e, name in segments:
        stats[name]["self_s"] += (e - s) * 1e-6

    by_device = defaultdict(list)
    for e in events:
        if e.get("cat") in DEVICE_CATS and lo <= e["ts"] <= hi:
            by_device[e.get("args", {}).get("device", e.get("pid"))].append(
                (e["ts"], min(e["ts"] + e.get("dur", 0.0), hi)))

    gaps = _gaps(by_device[next(iter(by_device))], lo, hi) if by_device else []
    idle_by_span = _overlap(segments, gaps)
    idle = sum(e - s for s, e in gaps)
    return dict(
        window_s=(hi - lo) * 1e-6,
        idle_s=idle * 1e-6,
        idle_unattributed_s=(idle - sum(idle_by_span.values())) * 1e-6,
        idle_s_by_span={k: v * 1e-6 for k, v in sorted(idle_by_span.items())},
        spans={k: stats[k] for k in sorted(stats)},
    )


def _program(rec):
    """The record's program spans and its chunk count, or None where it
    holds no program span."""
    tr = rec.get("trace")
    prog = tr.get("program") if tr else None
    if not prog or not prog["spans"] or not tr.get("steps"):
        return None
    return prog, tr["steps"]


def idle_unattributed_pct(rec):
    """Share (%) of the traced window with the card idle and no program
    span open."""
    got = _program(rec)
    if got is None or got[0]["window_s"] <= 0:
        return None
    prog = got[0]
    return 100.0 * prog["idle_unattributed_s"] / prog["window_s"]


def span_ms_per_chunk(name: str, key: str):
    """A span's time (``key="s"``) or self time (``"self_s"``) a chunk."""
    def read(rec):
        got = _program(rec)
        if got is None or name not in got[0]["spans"]:
            return None
        prog, steps = got
        return 1e3 * prog["spans"][name][key] / steps
    return read


def kernel_launches_per_chunk(rec):
    """Device kernels launched a chunk inside the harness's spans around the
    three kernel wrappers (``trace.py``'s ``kernels_by_span``)."""
    tr = rec.get("trace")
    if not tr or not tr.get("steps") or not tr.get("kernels_by_span"):
        return None
    return sum(tr["kernels_by_span"].values()) / tr["steps"]
