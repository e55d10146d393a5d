"""The reduction of the program's own spans (``harness/program_trace.py``)
on a small synthetic trace with a known answer, its readers (the launch
count from ``trace.py``'s reduction of the same trace), and the same
reduction of a real CPU trace of ``separate_batches``."""

import json

import numpy as np
import pytest

from conftest import BENCH, ROOT
from harness import manifest, program_trace, trace as tracing

HOST, OTHER = 11, 12


def _span(name, ts, dur, tid=HOST):
    return dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur, pid=1, tid=tid)


def _launch(ts, corr, name="cudaLaunchKernel"):
    return dict(ph="X", cat="cuda_runtime", name=name, ts=ts, dur=5, pid=1, tid=HOST,
                args=dict(correlation=corr))


def _device(ts, dur, corr, cat="kernel"):
    return dict(ph="X", cat=cat, name=f"k{corr}", ts=ts, dur=dur, pid=0, tid=7,
                args=dict(correlation=corr, device=0))


def _synthetic(path):
    """A window [0, 1000] µs: ``compute`` holds the harness's ``nmf`` span
    with two of its three launches; ``materialize`` holds ``wait`` and
    ``trim``; the card runs [140, 500] and [700, 750]; a span on another
    thread and one after the window are left out."""
    events = [
        _span("portbench.window", 0, 1000),
        _span("gccnmf.offline.compute", 100, 200),
        _span("portbench.nmf", 110, 100),
        _span("gccnmf.offline.materialize", 400, 400),
        _span("gccnmf.offline.wait", 400, 100),
        _span("gccnmf.hostmem.trim", 600, 50),
        _span("gccnmf.offline.upload", 850, 50),
        _span("gccnmf.offline.upload", 0, 1000, tid=OTHER),
        _span("gccnmf.offline.upload", 2000, 50),
        _launch(130, 1), _launch(150, 2), _launch(250, 3), _launch(620, 4, "cudaMemcpyAsync"),
        _device(140, 100, 1), _device(240, 60, 2), _device(300, 200, 3),
        _device(700, 50, 4, "gpu_memcpy"),
        dict(ph="i", cat="instant", name="marker", ts=10, pid=1, tid=HOST),
    ]
    path.write_text(json.dumps(dict(traceEvents=events)))
    return path


@pytest.fixture
def reduced(tmp_path):
    return program_trace.reduce(_synthetic(tmp_path / "trace.json"))


def test_self_time_counts_and_nesting(reduced):
    spans = reduced["spans"]
    assert set(spans) == {"gccnmf.offline.compute", "gccnmf.offline.materialize",
                          "gccnmf.offline.wait", "gccnmf.hostmem.trim",
                          "gccnmf.offline.upload"}
    want = {  # (count, duration, self time) in µs
        "gccnmf.offline.compute": (1, 200, 200),
        "gccnmf.offline.materialize": (1, 400, 250),
        "gccnmf.offline.wait": (1, 100, 100),
        "gccnmf.hostmem.trim": (1, 50, 50),
        "gccnmf.offline.upload": (1, 50, 50),
    }
    for name, (count, dur, own) in want.items():
        assert spans[name]["count"] == count, name
        assert spans[name]["s"] == pytest.approx(dur * 1e-6), name
        assert spans[name]["self_s"] == pytest.approx(own * 1e-6), name


def test_idle_intervals_split_by_the_innermost_span(reduced):
    """Gaps [0, 140], [500, 700], [750, 1000]: 590 µs idle, of which the
    spans open over them cover 340 µs."""
    assert reduced["window_s"] == pytest.approx(1000e-6)
    assert reduced["idle_s"] == pytest.approx(590e-6)
    by_span = {k: pytest.approx(v * 1e-6) for k, v in {
        "gccnmf.offline.compute": 40,
        "gccnmf.offline.materialize": 200, "gccnmf.hostmem.trim": 50,
        "gccnmf.offline.upload": 50}.items()}
    assert reduced["idle_s_by_span"] == by_span
    assert reduced["idle_unattributed_s"] == pytest.approx(250e-6)


def _record(path, steps=2):
    """A traced run's record: ``trace.py``'s reduction with the program's
    beside it."""
    tr = tracing.reduce(path, ("nmf", "frontend", "synthesis"))
    tr.update(steps=steps, calls={}, program=program_trace.reduce(path))
    return {"offline": {}, "trace": tr}


def test_launches_matched_to_the_wrapper_spans_by_correlation(tmp_path):
    """Two kernels launched inside the harness's ``nmf`` span, one after
    it, a copy not counted: one launch a chunk over two chunks."""
    rec = _record(_synthetic(tmp_path / "trace.json"))
    assert rec["trace"]["kernels_by_span"] == {"nmf": 2}
    assert program_trace.kernel_launches_per_chunk(rec) == 1.0


def test_innermost_segments_of_nested_spans():
    spans = [(0, 10, "a"), (2, 4, "b"), (2, 3, "c"), (6, 10, "d")]
    assert program_trace._innermost(spans) == [
        (0, 2, "a"), (2, 3, "c"), (3, 4, "b"), (4, 6, "a"), (6, 10, "d")]


def _metric_names():
    return [f"{r}.{p}" for r in ("offline.idle_unattributed_pct",
                                 "offline.materialize_ms_per_chunk",
                                 "offline.enqueue_ms_per_chunk",
                                 "offline.kernel_launches_per_chunk")
            for p in ("bf16", "f32")]


def test_the_eight_readers_on_a_record(tmp_path):
    rec = _record(_synthetic(tmp_path / "trace.json"))
    want = {"offline.idle_unattributed_pct": 25.0,
            "offline.materialize_ms_per_chunk": 0.125,
            "offline.enqueue_ms_per_chunk": 0.1,
            "offline.kernel_launches_per_chunk": 1.0}
    per_layer = json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
    layers = {e["layer"] for e in per_layer}
    for name in _metric_names():
        reader = manifest.metric_reader(name)
        assert reader.read(rec) == pytest.approx(want[name.rsplit(".", 1)[0]]), name
        assert reader.LAYER in layers
        assert reader.MOVES == "audio_s_per_s." + name.rsplit(".")[-1]
        assert reader.UNIT == ("%" if "pct" in name else
                               "launches" if "launches" in name else "ms")
        assert (BENCH / "metrics" / f"{name}.py").is_file()
    # the launch count reads what the entry keeps today, so the benchmark reports it
    listed = {e["name"]: e for e in per_layer}
    for p, cell in (("bf16", "sep_b16_60s_i16"), ("f32", "sep_f32_b16_10s_i16")):
        e = listed[f"offline.kernel_launches_per_chunk.{p}"]
        assert e["source"] == "device_trace" and e["workloads"] == [cell]


@pytest.mark.parametrize("trace", [
    None,
    {"steps": 2, "window_s": 1.0, "busy_s": 0.5},  # a program without spans, as before them
    {"steps": 2, "program": {"window_s": 1.0, "idle_s": 0.5, "idle_unattributed_s": 0.5,
                             "idle_s_by_span": {}, "spans": {}}},
])
def test_readers_return_none_without_program_spans(trace):
    for name in _metric_names():
        assert manifest.metric_reader(name).read({"offline": {}, "trace": trace}) is None


def test_a_cpu_trace_of_separate_batches(tmp_path):
    """The reduction of a real ``torch.profiler`` trace (the CPU path: no
    device, so no kernel and no idle interval): three chunks in the
    harness's window, each stage counted once a chunk."""
    from gccnmf_torch import profiling
    from gccnmf_torch.models.offline import GCCNMFSeparator, OfflineConfig

    sep = GCCNMFSeparator(OfflineConfig(dictionary_size=8, num_iterations=2, num_sources=2),
                          device="cpu")
    g = np.random.default_rng(3)
    chunks = [(0.1 * g.standard_normal((2, 2, 4000))).astype(np.float32) for _ in range(6)]
    gen = sep.separate_batches(chunks, io_dtype="int16")
    next(gen)
    with profiling.trace(str(tmp_path)):
        with tracing.span("window"):
            for _ in range(3):
                next(gen)
    red = program_trace.reduce(tmp_path / "trace.json")
    counts = {k: v["count"] for k, v in red["spans"].items()}
    assert counts == {"gccnmf.offline.upload": 3, "gccnmf.offline.compute": 3,
                      "gccnmf.offline.download": 3, "gccnmf.offline.materialize": 3}
    for v in red["spans"].values():
        assert 0 <= v["self_s"] <= v["s"]
    assert red["idle_s"] == 0
    rec = {"trace": {"steps": 3, "program": red}}
    assert program_trace.span_ms_per_chunk("gccnmf.offline.compute", "s")(rec) > 0
