"""The port's profiling helpers (``gccnmf_torch/profiling.py``) on the CPU:
the four cases of tests/test_profiling.py on torch."""

import os
import time

import torch

from gccnmf_torch import profiling

torch.set_num_threads(1)  # Tier-1 runs several xdist workers


def test_stage_timer_summary():
    timer = profiling.StageTimer()
    for _ in range(3):
        with timer.stage("a"):
            time.sleep(0.002)
    with timer.stage("b"):
        pass
    s = timer.summary()
    assert s["a"]["calls"] == 3 and s["b"]["calls"] == 1
    assert s["a"]["mean_ms"] >= 1.0
    assert s["a"]["p50_ms"] <= s["a"]["max_ms"]
    timer.log_summary()  # must not raise


def test_block_all_fences_pytree():
    tree = {"x": torch.arange(4.0), "y": [torch.ones((2, 2)), 3, ("s", None)]}
    profiling.block_all(tree)  # must not raise on non-tensor leaves


def test_annotate_context():
    with profiling.annotate("unit-test-region"):
        _ = torch.square(torch.arange(8.0)).sum()


def test_trace_writes_files(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        with profiling.annotate("traced-region"):
            (torch.arange(1024.0) * 2).sum()
    found = []
    for _root, _dirs, files in os.walk(log_dir):
        found += files
    assert found, "profiler trace produced no files"
    text = open(os.path.join(log_dir, "trace.json")).read()
    assert "traced-region" in text
