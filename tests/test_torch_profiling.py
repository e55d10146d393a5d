"""The port's profiling helpers (``gccnmf_torch/profiling.py``) and the
program's spans on the CPU: ``annotate`` free when no profiler runs, the
spans of ``separate_batches`` in pipeline order and never open across a
``yield``, and the heap trim's span."""

import json
import os

import numpy as np
import pytest
import torch

from gccnmf_torch import profiling
from gccnmf_torch.models.offline import GCCNMFSeparator, OfflineConfig
from gccnmf_torch.utils.hostmem import PeriodicTrim

torch.set_num_threads(1)  # Tier-1 runs several xdist workers


def _spans(log_dir, prefix):
    """``(start, end, name)`` of the trace's host spans whose name starts
    with ``prefix``, in order of start."""
    with open(os.path.join(log_dir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith(prefix))


def _separator():
    cfg = OfflineConfig(dictionary_size=8, num_iterations=2, num_sources=2)
    return GCCNMFSeparator(cfg, device="cpu")


def _chunks(n):
    g = np.random.default_rng(5)
    return [(0.1 * g.standard_normal((2, 2, 4000))).astype(np.float32) for _ in range(n)]


def test_annotate_context():
    with profiling.annotate("unit-test-region"):
        _ = torch.square(torch.arange(8.0)).sum()


def test_annotate_is_one_shared_null_context_without_a_profiler(tmp_path):
    off = profiling.annotate("gccnmf.test.a")
    assert off is profiling.annotate("gccnmf.test.b")
    with off as entered:
        assert entered is None
    with profiling.trace(str(tmp_path)):
        on = profiling.annotate("gccnmf.test.c")
        assert on is not off
        with on:
            pass
    assert profiling.annotate("gccnmf.test.d") is off
    assert [s[2] for s in _spans(tmp_path, "gccnmf.test.")] == ["gccnmf.test.c"]


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


@pytest.mark.parametrize("io_dtype", ["float32", "int16"])
def test_separate_batches_spans_in_pipeline_order(tmp_path, io_dtype):
    """Chunk k+1 uploads while chunk k computes, chunk k downloads before
    chunk k-1 is handed over; the CPU has no download event, so no
    ``wait``."""
    sep = _separator()
    with profiling.trace(str(tmp_path)):
        out = list(sep.separate_batches(_chunks(3), io_dtype=io_dtype))
    assert len(out) == 3
    names = [s[2].removeprefix("gccnmf.offline.")
             for s in _spans(tmp_path, "gccnmf.offline.")]
    assert names == ["upload", "compute", "upload", "download",
                     "compute", "upload", "download", "materialize",
                     "compute", "download", "materialize", "materialize"]
    assert {n: names.count(n) for n in set(names)} == dict(
        upload=3, compute=3, download=3, materialize=3)


def test_no_program_span_is_open_across_a_yield(tmp_path):
    """A consumer's span between two ``next()`` calls overlaps no program
    span: every ``gccnmf.*`` span closes before its chunk is yielded."""
    sep = _separator()
    gen = sep.separate_batches(_chunks(4))
    with profiling.trace(str(tmp_path)):
        for _ in range(4):
            next(gen)
            with profiling.annotate("consumer.between"):
                np.sort(np.random.default_rng(0).standard_normal(20000))
    gen.close()
    consumer = _spans(tmp_path, "consumer.")
    program = _spans(tmp_path, "gccnmf.")
    assert len(consumer) == 4 and len(program) >= 12
    for cs, ce, _ in consumer:
        for ps, pe, name in program:
            assert pe <= cs or ps >= ce, (name, (ps, pe), (cs, ce))


def test_heap_trim_span_only_when_the_trim_fires(tmp_path):
    trim = PeriodicTrim(every_bytes=1)
    quiet = PeriodicTrim()
    with profiling.trace(str(tmp_path)):
        quiet.account(10)
        fired = trim.account(10)
    assert fired == (trim.trims == 1)
    assert [s[2] for s in _spans(tmp_path, "gccnmf.hostmem.")] == ["gccnmf.hostmem.trim"]
