"""``correct`` comes out false when the timed path is broken underneath a
run (each fault a cell can have), and when the control, the reference one
step down in precision, stands in the program's place. CPU runs at test
size; the TF32 control needs the card."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from conftest import SERVE
from harness import manifest, runner

SEED = 2**31 + 1234


def _run(cell):
    line = runner.run_cell(cell, SEED, 0.4, False, "cpu", time.perf_counter())
    return line["correct"], line["compared"]


def _nmf_unchanged(monkeypatch):
    from gccnmf_torch.models import offline

    monkeypatch.setattr(offline, "kl_nmf", lambda v, w0, h0, *a, **k: (w0.clone(), h0.clone()))


def _half_batch_left_out(monkeypatch):
    from gccnmf_torch.models.offline import GCCNMFSeparator

    orig = GCCNMFSeparator._separate_batch_i16

    def half(self, x, w0, h0, n):
        b = x.shape[0] // 2
        est, targets, counts = orig(self, x[:b], w0[:b], h0[:b], n)
        return (torch.cat([est, est[: x.shape[0] - b]]), torch.cat([targets, targets]),
                torch.cat([counts, counts]))

    monkeypatch.setattr(GCCNMFSeparator, "_separate_batch_i16", half)


def _answer_altered(monkeypatch):
    from gccnmf_torch.models.offline import GCCNMFSeparator

    orig = GCCNMFSeparator._separate_batch_i16

    def altered(self, *a):
        est, targets, counts = orig(self, *a)
        est = est.clone()
        est[0, [0, 1]] = est[0, [1, 0]]  # two targets' estimates of one mixture swapped
        return est, targets, counts

    monkeypatch.setattr(GCCNMFSeparator, "_separate_batch_i16", altered)


def _target_altered(monkeypatch):
    from gccnmf_torch.models.offline import GCCNMFSeparator

    orig = GCCNMFSeparator._separate_batch_i16

    def altered(self, *a):
        est, targets, counts = orig(self, *a)
        targets = targets.clone()
        targets[0, 0] = (targets[0, 0] + 20) % 128  # one source localized off its peak
        return est, targets, counts

    monkeypatch.setattr(GCCNMFSeparator, "_separate_batch_i16", altered)


@pytest.mark.parametrize("fault", [_nmf_unchanged, _half_batch_left_out, _answer_altered,
                                   _target_altered])
def test_offline_faults_are_not_correct(small_cell, monkeypatch, fault):
    cell = small_cell("sep_b16_60s_i16")
    fault(monkeypatch)
    correct, compared = _run(cell)
    assert not correct, compared


def _step_state_unchanged(monkeypatch):
    from gccnmf_torch.models.realtime import RTGCCNMFProcessor

    orig = RTGCCNMFProcessor.eager_step
    monkeypatch.setattr(RTGCCNMFProcessor, "eager_step",
                        lambda self, state, block, params: (state, *orig(self, state, block,
                                                                         params)[1:]))


def _half_streams_left_out(monkeypatch):
    from gccnmf_torch.models.realtime import RTGCCNMFProcessor

    orig = RTGCCNMFProcessor.eager_step

    def half(self, state, block, params):
        new, out, tel = orig(self, state, block, params)
        out = out.clone()
        out[out.shape[0] // 2:] = 0.0
        return new, out, tel

    monkeypatch.setattr(RTGCCNMFProcessor, "eager_step", half)


def _tick_altered(monkeypatch):
    from gccnmf_torch.serving import StreamServer

    orig = StreamServer._from_wire
    calls = []

    def altered(self, out_np):
        calls.append(1)
        out = orig(self, out_np)
        return np.zeros_like(out) if len(calls) == 10 else out  # one tick's answers lost

    monkeypatch.setattr(StreamServer, "_from_wire", altered)


@pytest.mark.parametrize("fault", [_step_state_unchanged, _half_streams_left_out,
                                   _tick_altered])
def test_serving_faults_are_not_correct(small_cell, monkeypatch, fault):
    cell = small_cell(SERVE)
    fault(monkeypatch)
    correct, compared = _run(cell)
    assert not correct, compared


def test_sound_cells_are_correct(small_cell):
    for name in ("sep_f32_b16_10s_i16", SERVE):
        correct, compared = _run(small_cell(name))
        assert correct, compared


def test_offline_fp8_control_is_not_correct(small_cell):
    cell = small_cell("sep_b16_60s_i16")
    drv = manifest.entry(cell.config["entry"])
    check = drv.control(cell, SEED, torch.device("cpu"))
    assert not check["correct"], check["numbers"]


@pytest.mark.cuda
def test_serving_tf32_control_is_not_correct(card):
    """At the cell's own pool and window (1,070 ticks), 16 streams."""
    cell = manifest.cell_from_files(*SERVE)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, streams=16))
    drv = manifest.entry(cell.config["entry"])
    check = drv.control(cell, SEED, card, 1070)
    assert not check["correct"], check["numbers"]


@pytest.mark.cuda
def test_offline_tf32_control_is_not_correct(small_cell, card):
    """The float32 cell's control, the reference in TF32, at test size."""
    cell = small_cell("sep_f32_b16_10s_i16")
    drv = manifest.entry(cell.config["entry"])
    check = drv.control(cell, SEED, card)
    assert not check["correct"], check["numbers"]
