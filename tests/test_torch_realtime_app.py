"""The port's realtime app layer on the CPU (``gccnmf_torch/realtime``):
first against JAX's app (``gccnmf_tpu/realtime``) over the same WAV and the
same dictionaries — the outputs and the five history rings at the
streaming bars of tests/test_torch_realtime.py, the target index exactly,
the same ``run()`` stats — then the cases of tests/test_runtime.py
(``TestCircularBuffer``, ``TestAudio``, ``TestRealtimeApp``,
``TestPipelinedApp``, ``TestStructuralReconfig``) and of
tests/test_live_audio.py on the port. The captured graph's side (outputs
and telemetry copied out of the graph's own tensors, captures with a second
thread running) is held in ``test_torch_cuda.py``."""

import logging
import os
import threading
import time

import numpy as np
import pytest
import torch

from gccnmf_torch.config import load_config
from gccnmf_torch.realtime import CircularBuffer, RealtimeGCCNMF
from gccnmf_torch.realtime.audio import (
    CallbackOutputStream,
    FilePlayerSource,
    LiveRingSource,
    StreamingSink,
    WavSink,
    open_input_stream,
    open_output_stream,
)
from gccnmf_torch.utils import wav as wavio

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

CPU = "cpu"


def _dicts(*sizes, f=513):
    rng = np.random.default_rng(0)
    return {"Pretrained": {k: rng.random((f, k)).astype(np.float32) + 1e-3 for k in sizes}}


def _wav(tmp_path, stereo_signal, name="mix.wav"):
    mix, sr = stereo_signal
    path = str(tmp_path / name)
    wavio.write_wav(mix, path, sr)
    return path


def _app(path, depth=0, sizes=(16,), **cfg):
    cfg.setdefault("dictionary_size", 16)
    return RealtimeGCCNMF(path, config=load_config(None, **cfg), dictionaries=_dicts(*sizes),
                          pipeline_depth=depth, device=CPU)


def _mask_agreement(got, want) -> float:
    return float(np.isclose(got, want, rtol=1e-6, atol=1e-7).mean())


def _oracle_bars(got, want):
    """tests/test_torch_realtime.py's waveform bars: SNR > 25 dB and > 0.93
    of the samples within 3e-4 x max."""
    assert got.shape == want.shape
    err = got - want
    snr = 10 * np.log10((want ** 2).sum() / max((err ** 2).sum(), 1e-30))
    assert snr > 25.0, f"SNR {snr:.1f} dB"
    tight = (np.abs(err) < 3e-4 * np.abs(want).max()).mean()
    assert tight > 0.93, f"only {tight:.3f} of samples tightly matched"


# ------------------------------------------------------ against JAX's app

AGAINST_JAX = {
    "default": {},
    "num_h_updates=2": dict(num_h_updates=2),
    "boxcar, localization off": dict(target_mode="boxcar", localization_enabled=False),
}


@pytest.mark.parametrize("fields", list(AGAINST_JAX.values()), ids=list(AGAINST_JAX))
def test_app_against_jax(tmp_path, stereo_signal, fields):
    """The same WAV and dictionaries through both apps, block by block with
    a hot parameter change midway: outputs at the oracle's bars, the target
    history exactly, the GCC-PHAT history within 1e-6, the coefficient
    masks agreeing on > 0.995, the spectrogram histories within their bars."""
    from gccnmf_tpu.config import load_config as jload_config
    from gccnmf_tpu.realtime.app import RealtimeGCCNMF as JaxApp

    path = _wav(tmp_path, stereo_signal)
    kw = dict(dictionary_size=16, dictionary_sizes=(16,), **fields)
    dicts = _dicts(16)
    port = RealtimeGCCNMF(path, config=load_config(None, **kw), dictionaries=dicts, device=CPU)
    ref = JaxApp(path, config=jload_config(None, **kw), dictionaries=dicts)
    src = FilePlayerSource(path, 512)
    outs = ([], [])
    for i, block in enumerate(src.blocks()):
        if i == 24:
            break
        if i == 12:
            for app in (port, ref):
                app.set_target_window(target_tdoa_index=20.0, epsilon=3.0, beta=1.5)
        for app, got in zip((port, ref), outs):
            got.append(app.process_block(block))
    _oracle_bars(np.concatenate(outs[0], -1), np.concatenate(outs[1], -1))
    hp, hj = port.histories, ref.histories
    assert set(hp) == set(hj)
    for key in hp:
        assert hp[key].num_values == hj[key].num_values == 24, key
    np.testing.assert_array_equal(hp["tdoa"].get(), hj["tdoa"].get())
    np.testing.assert_allclose(hp["gcc_phat"].get(), hj["gcc_phat"].get(), atol=1e-6)
    assert _mask_agreement(hp["coefficient_mask"].get(), hj["coefficient_mask"].get()) > 0.995
    inp = hj["input_spectrogram"].get()
    np.testing.assert_allclose(hp["input_spectrogram"].get(), inp, atol=1e-5 * inp.max())
    _oracle_bars(hp["output_spectrogram"].get(), hj["output_spectrogram"].get())


def test_run_stats_and_file_against_jax(tmp_path, stereo_signal):
    """``run()`` over the file: the same stats keys and deadline, the
    output WAV at the oracle's bars."""
    from gccnmf_tpu.config import load_config as jload_config
    from gccnmf_tpu.realtime.app import RealtimeGCCNMF as JaxApp

    path = _wav(tmp_path, stereo_signal)
    kw = dict(dictionary_size=16, dictionary_sizes=(16,))
    port = RealtimeGCCNMF(path, config=load_config(None, **kw), dictionaries=_dicts(16),
                          device=CPU)
    ref = JaxApp(path, config=jload_config(None, **kw), dictionaries=_dicts(16))
    s_port = port.run(output_path=str(tmp_path / "p.wav"), num_blocks=16)
    s_ref = ref.run(output_path=str(tmp_path / "j.wav"), num_blocks=16)
    assert set(s_port) == set(s_ref)
    assert set(s_port["host_mem"]) == set(s_ref["host_mem"])
    for key in ("blocks", "deadline_ms"):
        assert s_port[key] == s_ref[key]
    a, sr_a = wavio.read_wav(s_port["output"])
    b, sr_b = wavio.read_wav(s_ref["output"])
    assert sr_a == sr_b
    _oracle_bars(a, b)


# ----------------------------------------------- tests/test_runtime.py's cases


class TestCircularBuffer:
    def test_append_and_get(self):
        buf = CircularBuffer(3, size=4)
        buf.set(np.array([1.0, 1, 1]))
        buf.set(np.array([2.0, 2, 2]))
        assert buf.num_values == 2
        np.testing.assert_array_equal(buf.get()[:, 0], [1, 2])

    def test_wraparound(self):
        buf = CircularBuffer((), size=3)
        for i in range(5):
            buf.set(np.float32(i))
        np.testing.assert_array_equal(buf.get(), [2, 3, 4])
        np.testing.assert_array_equal(buf.get_unraveled(), [2, 3, 4])

    def test_batch_append(self):
        buf = CircularBuffer(2, size=4)
        buf.set(np.arange(6, dtype=np.float32).reshape(3, 2))
        buf.set(np.arange(10, 14, dtype=np.float32).reshape(2, 2))
        np.testing.assert_array_equal(buf.get(3)[-1], [12, 13])
        assert buf.num_values == 4

    def test_oversize_batch(self):
        buf = CircularBuffer((), size=3)
        buf.set(np.arange(7, dtype=np.float32))
        np.testing.assert_array_equal(buf.get(), [4, 5, 6])

    def test_get_unraveled_includes_zeros(self):
        buf = CircularBuffer((), size=4)
        buf.set(np.float32(9))
        unr = buf.get_unraveled()
        assert unr.shape == (4,) and unr[-1] == 9 and unr[0] == 0

    def test_matches_jax_buffer(self):
        from gccnmf_tpu.realtime.buffers import CircularBuffer as JaxBuffer

        ours, theirs = CircularBuffer(5, 16), JaxBuffer(5, 16)
        rng = np.random.default_rng(0)
        for n in (1, 7, 3, 20, 9):
            x = rng.standard_normal((n, 5)).astype(np.float32)
            ours.set(x)
            theirs.set(x)
            np.testing.assert_array_equal(ours.get_unraveled(), theirs.get_unraveled())
            np.testing.assert_array_equal(ours.get(4), theirs.get(4))


class TestAudio:
    def test_file_player_blocks(self, tmp_path, stereo_signal):
        mix, _ = stereo_signal
        src = FilePlayerSource(_wav(tmp_path, stereo_signal), block_size=512)
        blocks = list(src.blocks())
        assert len(blocks) == mix.shape[-1] // 512 and blocks[0].shape == (2, 512)
        rebuilt = np.concatenate(blocks, axis=-1)
        np.testing.assert_allclose(rebuilt, mix[:, : rebuilt.shape[-1]], atol=2e-4)

    def test_file_player_loop(self, tmp_path, stereo_signal):
        mix, sr = stereo_signal
        path = str(tmp_path / "a.wav")
        wavio.write_wav(mix[:, : 512 * 3], path, sr)
        it = FilePlayerSource(path, block_size=512, loop=True).blocks()
        got = [next(it) for _ in range(7)]  # wraps past the 3-block file twice
        np.testing.assert_allclose(got[0], got[3], atol=1e-7)

    @pytest.mark.parametrize("sink_cls", [WavSink, StreamingSink])
    def test_sinks(self, tmp_path, sink_cls):
        sink = sink_cls(str(tmp_path / "o.wav"), 16000)
        sink.write(np.ones((2, 512), np.float32) * 0.5)
        sink.write(np.ones((2, 512), np.float32) * -0.5)
        out, sr = wavio.read_wav(sink.close())
        assert out.shape == (2, 1024) and sr == 16000

    def test_file_player_rejects_sub_block_file(self, tmp_path):
        path = str(tmp_path / "short.wav")
        wavio.write_wav(np.zeros((2, 300), np.float32), path, 16000)
        with pytest.raises(ValueError, match="shorter than"):
            FilePlayerSource(path, block_size=512, loop=True)

    def test_live_ring_rejects_wrong_shape_push(self):
        src = LiveRingSource(num_channels=2, block_size=512)
        with pytest.raises(ValueError, match="push_planar expects"):
            src.push_planar(np.zeros(512, np.float32))
        with pytest.raises(ValueError, match="push_planar expects"):
            src.push_planar(np.zeros((2, 256), np.float32))
        assert src.push_planar(np.zeros((2, 512), np.float32))
        assert src.overruns == 0

    def test_live_ring_source_threaded(self):
        """PCM16 callback frames from a producer thread come out as planar
        float blocks, in order, without tearing the channel framing."""
        src = LiveRingSource(num_channels=2, block_size=64, capacity_blocks=8)
        sent = np.random.default_rng(4).integers(-20000, 20000, size=(50, 64, 2),
                                                 dtype=np.int16)

        def producer():
            for b in range(len(sent)):
                while not src.push_interleaved_pcm16(sent[b].ravel()):
                    pass
            src.close()

        t = threading.Thread(target=producer)
        t.start()
        got = list(src.blocks())
        t.join()
        assert len(got) == len(sent)
        for b, block in enumerate(got):
            np.testing.assert_array_equal(block, sent[b].astype(np.float32).T / 32768.0)

    def test_live_ring_source_drains_tail_after_close(self):
        src = LiveRingSource(num_channels=2, block_size=64, capacity_blocks=8)
        blocks = np.random.default_rng(7).standard_normal((5, 2, 64)).astype(np.float32) * 0.1
        for b in blocks:
            assert src.push_planar(b)
        src.close()
        got = list(src.blocks())
        assert len(got) == len(blocks)
        for want, have in zip(blocks, got):
            np.testing.assert_array_equal(have, want)


class TestCallbackOutputStream:
    def test_fifo_ordering_and_interleaving(self):
        s = CallbackOutputStream(16000, num_channels=2, block_size=64, capacity_blocks=8)
        blocks = [np.arange(128, dtype=np.float32).reshape(2, 64) + 1000 * i for i in range(4)]
        for b in blocks:
            assert s.write(b)
        got = [s.callback(pull).ravel() for pull in (48, 16, 100, 92)]
        np.testing.assert_array_equal(np.concatenate(got),
                                      np.concatenate([b.T.ravel() for b in blocks]))
        assert s.underruns == 0 and s.overruns == 0
        assert s.frames_written == 256 and s.frames_played == 256

    def test_underrun_pads_silence_and_counts(self):
        s = CallbackOutputStream(16000, num_channels=2, block_size=32, capacity_blocks=4)
        np.testing.assert_array_equal(s.callback(32), np.zeros((32, 2), np.float32))
        assert s.underruns == 0  # before the first write: warm-up, not charged
        s.write(np.ones((2, 16), np.float32))
        out = s.callback(32)
        assert s.underruns == 1 and s.frames_played == 16
        np.testing.assert_array_equal(out[:16], np.ones((16, 2), np.float32))
        np.testing.assert_array_equal(out[16:], np.zeros((16, 2), np.float32))

    def test_overrun_drops_whole_block(self):
        s = CallbackOutputStream(16000, num_channels=2, block_size=32, capacity_blocks=2)
        i = 0
        while s.write(np.full((2, 32), float(i), np.float32)):
            i += 1
            assert i < 100, "ring never filled"
        assert s.overruns == 1 and s.pending_frames == i * 32
        frames = s.callback(i * 32)
        for j in range(i):
            np.testing.assert_array_equal(frames[j * 32:(j + 1) * 32], np.full((32, 2), float(j)))

    def test_close_drains_tail_and_rejects_writes(self):
        s = CallbackOutputStream(16000, num_channels=2, block_size=32)
        s.write(np.ones((2, 32), np.float32))
        s.close()
        out = s.callback(64)
        assert s.underruns == 0
        np.testing.assert_array_equal(out[:32], np.ones((32, 2)))
        assert not s.write(np.zeros((2, 32), np.float32))
        with pytest.raises(ValueError):
            s.write(np.zeros((3, 32), np.float32))

    def test_write_blocking_paces_and_times_out(self):
        s = CallbackOutputStream(16000, num_channels=2, block_size=32, capacity_blocks=2)
        n = 12

        def device():
            pulled = 0
            while pulled < n * 32:
                if s.pending_frames >= 32:
                    s.callback(32)
                    pulled += 32
                else:
                    time.sleep(1e-4)

        t = threading.Thread(target=device)
        t.start()
        for i in range(n):
            assert s.write_blocking(np.full((2, 32), float(i), np.float32), timeout=5.0)
        t.join(5.0)
        assert s.overruns == 0 and s.frames_written == n * 32
        while s.write(np.zeros((2, 32), np.float32)):
            pass
        before = s.overruns
        assert not s.write_blocking(np.zeros((2, 32), np.float32), timeout=0.05)
        assert s.overruns == before + 1

    @pytest.mark.parametrize("opener,cls", [(open_output_stream, CallbackOutputStream),
                                            (open_input_stream, LiveRingSource)])
    def test_open_streams(self, opener, cls):
        assert opener(16000, 2, 512) is None  # no audio stack
        stopped = []

        class Backend:
            def stop(self):
                stopped.append(True)

        stream = opener(16000, 2, 256, backend_factory=lambda s: Backend())
        assert isinstance(stream, cls) and stream.backend is not None
        stream.close()
        assert stopped == [True] and stream.backend is None


class TestRealtimeApp:
    @pytest.fixture()
    def app(self, tmp_path, stereo_signal):
        return _app(_wav(tmp_path, stereo_signal), sizes=(16, 8), dictionary_sizes=(8, 16))

    def test_default_device_is_cuda(self, tmp_path, stereo_signal):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is usable")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RealtimeGCCNMF(_wav(tmp_path, stereo_signal), dictionaries=_dicts(16))

    def test_run_headless(self, app, tmp_path):
        stats = app.run(output_path=str(tmp_path / "enh.wav"), num_blocks=12)
        assert stats["blocks"] == 12 and os.path.exists(stats["output"])
        assert stats["deadline_ms"] == pytest.approx(32.0)
        assert app.histories["gcc_phat"].num_values > 0
        assert app.histories["input_spectrogram"].num_values > 0

    def test_readers_see_host_values(self, app):
        """The GUI thread's reads never touch the engine's device: params
        are host tensors after every setter, the dictionary a read-only host
        copy of the engine's W (None before the first build)."""
        assert app.peek_dictionary() is None
        app.run(num_blocks=2)
        w = app.peek_dictionary()
        assert isinstance(w, np.ndarray) and not w.flags.writeable
        np.testing.assert_array_equal(w, app.processor.w.numpy())
        app.set_target_window(target_tdoa_index=10.0, epsilon=3.0, beta=1.0, noise_floor=0.1)
        app.set_separation_enabled(False)
        app.set_localization(True, window_size=4)
        app.set_num_tdoas(32)
        for leaf in app.params:
            assert leaf.device.type == "cpu" and leaf.dim() == 0
        assert float(np.asarray(app.params.target_tdoa_index)) == 16.0
        assert int(np.asarray(app.params.localization_window)) == 4

    def test_hot_param_update_no_rebuild(self, app):
        app.run(num_blocks=2)
        proc_before = app.processor
        app.set_target_window(target_tdoa_index=10.0, epsilon=3.0)
        app.set_separation_enabled(False)
        app.set_localization(False)
        app.run(num_blocks=2)
        assert app.processor is proc_before
        assert len(app.rebuild_ms) == 1

    def test_dictionary_change_rebuilds(self, app):
        app.run(num_blocks=2)
        proc_before = app.processor
        app.set_dictionary(size=8)
        app.run(num_blocks=2)
        assert app.processor is not proc_before and app.processor.w.shape[1] == 8
        assert app.histories["coefficient_mask"]._values.shape[1] == 8
        assert len(app.rebuild_ms) == 2

    def test_dictionary_change_concurrent_with_blocks(self, app):
        block = np.zeros((2, app.config.block_size), np.float32)
        app.process_block(block)
        errors = []

        def pump():
            try:
                for _ in range(30):
                    assert app.process_block(block).shape == (2, app.config.block_size)
            except Exception as e:  # pragma: no cover - the regression
                errors.append(e)

        t = threading.Thread(target=pump)
        t.start()
        for size in (8, 16, 8, 16):
            app.set_dictionary(size=size)
        t.join()
        assert not errors, errors

    def test_full_reconfig_storm_concurrent_with_blocks_and_gui_reads(self, app):
        """The audio thread pumps blocks, a control thread fires every
        structural setter, a GUI-style thread drains telemetry and peeks the
        dictionary: no exception, finite outputs, no deadlock."""
        block = np.zeros((2, app.config.block_size), np.float32)
        app.process_block(block)
        errors = []
        stop = threading.Event()

        def pump():
            try:
                for _ in range(40):
                    out = app.process_block(block)
                    assert out is not None and np.isfinite(out).all()
            except Exception as e:
                errors.append(e)
            finally:
                stop.set()

        def gui_reads():
            try:
                while not stop.is_set():
                    h = app.histories
                    h["gcc_phat"].get_unraveled()
                    h["coefficient_mask"].get_unraveled()
                    app.peek_dictionary()
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=pump), threading.Thread(target=gui_reads)]
        for t in threads:
            t.start()
        try:
            app.set_num_tdoas(48)
            app.set_dictionary(size=8)
            app.set_mic_separation(0.2)
            app.set_num_h_updates(2)
            app.set_target_mode("boxcar")
            app.set_dictionary(size=16)
            app.set_num_h_updates(0)
            app.set_target_mode("window")
        except Exception as e:
            errors.append(e)
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive(), "thread deadlocked"
        assert not errors, errors
        assert app.process_block(block).shape == (2, app.config.block_size)
        assert app.config.num_tdoas == 48 and app.dictionary_size == 16

    def test_dictionary_file_size_mismatch_syncs_telemetry(self, tmp_path, stereo_signal):
        path = _wav(tmp_path, stereo_signal)
        np.save(tmp_path / "W_24.npy",
                np.random.default_rng(0).random((513, 24)).astype(np.float32))
        cfg = load_config(None, dictionary_size=16, dictionary_file=str(tmp_path / "W_24.npy"))
        app = RealtimeGCCNMF(path, config=cfg, device=CPU)
        app.run(num_blocks=4)
        masks = app.histories["coefficient_mask"]
        assert masks._values.shape[1] == 24 and masks.num_values > 0
        assert app.dictionary_size == 24

    def test_block_time_logging(self, app, caplog, monkeypatch):
        import gccnmf_torch.realtime.app as app_mod

        monkeypatch.setattr(app_mod, "_TELEMETRY_LOG_INTERVAL_S", 0.0)
        with caplog.at_level(logging.INFO, logger="gccnmf_torch.realtime.app"):
            app.run(num_blocks=3)
        assert any("processing times" in r.message for r in caplog.records)
        mn, mx, mean, n = app.block_time_stats()
        assert n == 3 and 0 < mn <= mean <= mx

    def test_histories_equal_the_steps_telemetry_past_the_ring(self, tmp_path, stereo_signal):
        """Every block's telemetry lands in its own rows: after more blocks
        than the ring holds (looping the file), the drained histories equal
        the eager step's telemetry of the last blocks, row for row."""
        from gccnmf_torch.models.realtime import RTGCCNMFProcessor, StreamConfig

        app = _app(_wav(tmp_path, stereo_signal), num_tdoa_history=32,
                   num_spectrogram_history=32)
        n = 45  # past the 32-block ring
        app.run(num_blocks=n, loop=True)
        proc = RTGCCNMFProcessor(_dicts(16)["Pretrained"][16],
                                 StreamConfig.from_app_config(app.config), device=CPU)
        state, tels = proc.init_state(1), []
        blocks = FilePlayerSource(app.audio_path, 512, loop=True).blocks()
        for _ in range(n):
            state, _, tel = proc.eager_step(state, torch.from_numpy(next(blocks)[None]),
                                            app.params)
            tels.append(tel)
        h = app.histories
        last = tels[-32:]
        for key, tkey in (("gcc_phat", "gcc_phat"), ("input_spectrogram", "input_mag"),
                          ("output_spectrogram", "output_mag"),
                          ("coefficient_mask", "coefficient_mask")):
            want = np.concatenate([t[tkey][0].numpy() for t in last])
            np.testing.assert_array_equal(h[key].get(), want, err_msg=key)
        np.testing.assert_array_equal(
            h["tdoa"].get(), np.concatenate([t["target_tdoa_index"].numpy() for t in last]))


class TestPipelinedApp:
    def test_pipelined_output_file_identical(self, tmp_path, stereo_signal):
        path = _wav(tmp_path, stereo_signal)
        files = []
        for depth in (0, 2):
            out = str(tmp_path / f"o{depth}.wav")
            assert _app(path, depth).run(output_path=out, num_blocks=10)["blocks"] == 10
            files.append(wavio.read_wav(out)[0])
        np.testing.assert_array_equal(*files)

    def test_process_block_contract(self, tmp_path, stereo_signal):
        app = _app(_wav(tmp_path, stereo_signal), depth=1)
        block = np.zeros((2, app.config.block_size), np.float32)
        assert app.process_block(block) is None  # the pipeline fills
        out = app.process_block(block)
        assert out is not None and out.shape == (2, app.config.block_size)
        tail = app.flush()
        assert len(tail) == 1 and tail[0].shape == (2, app.config.block_size)
        assert app.flush() == []

    def test_negative_depth_rejected(self, tmp_path, stereo_signal):
        with pytest.raises(ValueError, match="pipeline_depth"):
            _app(_wav(tmp_path, stereo_signal), depth=-1)


class TestStructuralReconfig:
    """Mid-stream structural changes: each rebuild keeps the audio-path
    state, so the output has no gap beyond one block."""

    def _app(self, tmp_path, sizes=(16,), **cfg):
        sr = 16000
        t = np.arange(sr * 2) / sr
        tone = (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
        mix = np.stack([tone, tone])
        path = str(tmp_path / "tone.wav")
        wavio.write_wav(mix, path, sr)
        app = _app(path, sizes=sizes, **cfg)
        app.set_separation_enabled(False)  # passthrough: OLA gaps show as RMS dips
        return app, mix

    @staticmethod
    def _rms(x):
        return float(np.sqrt(np.mean(np.asarray(x, np.float64) ** 2)))

    def _stream_with_change(self, app, mix, change, blocks=14, change_at=7):
        bs = app.config.block_size
        outs = []
        for i in range(blocks):
            if i == change_at:
                change(app)
            outs.append(app.process_block(mix[:, i * bs:(i + 1) * bs]))
        return outs

    def _assert_continuous(self, outs, change_at=7):
        steady = self._rms(outs[change_at - 1])
        dips = [i for i in range(change_at, len(outs)) if self._rms(outs[i]) < steady * 0.7]
        assert len(dips) <= 1, f"audio gap after reconfig: dips at {dips}"

    def test_mic_separation_midstream(self, tmp_path):
        app, mix = self._app(tmp_path)
        outs = self._stream_with_change(app, mix, lambda a: a.set_mic_separation(0.3))
        assert app.processor.config.mic_separation_m == 0.3
        self._assert_continuous(outs)
        assert app.histories["gcc_phat"].num_values > 0

    def test_num_tdoas_midstream(self, tmp_path):
        app, mix = self._app(tmp_path)
        outs = self._stream_with_change(app, mix, lambda a: a.set_num_tdoas(96))
        assert app.processor.config.num_tdoas == 96
        assert float(np.asarray(app.params.target_tdoa_index)) == 48.0
        self._assert_continuous(outs)
        h = app.histories["gcc_phat"]
        assert h._values.shape[1] == 96 and h.num_values > 0

    @pytest.mark.parametrize("change", ["target_mode", "num_h_updates"])
    def test_mask_rule_midstream(self, tmp_path, change):
        from gccnmf_torch.models.realtime import TARGET_MODE_BOXCAR

        app, mix = self._app(tmp_path)
        if change == "target_mode":
            outs = self._stream_with_change(app, mix, lambda a: a.set_target_mode("boxcar"))
            assert app.processor.config.target_mode == TARGET_MODE_BOXCAR
        else:
            outs = self._stream_with_change(app, mix, lambda a: a.set_num_h_updates(2))
            assert app.processor.config.num_h_updates == 2
        self._assert_continuous(outs)

    def test_bad_geometry_rejected_before_commit(self, tmp_path):
        app, mix = self._app(tmp_path)
        old = app.config
        with pytest.raises(ValueError, match="divide"):
            app.set_block_geometry(hop_size=384)
        with pytest.raises(ValueError, match="exceed"):
            app.set_block_geometry(window_size=256, hop_size=512)
        with pytest.raises(ValueError, match="num_h_updates"):
            app.set_num_h_updates(-1)
        assert app.config == old
        out = app.process_block(mix[:, :app.config.block_size])
        assert out is None or np.isfinite(out).all()

    def test_block_geometry_midstream(self, tmp_path):
        app, mix = self._app(tmp_path)
        bs = app.config.block_size
        for i in range(4):
            app.process_block(mix[:, i * bs:(i + 1) * bs])
        app.set_block_geometry(window_size=512, hop_size=256)
        assert app.config.num_freq == 257 and app._dictionaries is None
        app._dictionaries = _dicts(16, f=257)
        assert app.histories["input_spectrogram"]._values.shape[1] == 257
        out = app.process_block(mix[:, 4 * bs:5 * bs])
        assert out.shape == (2, bs) and np.isfinite(out).all()
        # two frames a block now: every block adds two history rows
        before = app.histories["input_spectrogram"].num_values
        app.process_block(mix[:, 5 * bs:6 * bs])
        assert app.histories["input_spectrogram"].num_values == before + 2

    def test_dictionary_swap_is_gap_free(self, tmp_path):
        app, mix = self._app(tmp_path, sizes=(16, 8), dictionary_sizes=(8, 16))
        outs = self._stream_with_change(app, mix, lambda a: a.set_dictionary(size=8))
        steady = self._rms(outs[6])
        for i in range(7, len(outs)):
            assert self._rms(outs[i]) > steady * 0.9, f"gap at block {i}"

    def test_invalid_target_mode_rejected(self, tmp_path):
        app, _ = self._app(tmp_path)
        with pytest.raises(ValueError, match="MULTIPLE"):
            app.set_target_mode("multiple")
        with pytest.raises(ValueError, match="unknown target mode"):
            app.set_target_mode("gaussian?")

    def test_migrated_state_is_copied_into_the_new_engine(self, tmp_path):
        """A rebuild copies the carried leaves into the new engine's own
        state tensors: they equal the old state's values and share no
        storage with it."""
        app, mix = self._app(tmp_path)
        bs = app.config.block_size
        for i in range(5):
            app.process_block(mix[:, i * bs:(i + 1) * bs])
        old = app._state
        app.set_dictionary(type="Pretrained")
        app.processor  # noqa: B018 - build the new engine
        new = app._state
        for key in ("carry_in", "ola_acc", "gcc_history", "hist_count", "target_idx"):
            a, b = getattr(new, key), getattr(old, key)
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), key


# --------------------------------------- tests/test_live_audio.py's app cases


@pytest.fixture()
def rt_app(tmp_path, stereo_signal):
    return _app(_wav(tmp_path, stereo_signal), dictionary_sizes=(16,))


def test_run_rejects_mono_input_up_front(rt_app, tmp_path):
    mono = str(tmp_path / "mono.wav")
    wavio.write_wav(np.zeros((1, 4096), np.float32) + 0.01, mono, 16000)
    rt_app.audio_path = mono
    with pytest.raises(ValueError, match="channel"):
        rt_app.run(num_blocks=2)


def test_run_streamed_output_matches_buffered_sink(rt_app, tmp_path):
    buffered, streamed = str(tmp_path / "buf.wav"), str(tmp_path / "str.wav")
    rt_app.run(output_path=buffered, num_blocks=6)
    fresh = RealtimeGCCNMF(rt_app.audio_path, config=rt_app.config,
                           dictionaries=rt_app._dictionaries, device=CPU)
    fresh.run(output_path=streamed, num_blocks=6, streamed_output=True)
    a, sr_a = wavio.read_wav(buffered)
    b, sr_b = wavio.read_wav(streamed)
    assert sr_a == sr_b
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("depth", [0, 2])
def test_run_routes_enhanced_blocks_to_output_stream(rt_app, tmp_path, depth):
    """Every enhanced block reaches the output stream (the flush feeds the
    pipelined tail to the stream and the sink alike), sample for sample
    what the WAV sink holds."""
    cfg = rt_app.config
    app = RealtimeGCCNMF(rt_app.audio_path, config=cfg, dictionaries=rt_app._dictionaries,
                         pipeline_depth=depth, device=CPU)
    n = 12
    stream = CallbackOutputStream(cfg.sample_rate, cfg.num_channels, cfg.block_size,
                                  capacity_blocks=n)
    stats = app.run(output_path=str(tmp_path / "enh.wav"), num_blocks=n, output_stream=stream)
    assert stats["blocks"] == n
    assert stats["output_underruns"] == 0 and stats["output_overruns"] == 0
    sink_audio, _ = wavio.read_wav(stats["output"])
    assert stream.pending_frames == sink_audio.shape[1] == n * cfg.block_size
    np.testing.assert_allclose(stream.callback(n * cfg.block_size).T, sink_audio,
                               atol=2.0 / 32768.0)


def test_run_live_output_falls_back_without_backend(rt_app):
    stats = rt_app.run(num_blocks=3, live_output=True)
    assert stats["blocks"] == 3 and "output_underruns" not in stats


def test_live_ring_source_end_to_end_with_device_clock(rt_app):
    """A producer thread (the input callback) feeds a LiveRingSource, run()
    enhances, a consumer thread (the output callback) pulls on its own
    clock: every frame arrives, in order."""
    cfg = rt_app.config
    n = 16
    src = LiveRingSource(cfg.sample_rate, cfg.num_channels, cfg.block_size, capacity_blocks=n)
    in_blocks = []
    for i, b in enumerate(FilePlayerSource(rt_app.audio_path, cfg.block_size).blocks()):
        if i >= n:
            break
        in_blocks.append(b)

    def producer():
        for b in in_blocks:
            while not src.push_planar(b):
                time.sleep(0.001)
        src.close()

    stream = CallbackOutputStream(cfg.sample_rate, cfg.num_channels, cfg.block_size,
                                  capacity_blocks=4)
    played, stop = [], threading.Event()

    def consumer():
        while not stop.is_set() or stream.pending_frames > 0:
            got = min(stream.pending_frames, 256)
            if got:
                played.append(stream.callback(got))
            else:
                time.sleep(0.0005)

    threads = [threading.Thread(target=producer), threading.Thread(target=consumer)]
    for t in threads:
        t.start()
    try:
        stats = rt_app.run(source=src, output_stream=stream)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30.0)
    assert stats["blocks"] == n and src.overruns == 0
    ref = RealtimeGCCNMF(rt_app.audio_path, config=cfg, dictionaries=rt_app._dictionaries,
                         device=CPU)
    want = np.concatenate([ref.process_block(b) for b in in_blocks], axis=1)
    np.testing.assert_allclose(np.concatenate(played, axis=0).T, want, atol=1e-6)


def test_underruns_count_against_the_callback_clock(rt_app):
    cfg = rt_app.config
    stream = CallbackOutputStream(cfg.sample_rate, cfg.num_channels, cfg.block_size,
                                  capacity_blocks=4)
    stream.callback(cfg.block_size)
    assert stream.underruns == 0
    assert rt_app.run(num_blocks=2, output_stream=stream)["output_underruns"] == 0
    while stream.pending_frames >= cfg.block_size:
        stream.callback(cfg.block_size)
    stream.callback(cfg.block_size)
    assert stream.underruns >= 1
    assert rt_app.run(num_blocks=1, output_stream=stream)["output_underruns"] == stream.underruns
