"""The port's long-audio separation on one device
(``gccnmf_torch/parallel/long_audio.py``) on the CPU, against the JAX
package's ``LongAudioSeparator`` on a one-device mesh and against the
port's own ``GCCNMFSeparator``, at the JAX suite's small configuration and
bars (``tests/test_long_audio.py``): streamed outputs within 3 PCM steps,
one-shard ``separate`` above 40 dB with W at rtol 1e-4, the bf16-plane mode
above 20 dB against the float32 pipeline."""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile as sp_wavfile

from gccnmf_tpu.models.offline import OfflineConfig as JaxOfflineConfig
from gccnmf_tpu.ops import nmf as jnmf
from gccnmf_tpu.parallel import mesh as mesh_lib
from gccnmf_tpu.parallel.long_audio import LongAudioSeparator as JaxLongAudioSeparator
from gccnmf_torch.models.offline import GCCNMFSeparator, OfflineConfig
from gccnmf_torch.ops import nmf
from gccnmf_torch.parallel.long_audio import LongAudioSeparator
from gccnmf_torch.utils import wav as wavio

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

PCM_TOL = 3.0 / 32768.0  # the streamed path's bar (int16 outputs)
SMALL = dict(num_iterations=30, dictionary_size=32, num_tdoas=64, num_sources=2,
             mic_separation_m=0.5)


def _two_source_mix(num_frames, window=1024, hop=128, sr=16000):
    """Stereo mixture whose STFT has exactly ``num_frames`` frames: JAX's
    fixture, two modulated noise sources 4 samples apart."""
    n = (num_frames - 1) * hop + window
    t = np.arange(n) / sr

    def source(seed, rate):
        return np.random.default_rng(seed).standard_normal(n) * (
            0.5 + 0.5 * np.sin(2 * np.pi * rate * t))

    s1, s2 = source(1, 3.0), source(2, 7.0)
    d = 4
    return (0.2 * np.stack([s1 + np.roll(s2, d), np.roll(s1, d) + s2])).astype(np.float32)


def _configs(**kw):
    """The port's and JAX's OfflineConfig with the same fields."""
    fields = {**SMALL, **kw}
    return OfflineConfig(**fields), JaxOfflineConfig(**fields)


@pytest.fixture(scope="module")
def mesh1():
    """JAX's one-device mesh: its separate_streamed takes the chunked path."""
    return mesh_lib.make_mesh(data=1, model=1, devices=jax.devices()[:1])


def _wav(tmp_path, frames, name="mix", sr=16000, edit=None):
    """A 16-bit WAV of the fixture mixture → (path, the samples it holds)."""
    stereo = _two_source_mix(frames)
    if edit is not None:
        edit(stereo)
    path = str(tmp_path / f"{name}.wav")
    wavio.write_wav(stereo, path, sr)
    return path, wavio.read_wav(path)[0]


def _read(paths):
    return [wavio.read_wav(p)[0] for p in paths]


def _snr(ref, est):
    return float(10 * np.log10((ref ** 2).sum() / max(((ref - est) ** 2).sum(), 1e-30)))


def _streamed_pair(tmp_path, mesh1, path, cfg, jcfg, chunk_frames, tag="s", **kw):
    got = LongAudioSeparator(cfg, "cpu", chunk_frames=chunk_frames, **kw).separate_streamed(
        path, output_prefix=str(tmp_path / f"port_{tag}"), num_sources=2)
    want = JaxLongAudioSeparator(jcfg, mesh1, chunk_frames=chunk_frames, **kw).separate_streamed(
        path, output_prefix=str(tmp_path / f"jax_{tag}"), num_sources=2)
    return got, want


def _hold_streamed(got, want):
    """The port's streamed run against JAX's: the same targets, frames and
    samples, W at rtol 1e-4, every output within 3 PCM steps."""
    assert list(got["target_tdoa_indexes"]) == list(want["target_tdoa_indexes"])
    assert got["frames_processed"] == want["frames_processed"]
    assert got["samples_written"] == want["samples_written"]
    np.testing.assert_allclose(got["w"], want["w"], rtol=1e-4, atol=1e-6)
    for a, b in zip(_read(got["paths"]), _read(want["paths"]), strict=True):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=PCM_TOL)


class TestStreamed:
    @pytest.mark.parametrize("chunk_frames", [2, 64, 512])
    def test_parity_with_jax_and_single_device(self, tmp_path, mesh1, chunk_frames):
        """float32 planes: the ragged last chunk (200 % 64), one chunk (512 >
        200) and chunks shorter than the leading half-window trim (2 frames)
        give GCCNMFSeparator's estimates and JAX's files within 3 PCM
        steps."""
        cfg, jcfg = _configs(nmf_matmul_dtype="float32")
        path, stereo_q = _wav(tmp_path, 200)
        ref = GCCNMFSeparator(cfg, device="cpu").separate(stereo_q, num_sources=2)
        got, want = _streamed_pair(tmp_path, mesh1, path, cfg, jcfg, chunk_frames)
        _hold_streamed(got, want)
        assert got["frames_processed"] == 200
        assert list(got["target_tdoa_indexes"]) == list(ref["target_tdoa_indexes"])
        for a, r in zip(_read(got["paths"]), ref["estimates"], strict=True):
            assert a.shape == r.shape
            np.testing.assert_allclose(a, r, rtol=0, atol=PCM_TOL)

    def test_default_mode_quality(self, tmp_path, mesh1):
        """bf16 planes (the default mode): the float32 pipeline's targets and
        > 20 dB against it; JAX's files within 3 PCM steps."""
        cfg, jcfg = _configs()
        path, stereo_q = _wav(tmp_path, 192)
        ref = GCCNMFSeparator(replace(cfg, nmf_matmul_dtype="float32"),
                              device="cpu").separate(stereo_q, num_sources=2)
        got, want = _streamed_pair(tmp_path, mesh1, path, cfg, jcfg, 64)
        _hold_streamed(got, want)
        assert list(got["target_tdoa_indexes"]) == list(ref["target_tdoa_indexes"])
        for a, r in zip(_read(got["paths"]), ref["estimates"], strict=True):
            assert _snr(r, a) > 20.0

    def test_turbo_follows_jax_simul(self, tmp_path, mesh1):
        """``bfloat16_q_simul`` runs the turbo updates over the whole V, as
        JAX's ``nmf.kl_nmf_simul``: W at rtol 1e-4, files within 3 steps."""
        cfg, jcfg = _configs(nmf_matmul_dtype="bfloat16_q_simul")
        path, _ = _wav(tmp_path, 160)
        got, want = _streamed_pair(tmp_path, mesh1, path, cfg, jcfg, 64)
        _hold_streamed(got, want)

    def test_float_wav_uploads_floats(self, tmp_path, mesh1):
        """A float WAV has no int16 payload to ship: its float32 samples go
        up as they are, and the result is JAX's."""
        cfg, jcfg = _configs()
        path = str(tmp_path / "float_mix.wav")
        sp_wavfile.write(path, 16000, _two_source_mix(150).T)
        assert wavio.WavReader(path).raw_dtype.kind == "f"
        got, want = _streamed_pair(tmp_path, mesh1, path, cfg, jcfg, 64)
        assert got["transfer_mb"]["uploads"] == pytest.approx(
            4 * 2 * (149 * 128 + 1024 + 2 * 896) / 1e6)  # three chunks, the seams twice
        _hold_streamed(got, want)
        for x in _read(got["paths"]):
            assert np.isfinite(x).all() and np.abs(x).max() > 0

    def test_device_init(self, tmp_path):
        """``nmf_init="device"``: the reference init's targets, finite and
        nonzero outputs, another trajectory, the same files on a rerun."""
        cfg, _ = _configs()
        path, _ = _wav(tmp_path, 160)

        def run(tag, nmf_init):
            return LongAudioSeparator(cfg, "cpu", chunk_frames=64, nmf_init=nmf_init)\
                .separate_streamed(path, output_prefix=str(tmp_path / tag), num_sources=2)

        ref, dev, again = run("ri", "reference"), run("di", "device"), run("di2", "device")
        assert list(dev["target_tdoa_indexes"]) == list(ref["target_tdoa_indexes"])
        for a, b, c in zip(_read(ref["paths"]), _read(dev["paths"]), _read(again["paths"]),
                           strict=True):
            assert np.isfinite(b).all() and np.abs(b).max() > 0
            assert not np.array_equal(a, b)
            np.testing.assert_array_equal(b, c)

    def test_unknown_nmf_init_raises(self):
        with pytest.raises(ValueError, match="nmf_init"):
            LongAudioSeparator(OfflineConfig(**SMALL), "cpu", nmf_init="magic")

    def test_digital_silence_stays_finite(self, tmp_path, mesh1):
        """Whole silent windows mid-file in both channels: the guarded
        coherence and NMF keep every output finite and nonzero, as JAX's,
        in the streamed and the in-memory paths."""
        def silence(stereo):
            stereo[:, 40 * 128: 40 * 128 + 4 * 1024] = 0.0

        cfg, jcfg = _configs()
        path, stereo_q = _wav(tmp_path, 200, edit=silence)
        got, want = _streamed_pair(tmp_path, mesh1, path, cfg, jcfg, 64)
        _hold_streamed(got, want)
        for x in _read(got["paths"]):
            assert np.isfinite(x).all() and np.abs(x).max() > 0
        mem = LongAudioSeparator(cfg, "cpu").separate(stereo_q)
        assert np.isfinite(mem["estimates"]).all()
        assert np.isfinite(mem["mean_angular_spectrum"]).all()

    def test_seeded_init_chunked_draw_is_exact(self):
        """The atom-block H0 draw is nmf_init_numpy's MT19937 stream bit for
        bit, the port's and JAX's, whatever the block."""
        cfg, _ = _configs()
        sep = LongAudioSeparator(cfg, "cpu")
        t2 = 2 * 100
        w_ref, h_ref = nmf.nmf_init_numpy(cfg.num_freq, cfg.dictionary_size, t2, cfg.epsilon)
        w_jax, h_jax = jnmf.nmf_init_numpy(cfg.num_freq, cfg.dictionary_size, t2, cfg.epsilon)
        np.testing.assert_array_equal(h_ref, h_jax)
        for block in (8, 5):
            w_got, h_got = sep._h0_device_chunked(t2, atom_block=block)
            np.testing.assert_array_equal(w_got, w_ref)
            np.testing.assert_array_equal(w_got, w_jax)
            assert h_got.is_contiguous()
            np.testing.assert_array_equal(h_got.numpy(), h_ref)

    def test_resamples_config_to_file_rate(self, tmp_path, mesh1):
        cfg, jcfg = _configs()
        path, _ = _wav(tmp_path, 160, name="sr8k_mix", sr=8000)
        got, want = _streamed_pair(tmp_path, mesh1, path, cfg, jcfg, 64)
        _hold_streamed(got, want)
        assert wavio.read_wav(got["paths"][0])[1] == 8000

    def test_rejects_mono(self, tmp_path):
        path = str(tmp_path / "mono.wav")
        wavio.write_wav(_two_source_mix(64)[:1], path, 16000)
        with pytest.raises(ValueError, match="stereo"):
            LongAudioSeparator(OfflineConfig(**SMALL), "cpu").separate_streamed(path)

    def test_too_short_raises(self, tmp_path):
        path = str(tmp_path / "short.wav")
        wavio.write_wav(np.zeros((2, 1000), np.float32), path, 16000)
        with pytest.raises(ValueError, match="shorter than one analysis window"):
            LongAudioSeparator(OfflineConfig(**SMALL), "cpu").separate_streamed(path)


class TestInMemory:
    def test_matches_jax_and_single_device(self, mesh1):
        """One-shard ``separate``: GCCNMFSeparator's and JAX's targets, W at
        rtol 1e-4, > 40 dB per output against both."""
        cfg, jcfg = _configs(nmf_matmul_dtype="float32")
        stereo = _two_source_mix(200)
        got = LongAudioSeparator(cfg, "cpu").separate(stereo, num_sources=2)
        ref = GCCNMFSeparator(cfg, device="cpu").separate(stereo, num_sources=2)
        want = JaxLongAudioSeparator(jcfg, mesh1).separate(stereo, num_sources=2)
        assert got["frames_processed"] == want["frames_processed"] == 200
        for other in (ref, want):
            assert list(got["target_tdoa_indexes"]) == list(other["target_tdoa_indexes"])
            np.testing.assert_allclose(got["w"], other["w"], rtol=1e-4, atol=1e-6)
            assert got["estimates"].shape == np.shape(other["estimates"])
            for a, b in zip(got["estimates"], np.asarray(other["estimates"]), strict=True):
                assert _snr(b, a) > 40.0
        np.testing.assert_allclose(got["mean_angular_spectrum"], want["mean_angular_spectrum"],
                                   rtol=0, atol=1e-5 * np.abs(want["mean_angular_spectrum"]).max())

    def test_conv_stft_matches_jax(self, tmp_path, mesh1):
        """``stft_method="conv"`` reaches both passes; the synthesis
        inverts with ``fft``, as JAX's does: in memory, JAX's targets, W at
        rtol 1e-4 and > 40 dB; streamed, JAX's files within 3 PCM steps."""
        cfg, jcfg = _configs(nmf_matmul_dtype="float32", stft_method="conv")
        stereo = _two_source_mix(160)
        got = LongAudioSeparator(cfg, "cpu").separate(stereo, num_sources=2)
        want = JaxLongAudioSeparator(jcfg, mesh1).separate(stereo, num_sources=2)
        assert list(got["target_tdoa_indexes"]) == list(want["target_tdoa_indexes"])
        np.testing.assert_allclose(got["w"], want["w"], rtol=1e-4, atol=1e-6)
        for a, b in zip(got["estimates"], np.asarray(want["estimates"]), strict=True):
            assert _snr(b, a) > 40.0
        path, _ = _wav(tmp_path, 160, name="conv_mix")
        _hold_streamed(*_streamed_pair(tmp_path, mesh1, path, cfg, jcfg, 64, tag="conv"))

    def test_default_mode_matches_jax(self, mesh1):
        """The default config (the NMF in guarded fp32 on either package's
        plain path): JAX's targets and > 40 dB."""
        cfg, jcfg = _configs()
        stereo = _two_source_mix(160)
        got = LongAudioSeparator(cfg, "cpu").separate(stereo)
        want = JaxLongAudioSeparator(jcfg, mesh1).separate(stereo)
        assert list(got["target_tdoa_indexes"]) == list(want["target_tdoa_indexes"])
        for a, b in zip(got["estimates"], np.asarray(want["estimates"]), strict=True):
            assert _snr(b, a) > 40.0

    def test_separate_file_matches_jax(self, tmp_path, mesh1):
        cfg, jcfg = _configs()
        path, _ = _wav(tmp_path, 192, name="long_mix")
        got = LongAudioSeparator(cfg, "cpu").separate_file(path, str(tmp_path / "port"))
        want = JaxLongAudioSeparator(jcfg, mesh1).separate_file(path, str(tmp_path / "jax"))
        assert [p.rsplit("/", 1)[1] for p in got["paths"]] == ["port_sim_1.wav",
                                                             "port_sim_2.wav"]
        assert list(got["target_tdoa_indexes"]) == list(want["target_tdoa_indexes"])
        for a, b in zip(_read(got["paths"]), _read(want["paths"]), strict=True):
            assert np.isfinite(a).all() and a.shape[0] == 2 and a.shape == b.shape
            assert _snr(b, a) > 40.0

    def test_too_short_raises(self):
        with pytest.raises(ValueError, match="too short"):
            LongAudioSeparator(OfflineConfig(**SMALL), "cpu").separate(_two_source_mix(3))

    def test_ragged_frames_all_processed(self):
        """One shard takes every frame: 197 frames give 197 frames' output."""
        cfg, _ = _configs()
        result = LongAudioSeparator(cfg, "cpu").separate(_two_source_mix(197), num_sources=2)
        assert result["frames_processed"] == 197
        n_expected = 197 * cfg.hop_size + (cfg.window_size - cfg.hop_size)
        assert result["estimates"].shape == (2, 2, n_expected - cfg.window_size)

    def test_num_sources_defers_to_config(self, mesh1):
        """None defers to the config (2 here), and a config of None counts
        the sources, as GCCNMFSeparator and JAX do."""
        cfg, jcfg = _configs()
        stereo = _two_source_mix(192)
        assert LongAudioSeparator(cfg, "cpu").separate(stereo)["estimates"].shape[0] == 2
        auto = LongAudioSeparator(replace(cfg, num_sources=None), "cpu").separate(stereo)
        ref = GCCNMFSeparator(replace(cfg, num_sources=None), device="cpu").separate(stereo)
        want = JaxLongAudioSeparator(replace(jcfg, num_sources=None), mesh1).separate(stereo)
        assert auto["estimates"].shape[0] == ref["estimates"].shape[0]
        assert list(auto["target_tdoa_indexes"]) == list(ref["target_tdoa_indexes"])
        assert list(auto["target_tdoa_indexes"]) == list(want["target_tdoa_indexes"])
