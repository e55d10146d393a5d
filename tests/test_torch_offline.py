"""The port's offline separator on the CPU against the JAX separator and the
NumPy oracle, at the bars of test_offline.py:35-61; its turbo mode, device
source counting and pipelined chunks at the bars of test_offline.py:231-345
and test_nmf_pallas.py:204-225."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gccnmf_tpu.models import offline as joffline
from gccnmf_torch.models.offline import (
    GCCNMFSeparator, OfflineConfig, gemm_dtype, plane_dtype, stft_gain,
)
from gccnmf_torch.utils import wav

import oracle

torch.set_num_threads(1)  # Tier-1 runs several xdist workers


def snr_db(ref, est):
    noise = ref - est
    return 10 * np.log10((ref**2).sum() / max((noise**2).sum(), 1e-30))


@pytest.fixture(scope="module")
def results(stereo_signal):
    mix, sr = stereo_signal
    kw = dict(dictionary_size=64, num_iterations=50, num_sources=2, sample_rate=sr)
    ours = GCCNMFSeparator(OfflineConfig(**kw), device="cpu").separate(mix)
    theirs = joffline.GCCNMFSeparator(joffline.OfflineConfig(**kw)).separate(mix)
    want = oracle.separate_ref(mix, sr, num_sources=2, dictionary_size=64, num_iterations=50)
    return ours, theirs, want


class TestAgainstJax:
    def test_targets_equal(self, results):
        ours, theirs, _ = results
        assert ours["target_tdoa_indexes"] == theirs["target_tdoa_indexes"]

    def test_mask_agreement(self, results):
        ours, theirs, _ = results
        agree = (ours["coefficient_masks"] == theirs["coefficient_masks"]).mean()
        assert agree > 0.995, agree

    def test_waveforms_and_state(self, results):
        ours, theirs, _ = results
        assert ours["estimates"].shape == theirs["estimates"].shape
        for t in range(ours["estimates"].shape[0]):
            s = snr_db(theirs["estimates"][t], ours["estimates"][t])
            assert s > 25.0, f"target {t}: {s:.1f} dB"
        # 50 fp32 iterations of the same updates: well inside 1e-3 relative
        np.testing.assert_allclose(ours["w"], theirs["w"], rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(ours["angular"], theirs["angular"], rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module")
def conv_results(stereo_signal):
    """The separation above with ``stft_method="conv"`` in both packages."""
    mix, sr = stereo_signal
    kw = dict(dictionary_size=64, num_iterations=50, num_sources=2, sample_rate=sr,
              stft_method="conv")
    ours = GCCNMFSeparator(OfflineConfig(**kw), device="cpu").separate(mix)
    theirs = joffline.GCCNMFSeparator(joffline.OfflineConfig(**kw)).separate(mix)
    return ours, theirs


class TestConvAgainstJax:
    """The conv STFT's separation (one strided convolution in, its
    transpose out) at test_offline.py:35-61's bars against JAX's conv
    separation and the NumPy oracle."""

    def test_targets_and_masks(self, conv_results, results):
        ours, theirs = conv_results
        assert ours["target_tdoa_indexes"] == theirs["target_tdoa_indexes"]
        assert ours["target_tdoa_indexes"] == list(results[2]["targets"])
        agree = (ours["coefficient_masks"] == theirs["coefficient_masks"]).mean()
        assert agree > 0.995, agree

    def test_waveforms(self, conv_results, results):
        ours, theirs = conv_results
        want = results[2]
        assert ours["estimates"].shape == theirs["estimates"].shape
        for t in range(ours["estimates"].shape[0]):
            for ref in (theirs["estimates"][t], want["estimates"][t]):
                s = snr_db(ref, ours["estimates"][t])
                assert s > 25.0, f"target {t}: {s:.1f} dB"


class TestAgainstOracle:
    def test_targets_and_shape(self, results, stereo_signal):
        ours, _, want = results
        mix, _ = stereo_signal
        assert ours["target_tdoa_indexes"] == list(want["targets"])
        n_frames = 1 + (mix.shape[-1] - 1024) // 128
        assert ours["estimates"].shape == (2, 2, 128 * (n_frames - 1))

    def test_waveform_parity(self, results):
        ours, _, want = results
        for t in range(ours["estimates"].shape[0]):
            s = snr_db(want["estimates"][t], ours["estimates"][t])
            assert s > 25.0, f"target {t}: parity SNR {s:.1f} dB"

    def test_mask_agreement(self, results):
        ours, _, want = results
        agree = (ours["coefficient_masks"].transpose(0, 2, 1) == want["masks"]).mean()
        assert agree > 0.995, agree


class TestEntryPoints:
    def _small(self, sr, **kw):
        return OfflineConfig(dictionary_size=32, num_iterations=10, num_sources=2,
                             sample_rate=sr, **kw)

    def test_separate_batch_matches_single(self, stereo_signal):
        mix, sr = stereo_signal
        sep = GCCNMFSeparator(self._small(sr), device="cpu")
        single = sep.separate(mix)
        est, targets = sep.separate_batch(np.stack([mix, mix]), num_sources=2)
        assert list(targets[0]) == single["target_tdoa_indexes"]
        np.testing.assert_array_equal(targets[0], targets[1])
        np.testing.assert_allclose(est[0], single["estimates"], atol=1e-4)
        j_est, j_targets = joffline.GCCNMFSeparator(
            joffline.OfflineConfig(dictionary_size=32, num_iterations=10, num_sources=2,
                                   sample_rate=sr)
        ).separate_batch(np.stack([mix, mix]), num_sources=2)
        np.testing.assert_array_equal(targets, j_targets)
        np.testing.assert_allclose(est, j_est, atol=1e-4)

    def test_separate_file_writes_sim_wavs(self, tmp_path, stereo_signal):
        mix, sr = stereo_signal
        path = str(tmp_path / "case_mix.wav")
        wav.write_wav(mix, path, sr)
        res = GCCNMFSeparator(self._small(sr), device="cpu").separate_file(path)
        assert res["paths"] == [str(tmp_path / f"case_sim_{i}.wav") for i in (1, 2)]
        for p in res["paths"]:
            assert os.path.exists(p)
            est, est_sr = wav.read_wav(p)
            assert est_sr == sr and est.shape[0] == 2

    def test_auto_count_host_path_matches_jax(self, stereo_signal):
        mix, sr = stereo_signal
        cfg = self._small(sr)
        ours = GCCNMFSeparator(dataclasses.replace(cfg, num_sources=None),
                               device="cpu").separate(mix)
        theirs = joffline.GCCNMFSeparator(joffline.OfflineConfig(
            dictionary_size=32, num_iterations=10, num_sources=None, sample_rate=sr)
        ).separate(mix)
        assert ours["target_tdoa_indexes"] == theirs["target_tdoa_indexes"]

    def test_matmul_stft_method(self, stereo_signal):
        mix, sr = stereo_signal
        a = GCCNMFSeparator(self._small(sr), device="cpu").separate(mix)
        b = GCCNMFSeparator(self._small(sr, stft_method="matmul"), device="cpu").separate(mix)
        assert a["target_tdoa_indexes"] == b["target_tdoa_indexes"]
        assert snr_db(a["estimates"], b["estimates"]) > 60.0


def _small_kw(sr, **kw):
    return {**dict(dictionary_size=32, num_iterations=10, num_sources=2, sample_rate=sr), **kw}


class TestTurbo:
    def test_separator_matches_jax_turbo(self, stereo_signal):
        """Off the kernel both run the turbo updates in fp32
        (``kl_nmf_simul``): the same targets, waveforms within 25 dB."""
        mix, sr = stereo_signal
        kw = _small_kw(sr, nmf_matmul_dtype="bfloat16_q_simul")
        ours = GCCNMFSeparator(OfflineConfig(**kw), device="cpu").separate(mix)
        theirs = joffline.GCCNMFSeparator(joffline.OfflineConfig(**kw)).separate(mix)
        assert ours["target_tdoa_indexes"] == theirs["target_tdoa_indexes"]
        assert ours["estimates"].shape == theirs["estimates"].shape
        for t in range(ours["estimates"].shape[0]):
            s = snr_db(theirs["estimates"][t], ours["estimates"][t])
            assert s > 25.0, f"target {t}: {s:.1f} dB"

    def test_same_localization_as_bfloat16_q(self, stereo_signal):
        mix, sr = stereo_signal
        mix = mix[:, :sr]  # the JAX test's 1 s and configuration
        kw = dict(sample_rate=sr, num_sources=2, mic_separation_m=0.5, dictionary_size=16,
                  num_iterations=20, num_tdoas=32)
        std = GCCNMFSeparator(OfflineConfig(**kw, nmf_matmul_dtype="bfloat16_q"),
                              device="cpu").separate(mix)
        turbo = GCCNMFSeparator(OfflineConfig(**kw, nmf_matmul_dtype="bfloat16_q_simul"),
                                device="cpu").separate(mix)
        assert turbo["target_tdoa_indexes"] == std["target_tdoa_indexes"]
        assert np.isfinite(turbo["estimates"]).all()
        assert 0 < (turbo["estimates"] ** 2).sum() <= (mix**2).sum() * 4


class TestThroughput:
    """``separate_batch(num_sources=None)``, the int16 program and
    ``separate_batches`` on the CPU (test_offline.py:231-345)."""

    def test_separate_batch_auto_matches_jax(self, stereo_signal):
        mix, sr = stereo_signal
        kw = _small_kw(sr, num_sources=None)
        chunk = np.stack([mix, mix])
        sep = GCCNMFSeparator(OfflineConfig(**kw), device="cpu")
        est, targets, counts = sep.separate_batch(chunk, max_sources=6)
        j_est, j_targets, j_counts = joffline.GCCNMFSeparator(
            joffline.OfflineConfig(**kw)).separate_batch(chunk, max_sources=6)
        assert est.shape[:2] == (2, 6) and targets.dtype == counts.dtype == np.int32
        np.testing.assert_array_equal(counts, j_counts)
        np.testing.assert_array_equal(targets, j_targets)
        c = int(counts[0])
        assert 1 <= c <= 6 and counts[1] == c
        host = sep.separate(mix, num_sources=None)
        assert list(targets[0][:c]) == host["target_tdoa_indexes"]
        for row in range(6):  # the detected sources carry audio, the pads none
            energy = float((est[0, row] ** 2).sum())
            assert energy > 0 if row < c else energy == 0.0, (row, energy)
        for row in range(c):
            assert snr_db(j_est[0, row], est[0, row]) > 25.0

    def test_separate_batches_matches_separate_batch(self, stereo_signal):
        mix, sr = stereo_signal
        sep = GCCNMFSeparator(OfflineConfig(**_small_kw(sr)), device="cpu")
        chunk = np.stack([mix, mix])
        want_est, want_targets = sep.separate_batch(chunk, num_sources=2)
        results = list(sep.separate_batches(iter([chunk, chunk, chunk]), num_sources=2))
        assert len(results) == 3
        for est, targets in results:
            np.testing.assert_array_equal(targets, want_targets)
            np.testing.assert_allclose(est, want_est, atol=1e-6)
        assert results[0][0] is not results[1][0]

    def test_separate_batches_int16_io(self, stereo_signal):
        """Outputs equal the f32 path up to the 16-bit quantization of input
        and output: waveform SNR > 35 dB."""
        mix, sr = stereo_signal
        sep = GCCNMFSeparator(OfflineConfig(**_small_kw(sr)), device="cpu")
        chunk = np.stack([mix, mix])
        want_est, want_targets = sep.separate_batch(chunk, num_sources=2)
        (est, targets), = sep.separate_batches([chunk], num_sources=2, io_dtype="int16")
        np.testing.assert_array_equal(targets, want_targets)
        assert est.dtype == np.float32 and np.abs(est).max() < 1.0
        for b in range(est.shape[0]):
            for t in range(est.shape[1]):
                s = snr_db(want_est[b, t], est[b, t])
                assert s > 35.0, f"chunk {b} target {t}: {s:.1f} dB"
        # int16 chunks go in as they are; the quantized output is a multiple of 2^-15
        (est2, _), = sep.separate_batches(
            [np.round(chunk * 32768).astype(np.int16)], num_sources=2, io_dtype="int16")
        np.testing.assert_array_equal(est2 * 32768.0, np.round(est2 * 32768.0))

    def test_int16_program_clamps_then_truncates(self, stereo_signal):
        """The device PCM conversion: clamp to [-32768, 32767], then the cast
        truncates toward zero, as JAX's astype does."""
        mix, sr = stereo_signal
        sep = GCCNMFSeparator(OfflineConfig(**_small_kw(sr)), device="cpu")
        x = torch.from_numpy(np.round(np.stack([mix]) * 32768).astype(np.int16))
        w0, h0 = sep._init_nmf(x.shape[-1], (1,))
        got, _, _ = sep._separate_batch_i16(x, w0, h0, 2)
        est, _, _ = sep._separate_batch_core(x.float() / 32768.0, w0, h0, 2)
        scaled = (est * 32768.0).numpy()
        want = np.trunc(np.clip(scaled, -32768, 32767)).astype(np.int16)
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), want)

    def test_separate_batches_validation(self, stereo_signal):
        mix, sr = stereo_signal
        sep = GCCNMFSeparator(OfflineConfig(sample_rate=sr), device="cpu")
        with pytest.raises(ValueError, match="io_dtype"):
            list(sep.separate_batches([np.stack([mix])], 2, io_dtype="int8"))
        with pytest.raises(ValueError, match="num_sources"):
            list(GCCNMFSeparator(OfflineConfig(sample_rate=sr, num_sources=None),
                                 device="cpu").separate_batches([np.stack([mix])]))
        assert list(sep.separate_batches([], 2)) == []


class TestConfig:
    def test_fields_and_defaults_mirror_jax(self):
        ours = {f.name: f.default for f in dataclasses.fields(OfflineConfig)}
        theirs = {f.name: f.default for f in dataclasses.fields(joffline.OfflineConfig)}
        assert ours == theirs
        for md in ("float32", "bfloat16", "bfloat16_q", "bfloat16_q_simul"):
            c, jc = OfflineConfig(nmf_matmul_dtype=md), joffline.OfflineConfig(nmf_matmul_dtype=md)
            assert (gemm_dtype(c), plane_dtype(c), stft_gain(c)) == (
                joffline.gemm_dtype(jc), joffline.plane_dtype(jc), joffline.stft_gain(jc))

    def test_backends_resolve(self):
        cpu = torch.device("cpu")
        cfg = OfflineConfig()
        assert cfg.resolved_nmf_backend(cpu) == "torch"
        assert cfg.resolved_frontend_backend(torch.device("cuda")) == "cuda"
        assert OfflineConfig(nmf_matmul_dtype="float32").resolved_frontend_backend(
            torch.device("cuda")) == "cuda"  # the kernel in float32 mode too
        with pytest.raises(ValueError, match="CUDA kernel"):
            cfg.__class__(synthesis_backend="cuda").resolved_synthesis_backend(cpu)
        with pytest.raises(ValueError, match="want one of"):
            OfflineConfig(nmf_backend="pallas").resolved_nmf_backend(cpu)

    def test_unported_modes_raise(self):
        """Nothing is left unported: the conv STFT builds (TestConvAgainstJax)
        and the server shards its slots over a ``LocalMesh``
        (tests/test_torch_serving.py). What neither knows still raises before
        anything runs: an unknown STFT method, a mesh of another kind."""
        from gccnmf_torch.serving import StreamServer

        assert GCCNMFSeparator(OfflineConfig(stft_method="conv"),
                               device="cpu")._stft_method == "conv"
        with pytest.raises(ValueError, match="unknown stft method"):
            GCCNMFSeparator(OfflineConfig(stft_method="dct"), device="cpu").separate(
                np.zeros((2, 4096), np.float32))
        with pytest.raises(TypeError, match="LocalMesh"):
            StreamServer(np.ones((513, 8), np.float32), device="cpu", mesh=object())
