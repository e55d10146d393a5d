"""The port's offline separator on the CPU against the JAX separator and the
NumPy oracle, at the bars of test_offline.py:35-61."""

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


class TestConfig:
    def test_fields_and_defaults_mirror_jax(self):
        ours = {f.name: f.default for f in dataclasses.fields(OfflineConfig)}
        theirs = {f.name: f.default for f in dataclasses.fields(joffline.OfflineConfig)}
        assert ours == theirs
        for md in ("float32", "bfloat16", "bfloat16_q"):
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

    def test_unported_modes_raise(self, stereo_signal):
        mix, sr = stereo_signal
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            GCCNMFSeparator(OfflineConfig(nmf_matmul_dtype="bfloat16_q_simul"), device="cpu")
        with pytest.raises(NotImplementedError, match="conv"):
            GCCNMFSeparator(OfflineConfig(stft_method="conv"), device="cpu")
        sep = GCCNMFSeparator(OfflineConfig(num_sources=None), device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            sep.separate_batch(mix[None])
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            sep.separate_batches([mix[None]], num_sources=2, io_dtype="int16")
