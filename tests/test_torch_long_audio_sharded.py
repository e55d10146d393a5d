"""The port's time-sharded ``LongAudioSeparator``
(``gccnmf_torch/parallel/long_audio.py`` with a mesh) on the CPU: gloo
worlds of 2 and 4 ranks, against JAX's ``LongAudioSeparator`` on the same
number of shards of the 8-device virtual mesh and against the port's
mesh-less run, on the fixture mixture and configuration of
tests/test_long_audio.py at its bars: the same targets, W within rtol
5e-2 and atol 1e-4, waveforms above 40 dB across the seams, the streamed
files equal to ``separate`` up to int16 quantization. One spawned world of
each size serves every case of that size (``jobs.each``)."""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from gccnmf_tpu.models.offline import OfflineConfig as JaxOfflineConfig
from gccnmf_tpu.parallel import mesh as jmesh
from gccnmf_tpu.parallel.long_audio import LongAudioSeparator as JaxLongAudioSeparator
from gccnmf_torch.models.offline import GCCNMFSeparator, OfflineConfig
from gccnmf_torch.parallel import jobs, launch
from gccnmf_torch.parallel.long_audio import LongAudioSeparator
from gccnmf_torch.utils import wav as wavio

torch.set_num_threads(1)  # the suite runs several xdist workers

SMALL = dict(num_iterations=30, dictionary_size=32, num_tdoas=64, num_sources=2,
             mic_separation_m=0.5)
CFG, JCFG = OfflineConfig(**SMALL), JaxOfflineConfig(**SMALL)
TURBO = dict(nmf_matmul_dtype="bfloat16_q_simul")
FRAMES = 8 * 40  # divides 2 and 4 shards
WORLD_S = 300


def _two_source_mix(num_frames, window=1024, hop=128, sr=16000):
    """Stereo mixture whose STFT has exactly ``num_frames`` frames (JAX's
    fixture)."""
    n = (num_frames - 1) * hop + window
    t = np.arange(n) / sr

    def source(seed, rate):
        return np.random.default_rng(seed).standard_normal(n) * (
            0.5 + 0.5 * np.sin(2 * np.pi * rate * t))

    s1, s2 = source(1, 3.0), source(2, 7.0)
    return (0.2 * np.stack([s1 + np.roll(s2, 4), np.roll(s1, 4) + s2])).astype(np.float32)


def _snr(ref, est):
    return float(10 * np.log10((ref ** 2).sum() / max(((ref - est) ** 2).sum(), 1e-30)))


def _silent_span():
    x = _two_source_mix(200)
    x[:, 40 * 128 : 40 * 128 + 4 * 1024] = 0.0
    return x


def _call(method, args, shards, cfg=CFG, **kw):
    return (jobs.long_audio, (method, args, cfg, shards, "cpu"), kw)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 16-bit WAV of the streamed cases' mixture and the samples it holds."""
    tmp = tmp_path_factory.mktemp("sharded")
    path = str(tmp / "streamed_mix.wav")
    wavio.write_wav(_two_source_mix(8 * 24), path, 16000)
    return dict(tmp=tmp, path=path, stereo_q=wavio.read_wav(path)[0])


@pytest.fixture(scope="module")
def runs(files):
    """One world of 2 ranks and one of 4, each running its cases."""
    tmp, path, stereo_q = files["tmp"], files["path"], files["stereo_q"]
    x = _two_source_mix(FRAMES)
    out = {}
    for s in (2, 4):
        calls = {
            "separate": _call("separate", (x,), s),
            "streamed": _call("separate_streamed", (path, str(tmp / f"st{s}")), s),
            "separate_q": _call("separate", (stereo_q,), s),
            "too_short": _call("separate", (_two_source_mix(s),), s),
        }
        if s == 2:
            calls.update(
                device_init=_call("separate", (x,), s, nmf_init="device"),
                file=_call("separate_file", (path, str(tmp / "file2")), s),
                silence=_call("separate", (_silent_span(),), s),
                turbo=_call("separate", (x,), s, cfg=replace(CFG, **TURBO)),
            )
        else:
            calls.update(
                ragged=_call("separate", (_two_source_mix(8 * 24 + 5),), s),
                data_only=(jobs.long_audio, ("separate", (x,), CFG, 2, "cpu", 2), {}),
            )
        results = launch.run_world(jobs.each, s, "cpu", list(calls.values()), timeout_s=WORLD_S)
        out[s] = dict(zip(calls, results))
    return out


@pytest.fixture(scope="module")
def mesh_less():
    x = _two_source_mix(FRAMES)
    return dict(long=LongAudioSeparator(CFG, "cpu").separate(x),
                single=GCCNMFSeparator(CFG, device="cpu").separate(x, num_sources=2))


def _jax(s, stereo, cfg=JCFG):
    mesh = jmesh.make_mesh(data=s, model=1, devices=jax.devices()[:s])
    return JaxLongAudioSeparator(cfg, mesh).separate(stereo)


def _hold(got, want, snr_db=40.0):
    assert list(got["target_tdoa_indexes"]) == list(want["target_tdoa_indexes"])
    np.testing.assert_allclose(got["w"], np.asarray(want["w"]), rtol=5e-2, atol=1e-4)
    est = np.asarray(want["estimates"])
    assert got["estimates"].shape == est.shape
    for i in range(est.shape[0]):
        s = _snr(est[i], got["estimates"][i])
        assert s > snr_db, f"target {i}: waveform SNR {s:.1f} dB across the seams"


@pytest.mark.parametrize("shards", [2, 4])
def test_separate_matches_jax_and_mesh_less(shards, runs, mesh_less):
    got = runs[shards]["separate"]
    assert got["frames_processed"] == FRAMES
    _hold(got, _jax(shards, _two_source_mix(FRAMES)))
    _hold(got, mesh_less["long"])
    _hold(got, mesh_less["single"])


@pytest.mark.parametrize("shards", [2, 4])
def test_seam_continuity(shards, runs, mesh_less):
    """Around every shard boundary the stitched output matches the
    one-device separator's (JAX's bar, 2e-3 of the peak)."""
    got, ref = runs[shards]["separate"]["estimates"], mesh_less["single"]["estimates"]
    hop, window = CFG.hop_size, CFG.window_size
    scale = float(np.abs(ref).max())
    for b in range(1, shards):
        seam = b * (FRAMES // shards) * hop - window // 2
        lo, hi = max(seam - window, 0), seam + window
        np.testing.assert_allclose(got[:, :, lo:hi], ref[:, :, lo:hi], atol=2e-3 * scale)


@pytest.mark.parametrize("shards", [2, 4])
def test_streamed_equals_separate(shards, runs, files):
    """Each rank reads its own range and rank 0 writes: the files equal
    ``separate`` of the same samples up to int16 quantization (2 steps)."""
    out, ref = runs[shards]["streamed"], runs[shards]["separate_q"]
    assert list(out["target_tdoa_indexes"]) == list(ref["target_tdoa_indexes"])
    assert out["frames_processed"] == ref["frames_processed"] == 8 * 24
    assert out["samples_written"] == ref["estimates"].shape[-1]
    np.testing.assert_allclose(out["w"], ref["w"], rtol=1e-6, atol=1e-7)
    assert out["paths"] == [str(files["tmp"] / f"st{shards}_sim_{i}.wav") for i in (1, 2)]
    for i, p in enumerate(out["paths"]):
        got, sr = wavio.read_wav(p)
        assert sr == 16000 and got.shape == ref["estimates"][i].shape
        np.testing.assert_allclose(got, ref["estimates"][i], atol=2.0 / 32768.0)


@pytest.mark.parametrize("shards", [2, 4])
def test_too_short_raises(shards, runs):
    err = runs[shards]["too_short"]
    assert isinstance(err, ValueError) and f"too short to shard {shards} ways" in str(err)


def test_data_only_mesh_raises(runs):
    err = runs[4]["data_only"]
    assert isinstance(err, ValueError) and "data-only mesh" in str(err)


def test_trims_ragged_frames(runs):
    """197 frames over 4 shards: 196 processed, the rest dropped, not fatal."""
    got = runs[4]["ragged"]
    assert got["frames_processed"] == 196
    assert got["estimates"].shape[-1] == 196 * CFG.hop_size - CFG.hop_size


def test_device_init_separates(runs):
    """nmf_init="device": each rank draws its own H0 rows: the reference
    init's targets, finite nonzero estimates, another trajectory."""
    got, ref = runs[2]["device_init"], runs[2]["separate"]
    assert list(got["target_tdoa_indexes"]) == list(ref["target_tdoa_indexes"])
    assert np.isfinite(got["estimates"]).all() and np.abs(got["estimates"]).max() > 0
    assert not np.array_equal(got["estimates"], ref["estimates"])


def test_separate_file_writes_once(runs, files):
    got = runs[2]["file"]
    assert got["paths"] == [str(files["tmp"] / f"file2_sim_{i}.wav") for i in (1, 2)]
    for p, est in zip(got["paths"], got["estimates"]):
        x, sr = wavio.read_wav(p)
        assert sr == 16000 and x.shape == est.shape
        np.testing.assert_allclose(x, est, atol=1.0 / 32768.0)


def test_digital_silence_stays_finite(runs):
    """A silent span of several windows mid-file: the guarded coherence and
    NMF keep every output and the angular spectrum finite."""
    got = runs[2]["silence"]
    assert np.isfinite(got["estimates"]).all() and np.abs(got["estimates"]).max() > 0
    assert np.isfinite(got["mean_angular_spectrum"]).all()


def test_turbo_matches_jax(runs):
    """``bfloat16_q_simul`` runs the sharded turbo updates, as JAX's."""
    _hold(runs[2]["turbo"], _jax(2, _two_source_mix(FRAMES), replace(JCFG, **TURBO)))
