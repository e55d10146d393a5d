"""The port's evaluation modules against the JAX package's on the CPU:
``metrics`` and ``pesq_p862`` (every score equal to JAX's at rtol 1e-10,
on seeded signals and on the degradations of tests/test_metrics.py, and the
same errors), ``baselines.numpy_ref`` (equal outputs), ``utils.stamp``
(its keys, no CUDA initialised) and ``viz`` (the plots of
tests/test_runtime.py::TestViz under Agg, the same narration)."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from gccnmf_tpu import metrics as jmetrics
from gccnmf_tpu import viz as jviz
from gccnmf_tpu.baselines import numpy_ref as jref
from gccnmf_tpu.utils import stamp as jstamp
from gccnmf_torch import metrics, viz
from gccnmf_torch.baselines import numpy_ref
from gccnmf_torch.models.offline import OfflineConfig
from gccnmf_torch.utils import stamp

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

# the same NumPy arithmetic in both packages: equal to rounding at most
RTOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    """NumPy's BLAS on one thread while this module runs: beside the other
    xdist workers, a many-threaded ``dot`` in PESQ's aligner spins for
    seconds a call."""
    with threadpool_limits(1):
        yield


def _curves():
    """examples/render_pesq_curves.py: the speech-like utterance and the
    three degradation families of the PESQ calibration."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
    try:
        import render_pesq_curves
    finally:
        sys.path.pop(0)
    return render_pesq_curves


@pytest.fixture(scope="module")
def rc():
    return _curves()


@pytest.fixture(scope="module")
def speech(rc):
    return rc.speech_like(seconds=4)


@pytest.fixture(scope="module")
def separated():
    """Three seeded sources (two channels each) and noisy, mixed-up
    estimates of them."""
    rng = np.random.default_rng(5)
    refs = rng.standard_normal((3, 2, 6000))
    ests = refs[[1, 2, 0]] + 0.2 * refs[[0, 1, 2]] + 0.05 * rng.standard_normal(refs.shape)
    return refs, ests


@pytest.mark.parametrize("name", ["snr", "si_sdr", "sdr"])
def test_scalar_metrics_equal_jax(separated, name):
    refs, ests = separated
    for r, e in zip(refs, ests):
        got = getattr(metrics, name)(r, e)
        assert got == pytest.approx(getattr(jmetrics, name)(r, e), rel=RTOL)
        # a tensor, on whatever device it lies, is copied to the host
        assert getattr(metrics, name)(torch.from_numpy(r), torch.from_numpy(e)) == got


def test_permutation_invariant_equals_jax(separated):
    refs, ests = separated
    score, perm = metrics.permutation_invariant(torch.from_numpy(refs), ests)
    want, want_perm = jmetrics.permutation_invariant(refs, ests)
    assert perm == want_perm == (1, 2, 0)
    assert score == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("compute_permutation", [True, False])
def test_bss_eval_sources_equals_jax(separated, compute_permutation):
    refs, ests = separated
    got = metrics.bss_eval_sources(refs, torch.from_numpy(ests),
                                   compute_permutation=compute_permutation)
    want = jmetrics.bss_eval_sources(refs, ests, compute_permutation=compute_permutation)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a, b, rtol=RTOL)
    np.testing.assert_array_equal(got[3], want[3])


def test_stoi_equals_jax(speech, rc):
    noisy = rc.additive_noise(speech, 5)
    for clean, deg in ((speech, noisy), (np.stack([speech, noisy]), np.stack([noisy, speech]))):
        got = metrics.stoi(clean, torch.from_numpy(deg), 16000)
        assert got == pytest.approx(jmetrics.stoi(clean, deg, 16000), rel=RTOL)
    for fn in (metrics.stoi, jmetrics.stoi):  # both reject a signal of no frame
        with pytest.raises(ValueError):
            fn(np.zeros(100), np.zeros(100), 16000)


DEGRADATIONS = {
    "identity": lambda rc, x: x,
    "noise_20db": lambda rc, x: rc.additive_noise(x, 20),
    "noise_0db": lambda rc, x: rc.additive_noise(x, 0),
    "mnru_q15": lambda rc, x: rc.mnru(x, 15),
    "lowpass_2k": lambda rc, x: rc.lowpass(x, 2000),
    "delayed": lambda rc, x: np.concatenate([np.zeros(777), x])[: x.size],
    "advanced": lambda rc, x: x[500:],
    "gain": lambda rc, x: 0.31 * x,
    "stereo": lambda rc, x: np.stack([x, rc.additive_noise(x, 10)]),
}


@pytest.mark.parametrize("name", list(DEGRADATIONS))
def test_pesq_equals_jax(speech, rc, name):
    deg = DEGRADATIONS[name](rc, speech)
    ref = np.stack([speech, speech]) if deg.ndim == 2 else speech
    got = metrics.pesq(ref, deg, 16000)
    assert got == pytest.approx(jmetrics.pesq(ref, deg, 16000), rel=RTOL)
    assert 0.999 <= got <= 4.65


def test_pesq_narrowband_equals_jax(rc):
    x8 = rc.speech_like(seconds=4, sr=8000)
    for deg in (x8, x8 + 0.05 * np.random.default_rng(3).standard_normal(x8.size)):
        got = metrics.pesq(torch.from_numpy(x8), deg, 8000)
        assert got == pytest.approx(jmetrics.pesq(x8, deg, 8000), rel=RTOL)


@pytest.mark.parametrize("args,match", [
    ((44100, None), "8 kHz and 16 kHz"),
    ((16000, "superwideband"), "mode"),
    ((16000, None, 1000), "too short"),
])
def test_pesq_raises_where_jax_raises(speech, args, match):
    x = speech[: args[2]] if len(args) > 2 else speech
    for fn in (metrics.pesq, jmetrics.pesq):
        with pytest.raises(ValueError, match=match):
            fn(x, x, *args[:2])


# ---- the NumPy oracle ---------------------------------------------------------


def test_numpy_ref_separation_equals_jax(stereo_signal):
    mix, sr = stereo_signal
    kw = dict(num_sources=2, dictionary_size=16, num_iterations=5)
    got = numpy_ref.separate_ref(mix, sr, **kw)
    want = jref.separate_ref(mix, sr, **kw)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
    spec = numpy_ref.stft_ref(mix[0], 1024, 128)
    np.testing.assert_array_equal(numpy_ref.istft_ref(spec, 1024, 128),
                                  jref.istft_ref(spec, 1024, 128))


def test_numpy_ref_streaming_equals_jax(stereo_signal):
    mix, sr = stereo_signal
    w = np.random.default_rng(4).random((513, 8)).astype(np.float32) + 1e-3
    args = (mix[:, : 12 * 512], w, sr, 1024, 256, 512, 32, 0.1, 16.0, 3.0, 2.0, 0.0)
    np.testing.assert_array_equal(numpy_ref.rt_stream_ref(*args), jref.rt_stream_ref(*args))
    assert numpy_ref.SPEED_OF_SOUND == jref.SPEED_OF_SOUND


# ---- the run stamp -----------------------------------------------------------


def test_run_stamp_keys_and_no_cuda_context():
    before = torch.cuda.is_initialized()
    s = stamp.run_stamp(stamp.config_fingerprint(OfflineConfig()))
    assert torch.cuda.is_initialized() == before
    assert set(s) == {"git_sha", "utc", "torch_version", "torch_cuda", "config_fingerprint"}
    assert s["torch_version"] == torch.__version__ and s["torch_cuda"] == torch.version.cuda
    assert s["git_sha"] == jstamp.git_sha()  # one checkout holds both packages
    assert "config_fingerprint" not in stamp.run_stamp()


def test_config_fingerprint_equals_jax():
    @dataclasses.dataclass
    class Cfg:
        window_size: int = 1024
        method: str = "conv"

    for cfg in (Cfg(), {"a": 1, "b": [2, 3]}, "not a config"):
        assert stamp.config_fingerprint(cfg) == jstamp.config_fingerprint(cfg)
    assert len(stamp.config_fingerprint(OfflineConfig())) == 12
    assert stamp.config_fingerprint(OfflineConfig()) != stamp.config_fingerprint(
        OfflineConfig(stft_method="conv"))
    assert stamp.git_sha("/") is None  # outside a checkout


# ---- the plots -----------------------------------------------------------------


class TestViz:
    def test_plots_render(self, stereo_signal, tmp_path):
        """tests/test_runtime.py::TestViz's plots through the port's module,
        NumPy and tensor inputs alike."""
        import matplotlib

        matplotlib.use("Agg", force=True)
        import matplotlib.pyplot as plt

        mix, sr = stereo_signal
        rng = np.random.default_rng(0)
        spec = rng.random((50, 513)).astype(np.float32)
        ang = rng.random((50, 64)).astype(np.float32)
        w = rng.random((513, 16)).astype(np.float32)
        h = rng.random((50, 16)).astype(np.float32)

        viz.plot_waveform(torch.from_numpy(mix), sr)
        plt.close("all")
        viz.plot_spectrogram(spec, sr, 512)
        plt.close("all")
        ax = viz.plot_angular_spectrogram(torch.from_numpy(ang), sr, 512)
        assert ax.get_ylabel() == "TDOA index"
        plt.close("all")
        ax = viz.plot_localization(ang.mean(0), target_indexes=torch.tensor([10, 40]))
        assert len(ax.lines) == 2
        plt.close("all")
        fig = viz.plot_nmf_decomposition(w, torch.from_numpy(h))
        fig.savefig(str(tmp_path / "nmf.png"))
        assert (tmp_path / "nmf.png").stat().st_size > 0
        plt.close("all")
        masks = (rng.random((2, 50, 16)) > 0.5).astype(np.float32)
        fig = viz.plot_coefficient_masks(masks)
        assert len(fig.axes) == 2
        plt.close("all")

    def test_describe_printers_equal_jax(self, stereo_signal, capsys):
        mix, sr = stereo_signal
        w = np.ones((513, 4), np.float32)
        w /= np.linalg.norm(w, axis=0)
        spec = np.zeros((10, 513), np.complex64)
        for port, theirs in ((viz.describe_mixture_signal(mix, sr),
                              jviz.describe_mixture_signal(mix, sr)),
                             (viz.describe_spectrogram(spec, 1024, 512),
                              jviz.describe_spectrogram(spec, 1024, 512)),
                             (viz.describe_nmf(torch.from_numpy(w), np.ones((10, 4))),
                              jviz.describe_nmf(w, np.ones((10, 4))))):
            assert port == theirs
        out = capsys.readouterr().out
        assert "mixture:" in out and "spectrogram:" in out and "NMF:" in out
