"""The port's online (causal, frame-wise) enhancer against the JAX package's
``OnlineGCCNMFEnhancer`` on the CPU: every case of ``tests/test_online.py``
on the port, the smoothing against the naive recurrence, and each smoothing
mode with and without H updates against JAX on the same seeded input."""

import numpy as np
import pytest
import torch

from gccnmf_tpu.models import online as jonline
from gccnmf_torch.models.online import OnlineConfig, OnlineGCCNMFEnhancer, _causal_smooth

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

MODES = ["sliding", "cumulative", "exponential"]


@pytest.fixture(scope="module")
def dictionary():
    g = np.random.default_rng(1234)
    return g.random((513, 48)).astype(np.float32) + 1e-3


def _naive(ang, mode, window, alpha):
    """The recurrence of each smoothing mode, frame by frame in float64."""
    want = np.zeros(ang.shape, np.float64)
    acc = np.zeros(ang.shape[1])
    for t in range(ang.shape[0]):
        if mode == "cumulative":
            want[t] = ang[: t + 1].mean(0)
        elif mode == "sliding":
            want[t] = ang[max(0, t - window + 1): t + 1].mean(0)
        else:
            acc = alpha * acc + (1 - alpha) * ang[t]
            want[t] = acc
    return want


class TestCausalSmoothing:
    @pytest.mark.parametrize("mode", MODES)
    def test_smoothing_matches_naive(self, mode, rng):
        ang = rng.standard_normal((20, 8)).astype(np.float32)
        cfg = OnlineConfig(smoothing=mode, smoothing_window=4, smoothing_alpha=0.8)
        got = _causal_smooth(torch.from_numpy(ang), cfg).numpy()
        np.testing.assert_allclose(got, _naive(ang, mode, 4, 0.8), atol=1e-5)

    def test_exponential_stays_finite_at_2000_frames(self, rng):
        """2,000 frames at α = 0.9: the closed form a^t·Σ a^-s x_s would
        overflow float32 (0.9^-842 ≈ 3e38); the scan stays at the
        recurrence."""
        ang = rng.standard_normal((2000, 8)).astype(np.float32)
        cfg = OnlineConfig(smoothing="exponential")
        got = _causal_smooth(torch.from_numpy(ang), cfg).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, _naive(ang, "exponential", 6, 0.9), atol=1e-5)

    def test_unknown_mode_raises(self):
        with pytest.raises(ValueError, match="smoothing"):
            _causal_smooth(torch.zeros(4, 2), OnlineConfig(smoothing="median"))


class TestAgainstJax:
    @pytest.mark.parametrize("num_h_updates", [0, 10])
    @pytest.mark.parametrize("mode", MODES)
    def test_matches_jax(self, stereo_signal, dictionary, mode, num_h_updates):
        """Targets equal on every frame; the coefficient masks agree on
        >= 99.5 % of entries (within rtol 1e-5, atol 1e-12: the exp of the
        soft mask differs by float32 rounding between the libraries, and a
        flipped argmax moves an entry by far more); the output within
        1e-4 x max."""
        mix, sr = stereo_signal
        kw = dict(sample_rate=sr, smoothing=mode, num_h_updates=num_h_updates)
        got = OnlineGCCNMFEnhancer(dictionary, OnlineConfig(**kw), device="cpu").enhance(mix)
        want = jonline.OnlineGCCNMFEnhancer(dictionary, jonline.OnlineConfig(**kw)).enhance(mix)
        assert set(got) == set(want)
        for key in got:
            assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got["target_tdoa_index"], want["target_tdoa_index"])
        agree = np.isclose(got["coefficient_masks"], want["coefficient_masks"],
                           rtol=1e-5, atol=1e-12).mean()
        assert agree >= 0.995
        scale = np.abs(want["enhanced"]).max()
        np.testing.assert_allclose(got["enhanced"], want["enhanced"], rtol=0, atol=1e-4 * scale)

    def test_config_matches_jax(self):
        assert vars(OnlineConfig()) == vars(jonline.OnlineConfig())
        assert OnlineConfig().num_freq == jonline.OnlineConfig().num_freq


class TestOnlineEnhancer:
    def test_shapes_and_masking(self, stereo_signal, dictionary):
        mix, sr = stereo_signal
        res = OnlineGCCNMFEnhancer(dictionary, OnlineConfig(sample_rate=sr),
                                   device="cpu").enhance(mix)
        out = res["enhanced"]
        assert out.shape[0] == 2
        assert 0 < (out ** 2).sum() < (mix ** 2).sum()
        t = res["target_tdoa_index"].shape[-1]
        assert res["coefficient_masks"].shape[-2] == t

    def test_causality(self, stereo_signal, dictionary):
        """Corrupting the input after sample n must not change the output
        before n - 2 windows (the STFT lookahead)."""
        mix, sr = stereo_signal
        enh = OnlineGCCNMFEnhancer(dictionary, OnlineConfig(sample_rate=sr, smoothing="cumulative"),
                                   device="cpu")
        a = enh.enhance(mix)["enhanced"]
        corrupted = mix.copy()
        n_cut = mix.shape[-1] // 2
        corrupted[:, n_cut:] = np.random.default_rng(0).standard_normal(
            corrupted[:, n_cut:].shape)
        b = enh.enhance(corrupted)["enhanced"]
        safe = n_cut - 2 * 1024
        np.testing.assert_allclose(a[:, :safe], b[:, :safe], atol=1e-5)

    def test_h_inference_mode(self, stereo_signal, dictionary):
        mix, sr = stereo_signal
        res0, res1 = (OnlineGCCNMFEnhancer(
            dictionary, OnlineConfig(sample_rate=sr, num_h_updates=nh), device="cpu"
        ).enhance(mix) for nh in (0, 10))
        assert res0["enhanced"].shape == res1["enhanced"].shape
        assert not np.allclose(res0["enhanced"], res1["enhanced"])

    def test_batched(self, stereo_signal, dictionary):
        """A batch element gives what it gives alone, bit for bit (one
        utterance at a time), with any leading batch shape."""
        mix, sr = stereo_signal
        enh = OnlineGCCNMFEnhancer(dictionary, OnlineConfig(sample_rate=sr), device="cpu")
        single = enh.enhance(mix)
        other = enh.enhance(mix[::-1].copy())
        batch = enh.enhance(np.stack([[mix, mix[::-1]]]))
        assert batch["enhanced"].shape == (1, 2) + single["enhanced"].shape
        assert batch["coefficient_masks"].shape == (1, 2) + single["coefficient_masks"].shape
        for key in single:
            np.testing.assert_array_equal(batch[key][0, 0], single[key])
            np.testing.assert_array_equal(batch[key][0, 1], other[key])

    def test_localization_tracks_moving_source(self, dictionary):
        """The target index follows a source that switches sides mid-signal."""
        sr = 16000
        rng = np.random.default_rng(11)
        n = sr * 2
        s = rng.standard_normal(n).astype(np.float32)
        half = n // 2
        right = np.concatenate([np.roll(s[:half], 4), np.roll(s[half:], -4)])
        mix = np.stack([s, right])
        cfg = OnlineConfig(sample_rate=sr, smoothing="sliding", smoothing_window=4)
        idx = OnlineGCCNMFEnhancer(dictionary, cfg, device="cpu").enhance(mix)["target_tdoa_index"]
        early, late = idx[len(idx) // 4], idx[-1]
        assert early != late
        assert (early - 31.5) * (late - 31.5) < 0  # opposite sides of center
