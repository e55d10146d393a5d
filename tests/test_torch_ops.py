"""gccnmf_torch DSP ops against their JAX counterparts and the NumPy oracle.

The same seeded NumPy inputs go through the JAX function and the port's on
the CPU; tolerances are stated with their reasons."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gccnmf_tpu.ops import gcc as jgcc
from gccnmf_tpu.ops import localize as jloc
from gccnmf_tpu.ops import masks as jmasks
from gccnmf_tpu.ops import nmf as jnmf
from gccnmf_tpu.ops import stft as jstft
from gccnmf_tpu.ops import windows as jwin
from gccnmf_tpu.utils import wav as jwav
from gccnmf_torch.convert import from_numpy_state
from gccnmf_torch.ops import gcc, localize, masks, nmf, stft
from gccnmf_torch.ops.windows import hann_symmetric
from gccnmf_torch.utils import wav

import oracle

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

# fp32 transforms of O(10)-magnitude spectra: both sides round each output
# once or twice, so 1e-5 relative (plus 1e-5 absolute near zero) is the bar.
RTOL = ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("n", [1, 8, 511, 1024])
def test_hann_symmetric_equals_jax(n):
    np.testing.assert_array_equal(hann_symmetric(n), jwin.hann_symmetric(n))


class TestSTFT:
    @pytest.mark.parametrize("method", ["fft", "matmul", "conv"])
    def test_stft_matches_jax_and_oracle(self, stereo_signal, method):
        mix, _ = stereo_signal
        w = hann_symmetric(1024)
        want = np.asarray(jstft.stft(jnp.asarray(mix), w, 128, conjugate=True, method=method))
        got = stft.stft(_t(mix), w, 128, conjugate=True, method=method)
        # the matmul and conv methods sum 1024 fp32 products in another
        # order than XLA's GEMM and convolution: their atol is 1e-5 of the
        # spectrum's scale (≈80)
        _close(got, want, atol=ATOL if method == "fft" else ATOL * np.abs(want).max())
        ref = oracle.mixture_spectrogram_ref(mix, 1024, 128)  # (2, F, T)
        np.testing.assert_allclose(
            got.numpy().transpose(0, 2, 1), ref, atol=2e-4 * np.abs(ref).max()
        )

    def test_stft_unconjugated_and_short_window(self, rng):
        y = rng.standard_normal(4000).astype(np.float32)
        win = np.hanning(384)
        want = np.asarray(jstft.stft(jnp.asarray(y), win, 128, fft_size=512))
        got = stft.stft(_t(y), win, 128, fft_size=512)
        _close(got, want)

    @pytest.mark.parametrize("method", ["fft", "matmul", "conv"])
    def test_istft_matches_jax_and_oracle(self, stereo_signal, method):
        mix, _ = stereo_signal
        spec_ref = oracle.stft_ref(mix[0], 1024, 128)
        w = hann_symmetric(1024)
        kw = dict(conjugate=True, center_trim=True, method=method)
        want = np.asarray(jstft.istft(jnp.asarray(spec_ref.T[None]), w, 128, **kw))
        got = stft.istft(_t(spec_ref.T[None]), w, 128, **kw)
        _close(got, want)
        ref = oracle.istft_ref(spec_ref, 1024, 128)
        np.testing.assert_allclose(got.numpy()[0], ref, atol=5e-5 * np.abs(ref).max())

    @pytest.mark.parametrize("n,frame,hop", [(1000, 64, 16), (1000, 96, 40), (4096, 1024, 128)])
    def test_frames_and_overlap_add_equal_jax(self, rng, n, frame, hop):
        y = rng.standard_normal((2, n)).astype(np.float32)
        assert stft.num_frames(n, frame, hop) == jstft.num_frames(n, frame, hop)
        frames = stft.frame_signal(_t(y), frame, hop)
        np.testing.assert_array_equal(
            frames.numpy(), np.asarray(jstft.frame_signal(jnp.asarray(y), frame, hop))
        )
        ola = stft.overlap_add(frames, hop)
        _close(ola, np.asarray(jstft.overlap_add(jnp.asarray(frames.numpy()), hop)))

    def test_dft_bases_equal_jax(self):
        for ours, theirs in ((stft.dft_matrices, jstft.dft_matrices),
                             (stft.idft_matrices, jstft.idft_matrices)):
            for a, b in zip(ours(64), theirs(64)):
                np.testing.assert_array_equal(a, b)


class TestGCC:
    def test_steering_planes_equal_jax(self):
        for a, b in zip(gcc.steering_cos_sin(16000.0, 513, 1.0, 128),
                        jgcc.steering_cos_sin(16000.0, 513, 1.0, 128)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(gcc.tdoa_grid(0.1, 64), jgcc.tdoa_grid(0.1, 64))

    @pytest.mark.parametrize("guard_zeros", [False, True])
    def test_coherence_and_angular_match_jax(self, stereo_signal, guard_zeros):
        mix, sr = stereo_signal
        w = hann_symmetric(1024)
        spec = np.array(jstft.stft(jnp.asarray(mix), w, 128, conjugate=True))
        spec[:, 5, 7] = 0.0  # one silent bin: NaN unguarded, 0 guarded
        want = np.asarray(jgcc.coherence(jnp.asarray(spec), guard_zeros=guard_zeros))
        got = gcc.coherence(_t(spec), guard_zeros=guard_zeros)
        _close(got, want)
        cos_m, sin_m = jgcc.steering_cos_sin(float(sr), 513, 1.0, 128)
        st = from_numpy_state({"cos": cos_m, "sin": sin_m})
        ok = np.isfinite(want).all(axis=-1)
        want_ang = np.asarray(jgcc.angular_spectrogram(jnp.asarray(want[ok]), cos_m, sin_m))
        got_ang = gcc.angular_spectrogram(got[_t(ok)], st["cos"], st["sin"])
        # a 513-term fp32 sum of unit-magnitude terms: 1e-5 of its scale
        _close(got_ang, want_ang, atol=ATOL * np.abs(want_ang).max())
        _close(gcc.mean_angular_spectrum(got_ang),
               np.asarray(jgcc.mean_angular_spectrum(jnp.asarray(want_ang))),
               atol=ATOL * np.abs(want_ang).max())

    def test_angular_matches_oracle(self, stereo_signal):
        mix, sr = stereo_signal
        x = oracle.mixture_spectrogram_ref(mix, 1024, 128)  # (2, F, T)
        coh = oracle.coherence_ref(x)
        freqs = np.linspace(0, sr / 2.0, 513)
        ref = oracle.angular_spectrogram_ref(coh, freqs, 1.0, 128)  # (D, T)
        cos_m, sin_m = gcc.steering_cos_sin(float(sr), 513, 1.0, 128)
        got = gcc.angular_spectrogram(_t(coh.T.astype(np.complex64)), cos_m, sin_m)
        np.testing.assert_allclose(got.numpy().T, ref, atol=1e-3 * np.abs(ref).max())


class TestLocalize:
    # equal heights at 3/7 and at 11/15, and a spectrum with one peak only
    SPECTRA = [
        np.array([0, 2, 0, 5, 1, 0, 2, 5, 0, 1, 0, 4, 0, 0, 0, 4, 0], np.float32),
        np.array([0, 1, 2, 3, 4, 3, 2, 1, 0], np.float32),
        np.array([1, 1, 1, 1, 1], np.float32),
    ]

    @pytest.mark.parametrize("k", [1, 2, 3, 4])
    def test_top_k_peaks_ties_and_shortfall_equal_jax(self, k):
        for a in self.SPECTRA:
            want = np.asarray(jloc.top_k_peaks(jnp.asarray(a), k))
            got = localize.top_k_peaks(_t(a), k)
            np.testing.assert_array_equal(got.numpy(), want)
            assert int(localize.peak_count(_t(a))) == int(jloc.peak_count(jnp.asarray(a)))

    def test_batched_peaks_equal_jax(self, rng):
        a = rng.integers(0, 4, (6, 32)).astype(np.float32)  # many ties
        np.testing.assert_array_equal(
            localize.top_k_peaks(_t(a), 3).numpy(), np.asarray(jloc.top_k_peaks(jnp.asarray(a), 3))
        )
        np.testing.assert_array_equal(
            localize.local_maxima_mask(_t(a)).numpy(),
            np.asarray(jloc.local_maxima_mask(jnp.asarray(a))),
        )

    @pytest.mark.parametrize("num_sources", [None, 2, 3])
    def test_host_estimate_equals_jax(self, num_sources):
        a = self.SPECTRA[0]
        assert localize.estimate_target_tdoa_indexes(a, num_sources) == \
            jloc.estimate_target_tdoa_indexes(a, num_sources)

    def test_host_estimate_raises_on_shortfall(self):
        with pytest.raises(ValueError, match="peaks"):
            localize.estimate_target_tdoa_indexes(self.SPECTRA[1], 2)

    @pytest.mark.parametrize("max_sources", [2, 4, 6])
    def test_auto_count_on_a_real_spectrum_equals_jax_and_host(self, stereo_signal,
                                                              max_sources):
        """The device 2-means on a mixture's mean angular spectrum: JAX's
        targets and counts, and the host path's sources where it finds no
        more than ``max_sources`` (test_offline.py:281-305)."""
        mix, sr = stereo_signal
        spec = jstft.stft(jnp.asarray(mix), hann_symmetric(1024), 128, conjugate=True)
        ang = jgcc.angular_spectrogram(jgcc.coherence(spec),
                                       *jgcc.steering_cos_sin(float(sr), 513, 1.0, 128))
        mean_ang = np.asarray(jgcc.mean_angular_spectrum(ang))
        targets, counts = localize.auto_count_targets(_t(mean_ang), max_sources)
        want_t, want_c = jloc.auto_count_targets(jnp.asarray(mean_ang), max_sources)
        np.testing.assert_array_equal(targets.numpy(), np.asarray(want_t))
        assert targets.dtype == counts.dtype == torch.int32
        assert int(counts) == int(want_c)
        host = localize.estimate_target_tdoa_indexes(mean_ang, None)
        if len(host) <= max_sources:
            assert list(targets.numpy()[: int(counts)]) == host
        assert (targets.numpy()[int(counts):] == mean_ang.argmax()).all()  # pads: dominant

    @pytest.mark.parametrize("max_sources", [1, 2, 4])
    def test_auto_count_ties_peakless_rows_and_batch_equal_jax(self, rng, max_sources):
        """Equal peak heights, a row with one peak, a flat and a monotonic
        row (no peak: count 1 at the global argmax, the first maximum), two
        tall and three small peaks (count 2), and a batch of random rows
        full of ties (test_offline.py:307-326)."""
        tall = np.zeros(64, np.float32)
        for i, h in [(10, 5.0), (40, 4.0), (20, 0.2), (30, 0.25), (50, 0.15)]:
            tall[i] = h
        rows = [np.pad(a, (0, 64 - a.size)) for a in self.SPECTRA]
        rows += [tall, np.linspace(0, 1, 64, dtype=np.float32)]
        for a in [*rows, np.stack(rows), rng.integers(0, 4, (6, 32)).astype(np.float32)]:
            targets, counts = localize.auto_count_targets(_t(a), max_sources)
            want_t, want_c = jloc.auto_count_targets(jnp.asarray(a), max_sources)
            np.testing.assert_array_equal(targets.numpy(), np.asarray(want_t))
            np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c))
        targets, counts = localize.auto_count_targets(_t(np.stack(rows)), 4)
        assert list(counts.numpy()[-2:]) == [2, 1]  # two tall peaks; the ramp has none
        assert list(targets.numpy()[-2, :2]) == [10, 40] and targets[-1, 0] == 63

    @pytest.mark.parametrize("window", [1, 5, 20, 64])
    def test_sliding_argmax_tdoa_equals_jax(self, rng, window):
        """The windowed mean's argmax over a (2, 3, 20, 16) history, rows
        of ties included (the first maximum wins in both), and a window
        longer than the history (the whole history)."""
        hist = rng.standard_normal((2, 3, 20, 16)).astype(np.float32)
        hist[0, 0] = 1.0  # every TDOA ties
        hist[1, 2, :, 5] = hist[1, 2, :, 9] = 10.0  # two maxima
        got = localize.sliding_argmax_tdoa(_t(hist), window)
        want = np.asarray(jloc.sliding_argmax_tdoa(jnp.asarray(hist), window))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got[0, 0] == 0 and got[1, 2] == 5


class TestMinibatchNMF:
    @staticmethod
    def _problem(stereo_signal, k=16):
        """|X| of both channels as a batch of two (T, F) spectrograms, the
        seeded W0 and two H0s."""
        mix, _ = stereo_signal
        v = stft.stft(_t(mix), hann_symmetric(1024), 128).abs().numpy()  # (2, T, F)
        w0, h0 = nmf.nmf_init_numpy(513, k, v.shape[1])
        _, h1 = nmf.nmf_init_numpy(513, k, v.shape[1], seed_value=1)
        return v, w0, np.stack([h0, h1])

    def test_matches_jax(self, stereo_signal):
        """Ten iterations with the W statistics summed over batch and
        time: JAX's W and H at rtol 1e-5."""
        v, w0, h0 = self._problem(stereo_signal)
        w, h = nmf.kl_nmf_minibatch_w(_t(v), _t(w0), _t(h0), 10)
        jw, jh = jnmf.kl_nmf_minibatch_w(jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h0), 10)
        assert w.shape == (513, 16) and h.shape == h0.shape
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-7)

    def test_batch_of_one_is_kl_nmf(self, stereo_signal):
        """At batch 1 the shared W is ``kl_nmf``'s (tests/test_ops.py:73-80)."""
        v, w0, h0 = self._problem(stereo_signal)
        w_a, h_a = nmf.kl_nmf(_t(v[0]), _t(w0), _t(h0[0]), 10)
        w_b, h_b = nmf.kl_nmf_minibatch_w(_t(v[:1]), _t(w0), _t(h0[:1]), 10)
        np.testing.assert_allclose(w_a.numpy(), w_b.numpy(), rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(h_a.numpy(), h_b.numpy()[0], rtol=2e-4, atol=1e-5)


class TestMasks:
    def _problem(self, t=20, f=17, k=6, seed=0):
        rng = np.random.default_rng(seed)
        spec = (rng.standard_normal((2, t, f)) + 1j * rng.standard_normal((2, t, f))).astype(
            np.complex64)
        spec[0, 3, 5] = 0.0  # angle(0) == 0 → phase 1
        coh = (rng.standard_normal((t, f)) + 1j * rng.standard_normal((t, f))).astype(np.complex64)
        w = (rng.random((f, k)) + 0.05).astype(np.float32)
        h = (rng.random((2, t, k)) + 0.01).astype(np.float32)
        cos_m, sin_m = jgcc.steering_cos_sin(16000.0, f, 1.0, 12)
        return spec, coh, w, h, cos_m, sin_m, np.array([2, 5, 9], np.int32)

    def test_attribution_masks_reconstruction_match_jax(self):
        spec, coh, w, h, cos_m, sin_m, tg = self._problem()
        st = from_numpy_state({"cos": cos_m, "sin": sin_m, "w": w})
        scores_j = np.asarray(jmasks.target_attribution(jnp.asarray(coh), cos_m, sin_m, tg, w))
        scores = masks.target_attribution(_t(coh), st["cos"], st["sin"], _t(tg), st["w"])
        _close(scores, scores_j, atol=1e-5 * np.abs(scores_j).max())
        masks_j = np.asarray(jmasks.hard_coefficient_masks(jnp.asarray(scores_j)))
        np.testing.assert_array_equal(masks.hard_coefficient_masks(_t(scores_j)).numpy(), masks_j)
        est_j = np.asarray(jmasks.masked_reconstruction(
            jnp.asarray(masks_j), jnp.asarray(spec), jnp.asarray(w), jnp.asarray(h)))
        est = masks.masked_reconstruction(_t(masks_j), _t(spec), st["w"], _t(h))
        _close(est, est_j, atol=1e-5 * np.abs(est_j).max())

    def test_winner_planes_with_nan_equal_jax(self):
        spec, coh, w, h, cos_m, sin_m, tg = self._problem(seed=3)
        re, im = coh.real.copy()[None], coh.imag.copy()[None]
        re[0, 4, :] = np.nan  # a NaN frame: every target's score is NaN
        re[0, 9, 2] = np.nan
        tgb, wb = tg[None], w[None]
        want = np.asarray(jmasks.attribution_winner_planes(
            jnp.asarray(re), jnp.asarray(im), cos_m, sin_m, jnp.asarray(tgb), jnp.asarray(wb)))
        got = masks.attribution_winner_planes(_t(re), _t(im), cos_m, sin_m, _t(tgb), _t(wb))
        np.testing.assert_array_equal(got.numpy(), want)
        scores = np.full((3, 4, 5), np.nan, np.float32)
        scores[1, 0, :] = 1.0
        np.testing.assert_array_equal(
            masks.hard_coefficient_masks(_t(scores)).numpy(),
            np.asarray(jmasks.hard_coefficient_masks(jnp.asarray(scores))),
        )

    def test_winner_planes_batch_equals_each_alone_and_jax(self):
        """A batch of three utterances (own targets, own W) gives each
        utterance's winners bit for bit as a batch of one does, and JAX's
        batched winners."""
        rng = np.random.default_rng(11)
        b, t, f, k = 3, 20, 17, 6
        re, im = (rng.standard_normal((b, t, f)).astype(np.float32) for _ in range(2))
        w = (rng.random((b, f, k)) + 0.05).astype(np.float32)
        tg = np.array([[2, 5, 9], [1, 7, 11], [0, 3, 4]], np.int32)
        cos_m, sin_m = jgcc.steering_cos_sin(16000.0, f, 1.0, 12)
        got = masks.attribution_winner_planes(_t(re), _t(im), cos_m, sin_m, _t(tg), _t(w))
        for i in range(b):
            one = masks.attribution_winner_planes(_t(re[i:i + 1]), _t(im[i:i + 1]), cos_m, sin_m,
                                                  _t(tg[i:i + 1]), _t(w[i:i + 1]))
            np.testing.assert_array_equal(got[i:i + 1].numpy(), one.numpy())
        want = np.asarray(jmasks.attribution_winner_planes(
            jnp.asarray(re), jnp.asarray(im), cos_m, sin_m, jnp.asarray(tg), jnp.asarray(w)))
        np.testing.assert_array_equal(got.numpy(), want)


def test_wav_round_trip_and_naming_match_jax(tmp_path, rng):
    x = (rng.standard_normal((2, 800)) * 0.3).astype(np.float32)
    p = str(tmp_path / "a_mix.wav")
    wav.write_wav(x, p, 16000)
    got, sr = wav.read_wav(p)
    want, _ = jwav.read_wav(p)
    assert sr == 16000
    np.testing.assert_array_equal(got, want)
    for path in ("/d/x_mix.wav", "/data.v2/mix", "y.wav"):
        assert wav.default_output_prefix(path) == jwav.default_output_prefix(path)
    np.testing.assert_array_equal(wav.float_to_pcm(x), jwav.float_to_pcm(x))


class TestConvert:
    def test_rejects_wrong_dtype_and_shapes(self):
        with pytest.raises(TypeError, match="float32"):
            from_numpy_state({"w0": np.ones((3, 2))})
        with pytest.raises(ValueError, match="dictionary size"):
            from_numpy_state({"w0": np.ones((3, 2), np.float32), "h0": np.ones((4, 5), np.float32)})
        with pytest.raises(ValueError, match="frequency bins"):
            from_numpy_state({"w0": np.ones((3, 2), np.float32),
                              "window": np.ones(8, np.float32)})
        with pytest.raises(KeyError):
            from_numpy_state({"v": np.ones((3, 2), np.float32)})

    def test_carries_values_exactly(self):
        w = np.random.default_rng(0).random((5, 4)).astype(np.float32)
        out = from_numpy_state({"w": w, "window": hann_symmetric(8)})
        np.testing.assert_array_equal(out["w"].numpy(), w)
        assert out["window"].dtype == torch.float32
