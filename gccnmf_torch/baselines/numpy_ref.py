"""NumPy oracle: an independent re-derivation of the reference semantics
(counterpart of ``gccnmf_tpu/baselines/numpy_ref.py``; NumPy and SciPy
only, no torch).

A compact NumPy statement of the reference's math, quirks included: STFT
output conjugation, symmetric Hann, ISTFT center trim and the hop/window*2
gain, the seeded MT19937 NMF init. Tests and the benchmark use it as the
golden model for waveform parity.
"""

import numpy as np
from scipy.signal import argrelmax

SPEED_OF_SOUND = 340.29


def stft_ref(y, window_size, hop_size):
    """Reference STFT: left-aligned symmetric-Hann frames, conjugated rfft.

    Mirrors librosaSTFT.stft(center=False, window=numpy.hanning) as invoked
    by gccNMFFunctions.computeComplexMixtureSpectrogram. Returns (F, T).
    """
    w = np.hanning(window_size)
    t = 1 + (len(y) - window_size) // hop_size
    frames = np.stack([y[i * hop_size : i * hop_size + window_size] for i in range(t)], 1)
    return np.fft.rfft(w[:, None] * frames, axis=0).conj().astype(np.complex64)


def istft_ref(spec, window_size, hop_size):
    """Reference ISTFT: conjugate half-spectrum, irfft, symmetric-Hann
    synthesis window, overlap-add, then center trim of window_size//2 per
    side (librosaSTFT.istft default center=True as hit by the offline path).
    Returns float32 time series."""
    w = np.hanning(window_size)
    n_frames = spec.shape[1]
    y = np.zeros(window_size + hop_size * (n_frames - 1), np.float32)
    for i in range(n_frames):
        frame = np.fft.irfft(spec[:, i].conj(), n=window_size).real
        y[i * hop_size : i * hop_size + window_size] += (w * frame).astype(np.float32)
    half = window_size // 2
    return y[half:-half]


def mixture_spectrogram_ref(stereo, window_size, hop_size):
    return np.stack([stft_ref(np.ascontiguousarray(ch), window_size, hop_size) for ch in stereo])


def nmf_init_ref(num_freq, dictionary_size, num_time, epsilon=1e-16, seed_value=0):
    """Seeded W/H init identical to the reference (MT19937 via np.random)."""
    np.random.seed(seed_value)
    w0 = np.random.random((num_freq, dictionary_size)).astype(np.float32) + epsilon
    h0 = np.random.random((dictionary_size, num_time)).astype(np.float32) + epsilon
    return w0, h0


def kl_nmf_ref(v, dictionary_size, num_iterations, sparsity_alpha=0.0, epsilon=1e-16,
               seed_value=0):
    """Multiplicative-update KL NMF: H then W then unit-L2 atom renorm."""
    w, h = nmf_init_ref(v.shape[0], dictionary_size, v.shape[1], epsilon, seed_value)
    for _ in range(num_iterations):
        h *= (w.T @ (v / (w @ h))) / (w.sum(0)[:, None] + sparsity_alpha + epsilon)
        w *= ((v / (w @ h)) @ h.T) / h.sum(1)
        norms = np.sqrt((w ** 2).sum(0))
        w /= norms
        h *= norms[:, None]
    return w, h


def tdoas_ref(mic_separation, num_tdoas):
    m = mic_separation / SPEED_OF_SOUND
    return np.linspace(-m, m, num_tdoas)


def coherence_ref(x):
    """PHAT-weighted cross-spectral coherence (F, T) from (2, F, T)."""
    return x[0] * x[1].conj() / np.abs(x[0]) / np.abs(x[1])


def steering_ref(freqs, mic_separation, num_tdoas):
    return np.exp(np.outer(freqs, -2j * np.pi * tdoas_ref(mic_separation, num_tdoas)))


def angular_spectrogram_ref(coh, freqs, mic_separation, num_tdoas):
    """(num_tdoas, T): real part of steering-projected coherence, freq-summed."""
    e = steering_ref(freqs, mic_separation, num_tdoas)
    return np.einsum("ft,fd->dt", coh, e).real


def peaks_ref(mean_angular_spectrum, num_sources):
    idx = argrelmax(mean_angular_spectrum)[0]
    chosen = idx[np.argsort(mean_angular_spectrum[idx])[-num_sources:]]
    return sorted(chosen)


def target_gccnmf_ref(coh, freqs, mic_separation, num_tdoas, target_indexes, w):
    """(targets, atoms, T) attribution scores."""
    e = steering_ref(freqs, mic_separation, num_tdoas)
    out = []
    for ti in target_indexes:
        gcc = coh * e[:, ti][:, None]
        out.append(np.einsum("fk,ft->kt", w, gcc).real)
    return np.array(out, np.float32)


def coefficient_masks_ref(scores):
    """Hard per-(atom,frame) argmax over targets -> binary masks."""
    winner = np.nanargmax(scores, axis=0)
    masks = np.zeros_like(scores)
    for ti in range(scores.shape[0]):
        masks[ti][winner == ti] = 1
    return masks


def reconstruct_ref(masks, x, w, stereo_h, window_size, hop_size):
    """Masked W·H magnitudes with mixture phase, ISTFT'd, with the
    reference's hop/window*2 gain. Returns (targets, 2, n) float32."""
    gain = hop_size / float(window_size) * 2
    num_targets = masks.shape[0]
    outs = []
    for ti in range(num_targets):
        chans = []
        for ci in range(2):
            mag = w @ (stereo_h[ci] * masks[ti])
            spec = mag * np.exp(1j * np.angle(x[ci]))
            chans.append(istft_ref(spec.astype(np.complex64), window_size, hop_size))
        outs.append(chans)
    return np.array(outs) * gain


def separate_ref(stereo, sample_rate, window_size=1024, hop_size=128, num_tdoas=128,
                 mic_separation=1.0, num_sources=3, dictionary_size=128,
                 num_iterations=100):
    """Full offline separation pipeline. Returns dict of all intermediates."""
    x = mixture_spectrogram_ref(stereo, window_size, hop_size)
    num_freq = x.shape[1]
    freqs = np.linspace(0, sample_rate / 2.0, num_freq)
    v = np.concatenate(np.abs(x), axis=-1)
    w, h = kl_nmf_ref(v, dictionary_size, num_iterations)
    stereo_h = np.array(np.hsplit(h, 2))
    coh = coherence_ref(x)
    ang = angular_spectrogram_ref(coh, freqs, mic_separation, num_tdoas)
    targets = peaks_ref(ang.mean(-1), num_sources)
    scores = target_gccnmf_ref(coh, freqs, mic_separation, num_tdoas, targets, w)
    masks = coefficient_masks_ref(scores)
    est = reconstruct_ref(masks, x, w, stereo_h, window_size, hop_size)
    return dict(x=x, v=v, w=w, h=h, stereo_h=stereo_h, coherence=coh, angular=ang,
                targets=targets, scores=scores, masks=masks, estimates=est)


def rt_stream_ref(stereo, w, sample_rate, window_size, hop_size, block_size,
                  num_tdoas, mic_separation, target_tdoa_index, epsilon_, beta,
                  noise_floor):
    """Reference streaming loop: 8-block input/output rings, per-block
    windowed processing via rt_block_ref, overlap-add, fixed 2-block-delay
    emission (outputBuffer[-3B:-2B]), localization disabled.
    Returns (C, num_blocks*block_size) float32."""
    num_freq = window_size // 2 + 1
    freqs = np.linspace(0, sample_rate / 2.0, num_freq)
    m = block_size // hop_size
    buf_len = 8 * block_size
    in_buf = np.zeros((2, buf_len), np.float32)
    out_buf = np.zeros((2, buf_len), np.float32)
    nb = stereo.shape[-1] // block_size
    emitted = []
    win_starts = np.arange(
        buf_len - window_size - (m - 1) * hop_size, buf_len - window_size + 1, hop_size
    )
    for t in range(nb):
        in_buf[:, :-block_size] = in_buf[:, block_size:]
        in_buf[:, -block_size:] = stereo[:, t * block_size : (t + 1) * block_size]
        out_buf[:, :-block_size] = out_buf[:, block_size:]
        out_buf[:, -block_size:] = 0
        windowed = np.stack(
            [in_buf[:, s : s + window_size] for s in win_starts], axis=-1
        )  # (2, window, m)
        processed, *_ = rt_block_ref(
            windowed, w, window_size, target_tdoa_index, epsilon_, beta,
            noise_floor, freqs, mic_separation, num_tdoas,
        )
        for i, s in enumerate(win_starts):
            out_buf[:, s : s + window_size] += processed[..., i]
        emitted.append(out_buf[:, -3 * block_size : -2 * block_size].copy())
    return np.concatenate(emitted, axis=-1)


def rt_block_ref(windowed_samples, w, window_size, target_tdoa_index, epsilon_, beta,
                 noise_floor, freqs, mic_separation, num_tdoas):
    """Reference streaming block: sqrt-Hamming windows, soft generalized-
    Gaussian mask over per-(frame,atom) argmax TDOA, Wiener TF mask.

    windowed_samples: (2, window_size, windows_per_block) raw (unwindowed).
    Returns (out_frames, tf_mask, h_mask, real_gcc).
    """
    win = np.sqrt(np.hamming(window_size).astype(np.float32))[:, None]
    x = np.fft.rfft(windowed_samples * win, axis=1).astype(np.complex64)
    coh = x[0] * x[1].conj() / np.abs(x[0]) / np.abs(x[1])
    e = steering_ref(freqs, mic_separation, num_tdoas).astype(np.complex64)
    real_gcc = (coh[:, :, None] * e[:, None, :]).real  # (F, T, D)
    gcc_nmf = np.einsum("ftd,fk->dtk", real_gcc, w)  # (D, T, K)
    dist = np.abs(np.argmax(gcc_nmf, axis=0).T - target_tdoa_index)  # (K, T)
    h_mask = np.exp(-((dist / epsilon_) ** beta)) / (1 + noise_floor) + noise_floor
    rec = w @ h_mask  # (F, T)
    tf_mask = rec / w.sum(-1)[:, None]
    out = np.fft.irfft(tf_mask * x, axis=1) * win
    return out, tf_mask, h_mask, real_gcc
